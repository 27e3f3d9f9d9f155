"""One gloo rank of the port's multi-rank CPU tests.

    python tests/torch_multirank.py WORK RANK WORLD

``tests/test_torch_multidevice.py`` starts WORLD of these (8) with
``PYTHONPATH=src``.  They join one process group through the file store
``WORK/store`` and run the port's sharded step, elastic resume, pipeline,
int8 all-reduce and compressed step on the inputs the test wrote into WORK
(``inputs.npz`` and the checkpoints ``portA`` / ``portB``).  Rank 0 writes
the results to ``WORK/port.npz``; the test holds them against the JAX
reference's.  Imports torch and the port only.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch import checkpoint as CKPT
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
from repro_torch.runtime.elastic import resume_on_mesh
from repro_torch.runtime.spmd_train import make_compressed_train_step
from repro_torch.runtime.steps import make_train_step

CKPT_WAIT_S = 240  # the reference's elastic checkpoint is written by another process


def cfg_of(vocab: int) -> ModelConfig:
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab_size=vocab, dtype="float32")


RC_STEP = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=1e-3, warmup_steps=1)
RC_COMPRESSED = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=2e-3,
                          warmup_steps=2)


def flat_keys(tree, prefix: str) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            out["/".join([prefix] + path)] = np.asarray(node.detach().cpu())

    walk(tree, [])
    return out


def load_params(work: Path, name: str, cfg) -> dict:
    tree, _ = CKPT.restore(work / name, 0, like={"params": M.abstract_params(cfg)})
    return CKPT.device_put_like(tree["params"], "cpu")


def gather_tree(tree, shardings):
    leaves, spec = pytree.tree_flatten(tree)
    shards = pytree.tree_leaves(shardings)
    return pytree.tree_unflatten([SH.gather(x, s) for x, s in zip(leaves, shards)], spec)


def case_sharded_step(work, inp, out):
    cfg = cfg_of(256)
    params = load_params(work, "portA", cfg)
    opt = init_opt_state(params, AdamWConfig())
    batch = {"tokens": inp["A_tokens"], "labels": inp["A_labels"]}
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    pshard = SH.param_shardings(mesh, M.abstract_params(cfg))
    oshard = SH.opt_state_shardings(mesh, opt, pshard)
    step = make_train_step(cfg, RC_STEP, grad_shardings=pshard)
    p2, o2, m2 = step(SH.place(params, pshard), SH.place(opt, oshard), batch)
    split = sum(x.numel() < y.numel() for x, y in
                zip(pytree.tree_leaves(p2), pytree.tree_leaves(params)))
    p2 = gather_tree(p2, pshard)
    m2nd = gather_tree(o2["m"], pshard)
    if dist.get_rank() == 0:
        p1, o1, m1 = make_train_step(cfg, RC_STEP)(params, opt, batch)
        out.update(flat_keys(p2, "step/sharded"))
        out.update(flat_keys(m2nd, "step/sharded_m"))
        out.update(flat_keys(p1, "step/single"))
        out.update(flat_keys(o1["m"], "step/single_m"))
        out["step/loss_sharded"] = np.float64(m2["loss"])
        out["step/loss_single"] = np.float64(m1["loss"])
        out["step/gnorm_sharded"] = np.float64(m2["grad_norm"])
        out["step/gnorm_single"] = np.float64(m1["grad_norm"])
        out["step/split_leaves_rank0"] = np.int64(split)


def case_elastic(work, inp, out):
    cfg = cfg_of(256)
    params = load_params(work, "portA", cfg)
    opt = init_opt_state(params, AdamWConfig())
    ckpt = work / "elastic"
    t0 = time.time()
    while CKPT.latest_step(ckpt) != 3:
        if time.time() - t0 > CKPT_WAIT_S:
            raise TimeoutError(f"the reference's checkpoint never appeared in {ckpt}")
        time.sleep(0.2)
    for shape, axes in [((2, 2, 2), ("pod", "data", "model")),
                        ((2, 4), ("data", "model"))]:
        mesh = make_mesh(shape, axes, device_type="cpu")
        p, o = resume_on_mesh(ckpt, 3, cfg, mesh)
        pshard = SH.param_shardings(mesh, M.abstract_params(cfg))
        oshard = SH.opt_state_shardings(mesh, opt, pshard)
        want = SH.place(params, pshard)
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(pytree.tree_leaves(p), pytree.tree_leaves(want)))
        wopt = SH.place(opt, oshard)
        odiff = max(float((a.float() - b.float()).abs().max()) for a, b in
                    zip(pytree.tree_leaves(o), pytree.tree_leaves(wopt)))
        split = sum(x.numel() < y.numel() for x, y in
                    zip(pytree.tree_leaves(p), pytree.tree_leaves(params)))
        t = torch.tensor([diff, odiff], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        key = "x".join(map(str, shape))
        out[f"elastic/{key}/params"] = t[0].numpy()
        out[f"elastic/{key}/opt"] = t[1].numpy()
        out[f"elastic/{key}/split_leaves_rank0"] = np.int64(split)


def case_pipeline(work, inp, out):
    ws, x = torch.from_numpy(inp["pp_ws"]), torch.from_numpy(inp["pp_x"])
    mesh = make_mesh((4, 2), ("stage", "data"), device_type="cpu")

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    y = pipeline_apply(stage_fn, ws, x, mesh=mesh)
    every = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(every, y)
    out["pp/out"] = y.numpy()
    out["pp/same_on_every_rank"] = np.bool_(all(bool((e == y).all()) for e in every))
    out["pp/bubble"] = np.float64(bubble_fraction(x.shape[0], 4))


def case_compressed_psum(work, inp, out, wire):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    group, _ = SH.axis_group(mesh, ("pod",))
    pod = SH.mesh_coordinate(mesh)["pod"]
    wire.clear()
    got, err = compressed_psum(torch.from_numpy(inp["cp_x"][pod]), group, mean=True)
    both = torch.stack([got, err])
    every = [torch.empty_like(both) for _ in range(dist.get_world_size())]
    dist.all_gather(every, both)
    rank_of_pod = [0, 4]  # the first rank of each pod, row-major
    out["cp/out"] = np.stack([every[r][0].numpy() for r in rank_of_pod])
    out["cp/err"] = np.stack([every[r][1].numpy() for r in rank_of_pod])
    out["cp/wire"] = np.array(wire)


def case_compressed_step(work, inp, out, wire):
    cfg = cfg_of(128)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    params = load_params(work, "portB", cfg)
    opt = init_opt_state(params, AdamWConfig())
    step, init_ef = make_compressed_train_step(cfg, RC_COMPRESSED, mesh)
    ef = init_ef(params)
    batch = {"tokens": inp["B_tokens"], "labels": inp["B_labels"]}
    losses = []
    wire.clear()
    for _ in range(8):
        params, opt, ef, m = step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    out["cs/losses"] = np.array(losses)
    out["cs/int8_payloads"] = np.int64(sum(w == "torch.int8" for w in wire))
    out["cs/leaves"] = np.int64(len(pytree.tree_leaves(params)))


def main(work: str, rank: int, world: int) -> None:
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=world)
    inp = dict(np.load(work / "inputs.npz"))
    wire = []
    plain = dist.all_reduce

    def recording_all_reduce(tensor, *args, **kwargs):
        wire.append(str(tensor.dtype))
        return plain(tensor, *args, **kwargs)

    out = {}
    case_sharded_step(work, inp, out)
    case_pipeline(work, inp, out)
    dist.all_reduce = recording_all_reduce
    try:
        case_compressed_psum(work, inp, out, wire)
        case_compressed_step(work, inp, out, wire)
    finally:
        dist.all_reduce = plain
    case_elastic(work, inp, out)
    if rank == 0:
        np.savez(work / "port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
