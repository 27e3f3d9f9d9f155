"""Dry run of every (arch x shape x mesh) cell on the production meshes.

The port of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for a 256- or 512-chip mesh of forced host devices.
Here nothing is compiled and nothing is allocated: the cell's per-device
program is traced with ``make_fx`` over fake tensors, as rank 0 of a fake
process group of the mesh's size (``FakeStore``, backend ``"fake"``, one
process), and walked (:mod:`repro_torch.core.hlo_cost`).  It needs no card.

The per-device program is the port's own step as a rank of the mesh would
run it, every kernel through its marker op (:func:`repro_torch.kernels.ops.
traced_kernels`):

* train: the sharded ``make_train_step(grad_shardings=...)`` on this
  rank's pieces of the parameters and the optimizer state
  (``param_shardings`` / ``opt_state_shardings``), the whole batch given:
  it gathers each parameter over the data axes, computes its data rows
  with this rank's share of the ``model`` axis (heads, MLP columns,
  experts, Mamba channels, vocabulary rows), and reduce-scatters each
  microbatch's gradients into float32 sums of its pieces;
* prefill and decode: the sharded ``make_prefill_step`` /
  ``make_decode_step(shardings=...)``, the counterpart of the reference's
  serving steps jitted with the parameter and cache shardings, on this
  rank's pieces of the parameters and of the cache (``cache_shardings``)
  and the whole batch: the same split of the compute, the cache pieces
  read where they lie (a cache the model reads whole, a KV cache whose
  heads do not split or a sequence split over the data axes, gathered one
  layer at a time).

A parameter whose ``model`` piece does not fall on whole heads, experts or
channels is gathered over ``model`` and computed replicated: correct, only
redundant.  Each record lists these leaves (``model_gathered``).

The fake tensors are on the ``meta`` device: a CPU-only PyTorch cannot
index a fake CUDA tensor (its device guard needs CUDA), and every branch of
the port that the step takes on the card (each ``device.type != "cpu"``
test) goes the same way on ``meta``.

A deep model is traced at two cut depths, one and two layer periods (plus
the remainder of its depth), and its costs extrapolated to its depth: the
periods are identical, so every total is affine in the number of periods
(``tests/test_torch_roofline.py`` holds the extrapolation equal to the full
trace), except the peak of live bytes, which it bounds from below (see
:func:`walk`).

Each record holds, under the reference's keys:

* ``resident_bytes_per_device`` -- the bytes of this device's pieces of
  the step's arguments under the production shardings, equal to the
  reference's ``_tree_bytes_per_device`` bit for bit;
* ``memory_analysis`` -- :func:`repro_torch.core.hlo_cost.live_bytes` of
  the traced program (the arguments' and outputs' bytes, and the peak of
  live bytes by last use; a lower bound when extrapolated), the
  counterpart of XLA's ``memory_analysis()``;
* ``roofline`` -- :func:`repro_torch.core.roofline.roofline_from_cost`
  against the H100's data-sheet peaks;
* ``params`` -- ``cfg.param_counts()``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3 --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --jobs 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import torch
from torch.utils import _pytree as pytree

from ..configs import SHAPES, all_cells, resolve, run_config, supported_shapes
from ..core import hlo_cost as HC
from ..core import roofline as RL
from ..kernels import ops
from ..models import model as M
from ..optim import AdamWConfig, init_opt_state
from ..parallel import sharding as SH
from ..runtime import steps as ST
from . import input_specs as IS
from .mesh import production_mesh_shape

OUT_DEFAULT = "chiprun_out/dryrun"
FAKE_DEVICE = "meta"
INT_BYTES = 4  # the reference's cache length is an int32 scalar


# ---------------------------------------------------------------------------
# Resident bytes: this device's pieces of the step's arguments
# ---------------------------------------------------------------------------


def _tree_bytes_per_device(tree, shardings) -> float:
    """Bytes of one device's pieces of ``tree`` under ``shardings``: each
    leaf's shape divided by its shard counts; an int leaf (the cache's
    length) is the reference's int32 scalar."""
    total = 0
    for leaf, sh in zip(pytree.tree_leaves(tree), pytree.tree_leaves(shardings)):
        if not isinstance(leaf, torch.Tensor):
            total += INT_BYTES
            continue
        counts = SH.shard_counts(sh, leaf.dim())
        total += math.prod(n // c for n, c in zip(leaf.shape, counts)) * leaf.element_size()
    return float(total)


def abstract_opt_state(aparams, rc):
    """The optimizer state ``init_opt_state`` makes for ``aparams`` (meta)."""
    return init_opt_state(aparams, AdamWConfig(state_dtype=rc.opt_state_dtype))


def shardings(cfg, shape, rc, mesh) -> dict:
    """The abstract arguments of the cell's step and their shardings on
    ``mesh`` (a ``MeshShape`` or a ``DeviceMesh``): {name: (tree,
    shardings)} for params, opt / cache, batch / tokens."""
    specs = IS.input_specs(cfg, shape, ring=rc.local_ring_cache)
    aparams = M.abstract_params(cfg)
    pshard = SH.param_shardings(mesh, aparams, fsdp=rc.fsdp)
    out = {"params": (aparams, pshard)}
    if shape.kind == "train":
        aopt = abstract_opt_state(aparams, rc)
        out["opt"] = (aopt, SH.opt_state_shardings(mesh, aopt, pshard))
        out["batch"] = (specs["batch"], SH.batch_shardings(mesh, specs["batch"]))
    elif shape.kind == "prefill":
        out["cache"] = (specs["cache"], SH.cache_shardings(mesh, specs["cache"],
                                                           seq_shard=rc.seq_shard))
        out["batch"] = (specs["batch"], SH.batch_shardings(mesh, specs["batch"]))
    else:
        out["cache"] = (specs["cache"], SH.cache_shardings(mesh, specs["cache"],
                                                           seq_shard=rc.seq_shard))
    return out


def resident_bytes_per_device(cfg, shape, rc, mesh) -> dict:
    """{params, opt | cache, batch}: the bytes of one device's pieces, as
    the reference's dry run reports them (its decode cells count the cache
    and not the tokens)."""
    return {k: _tree_bytes_per_device(tree, sh)
            for k, (tree, sh) in shardings(cfg, shape, rc, mesh).items()}


# ---------------------------------------------------------------------------
# The per-device program, traced over fake tensors
# ---------------------------------------------------------------------------


def fake_world(n: int):
    """This process as rank 0 of a fake process group of ``n`` ranks (the
    group of an earlier call is replaced when its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def device_mesh(mesh_kind: str):
    """The production mesh as a ``DeviceMesh`` over a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh

    ms = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    fake_world(ms.size)
    mesh = init_device_mesh("cpu", ms.sizes, mesh_dim_names=ms.axis_names)
    SH.rank_grid(mesh)  # read before any trace
    return mesh


def _fake_like(tree, mode, shape_of=lambda t: t.shape):
    """Fake ``FAKE_DEVICE`` tensors shaped like the meta leaves of ``tree``
    (``shape_of(leaf)`` gives each one's shape); other leaves as they are."""
    with mode:
        return pytree.tree_map_only(
            torch.Tensor,
            lambda t: torch.empty(tuple(shape_of(t)), dtype=t.dtype, device=FAKE_DEVICE),
            tree)


def _pieces(tree, shards, mode):
    """Fake tensors of this rank's pieces of ``tree`` under ``shards``."""
    leaves, spec = pytree.tree_flatten(tree)
    sh = pytree.tree_leaves(shards)
    return pytree.tree_unflatten(
        [_fake_like(x, mode, lambda t, s=s: [n // c for n, c in
                                            zip(t.shape, SH.shard_counts(s, t.dim()))])
         for x, s in zip(leaves, sh)], spec)


def program_at(cfg, shape, rc, mesh, mode):
    """(fn, args): the cell's per-device program at ``cfg``'s depth and its
    fake arguments."""
    args = shardings(cfg, shape, rc, mesh)
    aparams, pshard = args["params"]
    params = _pieces(aparams, pshard, mode)
    if shape.kind == "train":
        step = ST.make_train_step(
            cfg, rc, grad_shardings=pshard,
            kernels=ops.traced_kernels(ops.train_kernels(rc.mamba_chunk)))
        return step, (params, _pieces(*args["opt"], mode), _fake_like(args["batch"][0], mode))
    acache, cshard = args["cache"]
    cache = _pieces(_with_len(acache, shape.seq_len - 1 if shape.kind == "decode" else 0),
                    cshard, mode)
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, rc, kernels=ops.traced_kernels(),
                                    shardings=(pshard, cshard))
        return step, (params, cache, _fake_like(args["batch"][0], mode))
    step = ST.make_decode_step(cfg, rc, kernels=ops.traced_kernels(),
                               shardings=(pshard, cshard))
    return step, (params, cache, _fake_like(IS.decode_token_specs(shape), mode))


def one_device_program(cfg, shape, rc, mode, *, cache_len: int | None = None):
    """(fn, args): the port's step on one device at ``shape``'s batch and
    sequence, as the card runs it with no mesh, every kernel through its
    marker: training ``make_train_step`` (the training kernel set);
    prefill ``make_prefill_step`` into a cache of ``cache_len`` entries
    (default the sequence); decode ``make_decode_step`` over a cache
    filled to ``seq_len - 1``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        aparams = M.abstract_params(cfg)
        params = _fake_like(aparams, mode)
        opt = _fake_like(abstract_opt_state(aparams, rc), mode)
        batch = _fake_like(IS.train_batch_specs(cfg, shape), mode)
        step = ST.make_train_step(
            cfg, rc, kernels=ops.traced_kernels(ops.train_kernels(rc.mamba_chunk)))
        return step, (params, opt, batch)
    params = _fake_like(M.abstract_params(cfg), mode)
    cache = M.abstract_cache(cfg, B, S if cache_len is None else cache_len,
                             ring=rc.local_ring_cache)
    cache = _fake_like(_with_len(cache, S - 1 if shape.kind == "decode" else 0), mode)
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, rc, kernels=ops.traced_kernels())
        return step, (params, cache, _fake_like(IS.prefill_batch_specs(cfg, shape), mode))
    step = ST.make_decode_step(cfg, rc, kernels=ops.traced_kernels())
    return step, (params, cache, _fake_like(IS.decode_token_specs(shape), mode))


def one_device_roofline(cfg, shape, rc, *, cache_len: int | None = None):
    """(Roofline, :func:`walk`'s result) of :func:`one_device_program`
    against the H100's peaks, its model FLOPs the reference's
    ``model_flops`` of ``shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    walked = walk(cfg, lambda c: one_device_program(c, shape, rc, mode,
                                                    cache_len=cache_len))
    rl = RL.roofline_from_cost(
        walked["cost"], model_flops_total=RL.model_flops(cfg, shape, kind=shape.kind),
        n_chips=1)
    return rl, walked


def _with_len(tree, n: int):
    """``tree`` with every ``"len"`` entry set to ``n``."""
    if isinstance(tree, dict):
        return {k: (n if k == "len" else _with_len(v, n)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_len(v, n) for v in tree]
    return tree


def depth_cut(cfg, periods: int):
    """``cfg`` cut to ``periods`` layer periods plus the remainder of its
    depth (an encoder-decoder: ``periods`` encoder and decoder layers)."""
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, n_layers=periods, n_enc_layers=periods)
    p = cfg.pattern_period
    return dataclasses.replace(cfg, n_layers=cfg.n_layers % p + periods * p)


def _periods(cfg) -> int:
    if cfg.is_encoder_decoder:
        if cfg.n_enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.n_enc_layers} encoder and "
                             f"{cfg.n_layers} decoder layers cannot be cut together")
        return cfg.n_layers
    return cfg.n_layers // cfg.pattern_period


def _affine(a, b, m: int):
    """a + m (b - a), field by field (Cost fields and live-bytes dicts)."""
    return a + m * (b - a)


def walk(cfg, build, *, full_depth: bool = False) -> dict:
    """Trace and walk the program ``build(cfg_at_depth) -> (fn, args)`` at
    ``cfg``'s depth, or at one and two layer periods extrapolated to it.
    Returns {"cost": Cost, "live": live_bytes dict, "depths": [...],
    "nodes": [...], "seconds": {"trace", "walk"}}.

    The costs and the arguments' and outputs' bytes are affine in the
    number of periods, so their extrapolation is exact.  The peak of live
    bytes is the largest of several such lines (the place in the step where
    it falls can move with depth), a convex function: the line through two
    depths, carried on, stays below it, so an extrapolated peak is a lower
    bound (``live["peak_is_lower_bound"]``)."""
    total = _periods(cfg)
    cuts = [total] if full_depth or total <= 2 else [1, 2]
    costs, lives, nodes, t_trace, t_walk = [], [], [], 0.0, 0.0
    for k in cuts:
        fn, args = build(depth_cut(cfg, k))
        t0 = time.perf_counter()
        gm = HC.trace(fn, *args)
        t1 = time.perf_counter()
        costs.append(HC.module_cost(gm))
        lives.append(HC.live_bytes(gm))
        nodes.append(len(gm.graph.nodes))
        t_trace += t1 - t0
        t_walk += time.perf_counter() - t1
        del gm, fn, args
    if len(cuts) == 1:
        cost, live = costs[0], lives[0]
    else:
        m = total - 1
        a, b = costs
        cost = HC.Cost(**{f.name: _affine(getattr(a, f.name), getattr(b, f.name), m)
                          for f in dataclasses.fields(HC.Cost) if f.name != "coll"})
        for key in set(a.coll) | set(b.coll):
            cost.coll[key] = _affine(a.coll.get(key, 0.0), b.coll.get(key, 0.0), m)
        live = {key: _affine(lives[0][key], lives[1][key], m) for key in lives[0]}
    live["peak_is_lower_bound"] = len(cuts) > 1
    return {"cost": cost, "live": live,
            "depths": [depth_cut(cfg, k).n_layers for k in cuts], "nodes": nodes,
            "seconds": {"trace": t_trace, "walk": t_walk}}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh_kind: str, rc_overrides: dict):
    """(cfg, shape, rc, mesh shape, resident bytes) of a cell."""
    cfg = resolve(arch)
    shape = SHAPES[shape_name]
    rc = run_config(cfg.name, shape_name, **rc_overrides)
    ms = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    return cfg, shape, rc, ms, resident_bytes_per_device(cfg, shape, rc, ms)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: pathlib.Path,
             rc_overrides: dict, tag: str = "") -> dict:
    """Trace, walk and record one cell; writes
    ``<arch>__<shape>__<mesh>[_tag].json`` under ``out_dir``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape, rc, ms, resident = build_cell(arch, shape_name, mesh_kind, rc_overrides)
    mesh = device_mesh(mesh_kind)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    walked = walk(cfg, lambda c: program_at(c, shape, rc, mesh, mode))
    rl = RL.roofline_from_cost(
        walked["cost"], model_flops_total=RL.model_flops(cfg, shape, kind=shape.kind),
        n_chips=ms.size)
    record = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_kind,
        "n_chips": ms.size,
        "tag": tag,
        "run_config": dataclasses.asdict(rc),
        "seconds": walked["seconds"],
        "memory_analysis": walked["live"],
        "resident_bytes_per_device": resident,
        "resident_total_gib": sum(resident.values()) / 2**30,
        "roofline": rl.row(),
        "params": cfg.param_counts(),
        "model_gathered": SH.model_gathered_paths(SH.param_shardings(
            mesh, M.abstract_params(cfg), fsdp=rc.fsdp), cfg),
        "trace": {"device": FAKE_DEVICE, "depths": walked["depths"],
                  "nodes": walked["nodes"], "n_layers": cfg.n_layers},
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    fname = out_dir / f"{cfg.name}__{shape.name}__{mesh_kind}{suffix}.json"
    fname.write_text(json.dumps(record, indent=1))
    sec = walked["seconds"]
    print(
        f"[dryrun] {cfg.name} {shape.name} {mesh_kind}{suffix}: "
        f"trace {sec['trace']:.1f}s (depths {walked['depths']} of {cfg.n_layers})  "
        f"resident {record['resident_total_gib']:.2f} GiB/dev  "
        f"bound={rl.bound}  step>={rl.step_seconds*1e3:.1f} ms  "
        f"mfu<={rl.mfu_bound*100:.1f}%  useful={rl.useful_flops_ratio:.4f}",
        flush=True,
    )
    print(f"  memory_analysis: {walked['live']}", flush=True)
    print(f"  gathered over model: {_gathered_summary(record['model_gathered'])}", flush=True)
    print(f"  cost: flops/dev={rl.flops:.3e} bytes/dev={rl.hbm_bytes:.3e} "
          f"coll/dev={rl.coll_bytes:.3e} {rl.row()['coll_breakdown']}", flush=True)
    return record


def _gathered_summary(paths: list[str]) -> dict:
    """{module/leaf: count} of the leaves gathered over ``model``."""
    out: dict = {}
    for p in paths:
        key = "/".join(p.split("/")[-2:])
        out[key] = out.get(key, 0) + 1
    return out


def sweep(cells, mesh_kinds, out_dir: pathlib.Path, jobs: int, force: bool):
    """Run cells in subprocesses (one fake process group each, ``jobs``
    wide); returns the failed cells."""
    work = []
    for arch, shape in cells:
        for mk in mesh_kinds:
            if not force and (out_dir / f"{arch}__{shape}__{mk}.json").exists():
                continue
            work.append((arch, shape, mk))
    print(f"[sweep] {len(work)} cells to run, jobs={jobs}", flush=True)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    procs: list = []
    failures = []
    idx = 0
    while idx < len(work) or procs:
        while idx < len(work) and len(procs) < jobs:
            arch, shape, mk = work[idx]
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mk, "--out", str(out_dir)]
            procs.append((subprocess.Popen(cmd, env=env), work[idx]))
            idx += 1
        time.sleep(0.5)
        still = []
        for p, cell in procs:
            if p.poll() is None:
                still.append((p, cell))
            elif p.returncode != 0:
                failures.append(cell)
                print(f"[sweep] FAILED {cell} rc={p.returncode}", flush=True)
        procs = still
    print(f"[sweep] done; {len(failures)} failures: {failures}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true", help="sweep all cells x meshes")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--tag", default="", help="suffix for perf-iteration records")
    # perf levers (hillclimb)
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--remat", choices=("none", "dots", "full"))
    ap.add_argument("--seq-shard", action="store_true", default=None)
    ap.add_argument("--opt-dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--attn-chunk-kv", type=int)
    ap.add_argument("--xent-chunk", type=int)
    ap.add_argument("--mamba-chunk", type=int)
    ap.add_argument("--flash-vjp", action="store_true", default=None)
    ap.add_argument("--bf16-tiles", action="store_true", default=None)
    ap.add_argument("--ring-cache", action="store_true", default=None)
    ap.add_argument("--shard-grads", action="store_true", default=None)
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false", default=None)
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    mapping = {
        "microbatches": args.microbatches,
        "remat": args.remat,
        "seq_shard": args.seq_shard,
        "opt_state_dtype": args.opt_dtype,
        "attn_chunk_kv": args.attn_chunk_kv,
        "xent_chunk": args.xent_chunk,
        "mamba_chunk": args.mamba_chunk,
        "flash_vjp": args.flash_vjp,
        "attn_bf16_tiles": args.bf16_tiles,
        "local_ring_cache": args.ring_cache,
        "shard_grads": args.shard_grads,
        "fsdp": args.fsdp,
    }
    rc_overrides = {k: v for k, v in mapping.items() if v is not None}

    if args.all:
        failures = sweep(all_cells(), ("single", "multi"), out_dir, args.jobs, args.force)
        sys.exit(1 if failures else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    if args.shape not in supported_shapes(resolve(args.arch).name):
        print(f"[dryrun] {args.arch} skips {args.shape} (configs.supported_shapes)")
        return
    run_cell(args.arch, args.shape, args.mesh, out_dir, rc_overrides, tag=args.tag)


if __name__ == "__main__":
    main()
