"""The port's sharded training path on several ranks, against the JAX
package, on the CPU.

It mirrors the five non-fleet cases of ``tests/test_multidevice.py``.  The
test writes one set of inputs (parameters drawn from a seeded generator,
numpy batches and arrays from a seeded ``default_rng``); then, at the same
time, a JAX subprocess (8 host devices) runs the reference on them and 8
gloo ranks of the port (``tests/torch_multirank.py``, one process each,
joined through a file store) run the port:

* the sharded step on a (2 data, 4 model) mesh: the loss and every
  parameter within 2e-4 of the reference's sharded step and of the port's
  single-device step (the reference's bound);
* ``resume_on_mesh`` of a checkpoint the reference saved, onto (2, 2, 2)
  and (2, 4): every piece exactly the saved one (difference 0.0);
* ``pipeline_apply``, 4 stages x 6 microbatches: within 1e-5 of the
  sequential result and of the reference's;
* ``compressed_psum`` over the pod axis: bit-equal to the reference's on the
  same per-rank inputs, its payload handed to ``all_reduce`` as int8;
* the compressed step on (2, 2, 2): the loss falls by more than 0.2 in 8
  steps with an int8 payload for every gradient leaf, and the first step's
  loss is within 1e-5 relative of the reference's;
* tensor and expert parallelism on (2, 4): each rank's attention sees
  H / 4 heads and its MLP d_ff / 4 columns; a 4-expert MoE (experts on
  ``model``), a 2-expert one (each expert's d_ff columns on ``model``) and
  a Mamba model (channels on ``model``) take two sharded
  steps within 2e-4 of the reference's sharded steps and of the port's
  single-device ones, and the MoE's load-balance term is the whole
  microbatch's (within 1e-6 of the reference's), where this rank's own
  rows give another; the sharded prefill and two decode steps (the dense,
  MoE and Mamba models) give the float32 logits of the reference's jitted
  sharded steps within 1e-5 x max |logit|, the cache kept as the pieces
  ``cache_shardings`` places;
* a one-rank mesh: the sharded step bit-equal to the single-device one;
* ``launch.train`` through the mesh: with ``--mesh`` on one rank the same
  losses as on one device, and under ``torchrun`` on two gloo ranks the
  same first loss and the last within 2e-4, each rank checkpointing its
  own pieces.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_multirank as MR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 300
STEP_TOL = 2e-4  # tests/test_multidevice.py's bound, loss and parameters
GRAD_TOL = 1e-5  # float32 gradients, relative L2 per leaf: sums in another order
AUX_TOL = 1e-6  # float32 statistics of 256 tokens, summed in another order
SERVE_TOL = 1e-5  # x max |logit| (and x max |entry| of a cache leaf), float32
PP_TOL = 1e-5
LOSS_REL_TOL = 1e-5

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.experimental, jax.numpy as jnp, numpy as np
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro import checkpoint as CKPT
    from repro.configs.base import ModelConfig, RunConfig
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.optim import AdamWConfig, init_opt_state
    from repro.parallel import sharding as SH
    from repro.parallel.compression import compressed_psum
    from repro.parallel.pipeline import pipeline_apply
    from repro.runtime.spmd_train import make_compressed_train_step
    from repro.runtime.steps import make_train_step

    work = sys.argv[1]
    inp = dict(np.load(f"{work}/inputs.npz"))

    def cfg_of(vocab):
        return ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=vocab,
                           dtype="float32")

    TP_CFGS = {k: ModelConfig(**{f: tuple(v) if isinstance(v, list) else v
                                 for f, v in kw.items()})
               for k, kw in json.load(open(f"{work}/tp_cfgs.json")).items()}

    def load(name, cfg):
        tree, _ = CKPT.restore(f"{work}/{name}", 0,
                               like={"params": M.abstract_params(cfg)})
        return jax.tree.map(jnp.asarray, tree["params"])

    def flat(tree, prefix):
        return {"/".join([prefix] + SH._path_names(p)): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    cfg = cfg_of(256)
    params = load("refA", cfg)
    opt = init_opt_state(params, AdamWConfig())
    CKPT.save(f"{work}/elastic", 3, {"params": params, "opt": opt})

    rc = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=1e-3,
                   warmup_steps=1)
    batch = {"tokens": jnp.asarray(inp["A_tokens"]),
             "labels": jnp.asarray(inp["A_labels"])}
    step = make_train_step(cfg, rc)
    p1, o1, m1 = jax.jit(step)(params, opt, batch)
    mesh = make_mesh((2, 4), ("data", "model"))
    pshard = SH.param_shardings(mesh, jax.eval_shape(lambda: params))
    bshard = SH.batch_shardings(mesh, jax.eval_shape(lambda: batch))
    oshard = SH.opt_state_shardings(mesh, jax.eval_shape(lambda: opt), pshard)
    with SH.use_mesh(mesh):
        p2, o2, m2 = jax.jit(step, in_shardings=(pshard, oshard, bshard))(
            jax.device_put(params, pshard), jax.device_put(opt, oshard),
            jax.device_put(batch, bshard))
    out.update(flat(p2, "step/sharded"))
    out.update(flat(p1, "step/single"))
    out["step/loss_sharded"] = np.float64(m2["loss"])
    out["step/loss_single"] = np.float64(m1["loss"])

    mesh = make_mesh((4,), ("stage",))
    ws, x = jnp.asarray(inp["pp_ws"]), jnp.asarray(inp["pp_x"])
    with SH.use_mesh(mesh):
        out["pp/out"] = np.asarray(
            pipeline_apply(lambda w, h: jnp.tanh(h @ w), ws, x, mesh=mesh))

    mesh = make_mesh((2,), ("pod",))

    @partial(SH.shard_map_unchecked, mesh=mesh, in_specs=P("pod"),
             out_specs=P("pod"))
    def sync(v):
        got, err = compressed_psum(v[0], "pod", mean=True)
        return jnp.stack([got, err])[None]

    with SH.use_mesh(mesh):
        both = np.asarray(sync(jnp.asarray(inp["cp_x"])))
    out["cp/out"], out["cp/err"] = both[:, 0], both[:, 1]

    cfg = cfg_of(128)
    rc = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=2e-3,
                   warmup_steps=2)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    params = load("refB", cfg)
    opt = init_opt_state(params, AdamWConfig())
    cstep, init_ef = make_compressed_train_step(cfg, rc, mesh)
    ef = init_ef(params)
    batch = {"tokens": jnp.asarray(inp["B_tokens"]),
             "labels": jnp.asarray(inp["B_labels"])}
    losses = []
    with SH.use_mesh(mesh):
        jstep = jax.jit(cstep)
        for _ in range(8):
            params, opt, ef, m = jstep(params, opt, ef, batch)
            losses.append(float(m["loss"]))
    out["cs/losses"] = np.array(losses)

    # tensor and expert parallelism: the MoE and Mamba steps on (2, 4), two
    # steps each, and the whole microbatch's load-balance term
    rc = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=1e-3,
                   warmup_steps=1, mamba_chunk=8)
    mesh = make_mesh((2, 4), ("data", "model"))
    for tag, name in (("moe", "refC"), ("ssm", "refD"), ("moe_ff", "refE")):
        cfg = TP_CFGS[tag]
        params = load(name, cfg)
        opt = init_opt_state(params, AdamWConfig())
        batch = {"tokens": jnp.asarray(inp[f"{tag}_tokens"]),
                 "labels": jnp.asarray(inp[f"{tag}_labels"])}
        out[f"{tag}/aux"] = np.float64(M.loss_fn(params, cfg, rc, batch)[1]["aux"])
        pod0 = {k: v[:4] for k, v in batch.items()}  # pod 0's rows on (2, 2, 2)
        out[f"{tag}/aux_pod0"] = np.float64(M.loss_fn(params, cfg, rc, pod0)[1]["aux"])
        pshard = SH.param_shardings(mesh, jax.eval_shape(lambda: params))
        bshard = SH.batch_shardings(mesh, jax.eval_shape(lambda: batch))
        oshard = SH.opt_state_shardings(mesh, jax.eval_shape(lambda: opt), pshard)
        with SH.use_mesh(mesh):
            jstep = jax.jit(make_train_step(cfg, rc), in_shardings=(pshard, oshard, bshard))
            p, o = jax.device_put(params, pshard), jax.device_put(opt, oshard)
            losses = []
            for _ in range(2):
                p, o, m = jstep(p, o, jax.device_put(batch, bshard))
                losses.append(float(m["loss"]))
        out.update(flat(p, f"{tag}/sharded"))
        out[f"{tag}/losses"] = np.array(losses)

    # the jitted sharded prefill and decode, (2, 4)
    from repro.runtime.steps import make_decode_step, make_prefill_step
    for tag, name in (("A", "refA"), ("moe", "refC"), ("ssm", "refD")):
        cfg = TP_CFGS[tag]
        params = load(name, cfg)
        cache = M.init_cache(cfg, 8, 20)
        pshard = SH.param_shardings(mesh, jax.eval_shape(lambda: params))
        cshard = SH.cache_shardings(mesh, jax.eval_shape(lambda: cache))
        batch = {"tokens": jnp.asarray(inp["serve_prompt"])}
        bshard = SH.batch_shardings(mesh, jax.eval_shape(lambda: batch))
        tshard = SH.batch_shardings(mesh, jax.eval_shape(
            lambda: jnp.asarray(inp["serve_next"][0])))
        with SH.use_mesh(mesh):
            pre = jax.jit(make_prefill_step(cfg, rc), in_shardings=(pshard, cshard, bshard),
                          out_shardings=(None, cshard))
            dec = jax.jit(make_decode_step(cfg, rc), in_shardings=(pshard, cshard, tshard),
                          out_shardings=(None, cshard))
            p = jax.device_put(params, pshard)
            logits, cache = pre(p, jax.device_put(cache, cshard), batch)
            steps = [np.asarray(logits)]
            for t in inp["serve_next"]:
                logits, cache = dec(p, cache, jnp.asarray(t))
                steps.append(np.asarray(logits))
        out[f"serve/{tag}/logits"] = np.stack(steps)
        out.update({k: v for k, v in flat(cache, f"serve/{tag}/cache").items()
                    if not k.endswith("/len")})
    np.savez(f"{work}/reference.npz", **out)
""")


def _cfg(vocab):
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab_size=vocab, dtype="float32")


def _stacked(params):
    """The port's per-layer parameters in the reference's layout (each
    segment's layers stacked on a leading axis), as numpy."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([n.numpy() for n in nodes])

    return {k: ([stack(seg) for seg in v] if k == "segments" else v.numpy())
            for k, v in params.items()}


def _write_inputs(work: Path) -> dict:
    rng = np.random.default_rng(0)
    cfgs = MR.tp_cfgs()
    (work / "tp_cfgs.json").write_text(json.dumps(MR.TP_CFG_FIELDS))
    for name, cfg, seed in (("A", _cfg(256), 0), ("B", _cfg(128), 1), ("C", cfgs["moe"], 2),
                            ("D", cfgs["ssm"], 3), ("E", cfgs["moe_ff"], 4)):
        gen = torch.Generator().manual_seed(seed)
        params = M.init_params(cfg, generator=gen, device="cpu")
        CKPT.save(work / f"port{name}", 0, {"params": params})
        CKPT.save(work / f"ref{name}", 0, {"params": _stacked(params)})
    inp = {
        "A_tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "A_labels": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "B_tokens": rng.integers(0, 128, (8, 32), dtype=np.int32),
        "B_labels": rng.integers(0, 128, (8, 32), dtype=np.int32),
        "pp_ws": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
        "pp_x": rng.standard_normal((6, 8, 16)).astype(np.float32),
        "cp_x": (rng.standard_normal((2, 1024)) * 3.0).astype(np.float32),
        "moe_tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "moe_labels": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "ssm_tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "ssm_labels": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "moe_ff_tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "moe_ff_labels": rng.integers(0, 256, (8, 32), dtype=np.int32),
        "serve_prompt": rng.integers(0, 256, (8, 16), dtype=np.int32),
        "serve_next": rng.integers(0, 256, (2, 8, 1), dtype=np.int32),
    }
    np.savez(work / "inputs.npz", **inp)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the port's results, the reference's results), from one
    JAX subprocess and 8 port ranks running at the same time."""
    work = tmp_path_factory.mktemp("multirank")
    inp = _write_inputs(work)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    logs = [open(work / f"log{i}.txt", "w") for i in range(WORLD + 1)]
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(work)], cwd=ROOT,
                              env=env, stdout=logs[0], stderr=subprocess.STDOUT)]
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_multirank.py"),
                                str(work), str(r), str(WORLD)], cwd=ROOT, env=env,
                               stdout=logs[r + 1], stderr=subprocess.STDOUT)
              for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
        for f in logs:
            f.close()
    for i, rc in enumerate(rcs):
        who = "the JAX reference" if i == 0 else f"port rank {i - 1}"
        assert rc == 0, f"{who} failed:\n{(work / f'log{i}.txt').read_text()[-3000:]}"
    return (inp, dict(np.load(work / "port.npz")), dict(np.load(work / "reference.npz")))


def _port_to_ref_key(key: str) -> tuple[str, int | None]:
    """A port parameter key (one entry per layer) as the reference's key and
    the layer's index on its stacking axis."""
    parts = key.split("/")
    if "segments" in parts:
        i = parts.index("segments")
        return "/".join(parts[:i + 2] + parts[i + 3:]), int(parts[i + 2])
    return key, None


def _params_close(port: dict, ref: dict, prefix: str, ref_prefix: str, tol: float) -> float:
    worst, seen = 0.0, 0
    for key, got in port.items():
        if not key.startswith(prefix + "/"):
            continue
        rkey, layer = _port_to_ref_key(ref_prefix + key[len(prefix):])
        want = ref[rkey] if layer is None else ref[rkey][layer]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        worst = max(worst, float(np.abs(got.astype(np.float64) - want).max()))
        seen += 1
    assert seen, prefix
    assert worst < tol, f"{prefix}: max |diff| {worst} >= {tol}"
    return worst


def test_sharded_train_step_matches_the_reference_and_single_device(runs):
    _inp, port, ref = runs
    assert port["step/split_leaves_rank0"] > 0  # rank 0 holds pieces, not copies
    loss = float(port["step/loss_sharded"])
    assert abs(loss - float(ref["step/loss_sharded"])) < STEP_TOL
    assert abs(loss - float(port["step/loss_single"])) < STEP_TOL
    assert float(port["step/gnorm_sharded"]) == pytest.approx(
        float(port["step/gnorm_single"]), rel=1e-5)
    _params_close(port, ref, "step/sharded", "step/sharded", STEP_TOL)
    single = {k.replace("step/single", "step/sharded", 1): v for k, v in port.items()
              if k.startswith("step/single/")}
    sharded = {k: v for k, v in port.items() if k.startswith("step/sharded/")}
    for k, v in sharded.items():
        assert np.abs(v - single[k]).max() < STEP_TOL, k
    for k, v in port.items():
        if k.startswith("step/sharded_m/"):
            want = port[k.replace("step/sharded_m", "step/single_m", 1)]
            assert np.abs(v - want).max() < STEP_TOL, k


def test_each_rank_computes_its_share_of_the_heads_and_columns(runs):
    _inp, port, _ref = runs
    cfg = _cfg(256)
    assert list(port["split/heads"]) == [cfg.n_heads // 4]
    assert list(port["split/ff_columns"]) == [cfg.d_ff // 4]


@pytest.mark.parametrize("tag", ["moe", "ssm", "moe_ff"])
def test_expert_and_channel_parallel_steps_match_the_reference(runs, tag):
    _inp, port, ref = runs
    losses = port[f"{tag}/losses"]
    assert np.abs(losses - ref[f"{tag}/losses"]).max() < STEP_TOL
    assert np.abs(losses - port[f"{tag}/losses_single"]).max() < STEP_TOL
    _params_close(port, ref, f"{tag}/sharded", f"{tag}/sharded", STEP_TOL)
    for k, v in port.items():
        if k.startswith(f"{tag}/sharded/"):
            want = port[k.replace(f"{tag}/sharded", f"{tag}/single", 1)]
            assert np.abs(v - want).max() < STEP_TOL, k


@pytest.mark.parametrize("tag", ["qk", "moe", "ssm", "moe_ff"])
def test_the_partitioned_first_step_gradients_are_the_single_devices(runs, tag):
    _inp, port, _ref = runs
    rel = port[f"grads/{tag}"]
    leaves = torch.utils._pytree.tree_leaves(M.abstract_params(MR.tp_cfgs()[tag]))
    assert rel.size == len(leaves)  # every leaf, the q / k norm scales included
    assert rel.max() <= GRAD_TOL, (rel.max(), int(rel.argmax()))


def test_the_moe_load_balance_term_is_the_whole_microbatchs(runs):
    _inp, port, ref = runs
    assert abs(float(port["moe/aux"]) - float(ref["moe/aux"])) < AUX_TOL
    # the input shows the fault the term had: one data rank's own rows
    # give another statistic
    assert abs(float(port["moe/aux_own"]) - float(ref["moe/aux"])) > 100 * AUX_TOL
    # the compressed step's pods: each pod's microbatch, over its data ranks
    assert abs(float(port["moe/aux_pod0"]) - float(ref["moe/aux_pod0"])) < AUX_TOL


@pytest.mark.parametrize("tag", ["A", "moe", "ssm"])
def test_sharded_prefill_and_decode_match_the_references_jitted_steps(runs, tag):
    _inp, port, ref = runs
    got, want = port[f"serve/{tag}/logits"], ref[f"serve/{tag}/logits"]
    assert got.shape == want.shape == (3, 8, 1, 256)
    for step in range(3):
        assert np.abs(got[step] - want[step]).max() <= SERVE_TOL * np.abs(want[step]).max()
    assert bool(port[f"serve/{tag}/pieces_ok"])
    seen = 0
    for key, leaf in port.items():
        if not key.startswith(f"serve/{tag}/cache/"):
            continue
        rkey, layer = _port_to_ref_key(key)
        w = ref[rkey] if layer is None else ref[rkey][layer]
        assert leaf.shape == w.shape, key
        assert np.abs(leaf - w).max() <= SERVE_TOL * max(np.abs(w).max(), 1e-30), key
        seen += 1
    assert seen


@pytest.mark.parametrize("shape", ["2x2x2", "2x4"])
def test_resume_on_mesh_of_a_reference_checkpoint_is_exact(runs, shape):
    _inp, port, _ref = runs
    assert port[f"elastic/{shape}/split_leaves_rank0"] > 0
    assert float(port[f"elastic/{shape}/params"]) == 0.0
    assert float(port[f"elastic/{shape}/opt"]) == 0.0


def test_pipeline_matches_sequential_and_the_reference(runs):
    inp, port, ref = runs
    seq = torch.from_numpy(inp["pp_x"])
    for w in torch.from_numpy(inp["pp_ws"]):
        seq = torch.tanh(seq @ w)
    assert bool(port["pp/same_on_every_rank"])
    assert float(port["pp/bubble"]) == pytest.approx(3 / 9)
    assert np.abs(port["pp/out"] - seq.numpy()).max() < PP_TOL
    assert np.abs(port["pp/out"] - ref["pp/out"]).max() < PP_TOL


def test_compressed_psum_is_bit_equal_to_the_reference(runs):
    inp, port, ref = runs
    np.testing.assert_array_equal(port["cp/out"], ref["cp/out"])
    np.testing.assert_array_equal(port["cp/err"], ref["cp/err"])
    assert list(port["cp/wire"]) == ["torch.float32", "torch.int8"]  # scale, payload
    expect = inp["cp_x"].mean(axis=0)
    assert np.abs(port["cp/out"][0] - expect).max() / np.abs(expect).max() < 0.05


def test_compressed_train_step_learns_with_an_int8_payload(runs):
    _inp, port, ref = runs
    losses = port["cs/losses"]
    assert losses[-1] < losses[0] - 0.2, losses
    assert int(port["cs/int8_payloads"]) == 8 * int(port["cs/leaves"])
    assert losses[0] == pytest.approx(float(ref["cs/losses"][0]), rel=LOSS_REL_TOL)


def test_a_one_rank_sharded_step_gives_the_single_device_bits():
    # One rank: every collective copies, so the sharded step must repeat the
    # single-device step's operations exactly (what the card checks at full
    # width), here over two steps of two microbatches.
    import dataclasses

    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.steps import make_train_step

    cfg = dataclasses.replace(_cfg(256), dtype="bfloat16")
    rc = RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=1e-3, warmup_steps=1,
                   microbatches=2)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    opt = init_opt_state(params, AdamWConfig())
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 256, (4, 32)), "labels": rng.integers(0, 256, (4, 32))}
               for _ in range(2)]
    mesh = single_device_mesh(device_type="cpu")
    try:
        pshard = SH.param_shardings(mesh, M.abstract_params(cfg))
        oshard = SH.opt_state_shardings(mesh, opt, pshard)
        single, sharded = make_train_step(cfg, rc), make_train_step(cfg, rc, grad_shardings=pshard)
        p1, o1, p2, o2 = params, opt, SH.place(params, pshard), SH.place(opt, oshard)
        for b in batches:
            p1, o1, m1 = single(p1, o1, b)
            p2, o2, m2 = sharded(p2, o2, b)
            assert torch.equal(m1["loss"], m2["loss"])
            assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        for a, b in zip(pytree.tree_leaves((p1, o1)), pytree.tree_leaves((p2, o2))):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _start_train(args: list, ranks: int = 0) -> subprocess.Popen:
    """``launch.train`` alone, or under ``torchrun`` with ``ranks`` processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    if ranks:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={ranks}", "-m", "repro_torch.launch.train"]
    return subprocess.Popen(cmd + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _losses(proc: subprocess.Popen) -> tuple[float, float]:
    """(first, last) loss the launcher printed."""
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if " steps in " in x)
    first, last = line.split(" loss ")[1].split()[0:3:2]
    return float(first), float(last)


def test_the_launcher_trains_through_the_mesh_as_on_one_device(tmp_path):
    args = ["--arch", "qwen3", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "32", "--ckpt-every", "2"]
    procs = [_start_train(args + ["--ckpt-dir", str(tmp_path / "one")]),
             _start_train(args + ["--ckpt-dir", str(tmp_path / "m1"), "--mesh"]),
             _start_train(args + ["--ckpt-dir", str(tmp_path / "m2")], ranks=2)]
    one, mesh1, mesh2 = (_losses(p) for p in procs)
    assert mesh1 == one  # one rank: every collective is an identity
    assert mesh2[0] == one[0]  # the first step's loss, before any update
    assert mesh2[1] == pytest.approx(one[1], abs=2e-4)
    assert sorted(p.name for p in (tmp_path / "m2").iterdir()) == ["rank0", "rank1"]
