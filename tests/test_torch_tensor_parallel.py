"""Tensor and expert parallelism on the mesh's ``model`` axis, on the CPU.

* The autograd collectives of ``parallel/sharding.py`` (enter, leave and
  gather over ``model``; the sum and the gather over the data axes), forward
  and backward, on 4 gloo ranks of a (2 data, 2 model) mesh against the
  single-process sums.
* The kernels' shape guards at the local shapes the partitioned prefill
  gives them, for the 11 configs at 2, 4 and 16 ``model`` ranks (a host
  trace over fake tensors).
* The dry run's per-device program on 16x16: qwen3 train_4k's walked FLOPs
  and useful-FLOPs ratio, its resident bytes equal to the reference's,
  arctic's decode peak, and the leaves each config gathers over ``model``.

The parity of the partitioned steps with the reference's sharded steps is
``tests/test_torch_multidevice.py``'s.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, SHAPES, resolve, run_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import fused_attention as FA
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import input_specs as IS
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.runtime import steps as ST

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
COLL_TOL = 1e-6  # float32 sums of four terms in another order

COLLECTIVES = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as SH

    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=4)
    inp = np.load(f"{work}/inputs.npz")
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    with SH.use_mesh(mesh):
        for name, fn in (("enter", SH.enter_model), ("leave", SH.leave_model),
                         ("gather", lambda t: SH.gather_model(t, 1)),
                         ("sum_data", SH.sum_data), ("gather_data", SH.gather_data)):
            x = torch.from_numpy(inp["x"][rank]).requires_grad_(True)
            y = fn(x)
            g = torch.from_numpy(inp[f"g_{name}"][rank])
            (dx,) = torch.autograd.grad(y, x, g)
            out[f"{name}/y"] = y.detach().numpy()
            out[f"{name}/dx"] = dx.numpy()
    # a group of one rank: no copy and no collective
    mesh1 = make_mesh((1, 2, 2), ("pod", "data", "model"), device_type="cpu")
    full = torch.arange(12.0).reshape(4, 3) * (rank + 1)
    piece = SH.reduce_scatter_sum(full, SH.NamedSharding(mesh1, SH.P("data")), ("pod",))
    out["one/piece"] = piece.numpy()
    out["one/shares"] = np.array(piece.data_ptr() == full[piece.shape[0] * (rank // 2):]
                                 .data_ptr())
    out["one/gather_is_local"] = np.array(
        SH.gather(full, SH.NamedSharding(mesh1, SH.P("pod")), ("pod",)) is full)
    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
""")


def test_the_autograd_collectives_match_single_process_sums(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 5)).astype(np.float32)  # rank r holds x[r]
    grads = {"enter": (4, 3, 5), "leave": (4, 3, 5), "gather": (4, 3, 10),
             "sum_data": (4, 3, 5), "gather_data": (4, 6, 5)}
    inp = {"x": x}
    for k, shape in grads.items():
        inp[f"g_{k}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", COLLECTIVES, str(tmp_path), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, log[-3000:]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    # (data, model) coordinates of rank r on the (2, 2) mesh, row-major
    model_peers = {r: [r - r % 2, r - r % 2 + 1] for r in range(4)}
    data_peers = {r: [r % 2, r % 2 + 2] for r in range(4)}

    def close(a, b):
        assert np.abs(a - b).max() <= COLL_TOL * max(1.0, np.abs(b).max())

    for r in range(4):
        g = got[r]
        mp, dp = model_peers[r], data_peers[r]
        close(g["enter/y"], x[r])
        close(g["enter/dx"], sum(inp["g_enter"][s] for s in mp))
        close(g["leave/y"], sum(x[s] for s in mp))
        close(g["leave/dx"], inp["g_leave"][r])
        close(g["gather/y"], np.concatenate([x[s] for s in mp], axis=1))
        m = r % 2
        close(g["gather/dx"], inp["g_gather"][r][:, 5 * m:5 * (m + 1)])
        close(g["sum_data/y"], sum(x[s] for s in dp))
        close(g["sum_data/dx"], sum(inp["g_sum_data"][s] for s in dp))
        close(g["gather_data/y"], np.concatenate([x[s] for s in dp], axis=0))
        d = r // 2
        close(g["gather_data/dx"],
              sum(inp["g_gather_data"][s] for s in dp)[3 * d:3 * (d + 1)])
        assert np.array_equal(g["one/piece"],
                              (np.arange(12.0).reshape(4, 3) * (r + 1))[2 * d:2 * (d + 1)])
        assert g["one/shares"] and g["one/gather_is_local"]


class _ModelAxisOfTwo:
    """An ambient context whose model axis has two ranks (no process group:
    the calls under test must refuse before any collective)."""

    def __enter__(self):
        SH._AMBIENT.append(SH.MeshContext(mesh=None, group=None, size=2, rank=0,
                                          data_group=None, data_size=1))

    def __exit__(self, *exc):
        SH._AMBIENT.pop()


@pytest.mark.parametrize("what", ["mlp_block", "chunked_cross_entropy"])
def test_a_piece_needs_its_full_width_on_a_model_parallel_mesh(what):
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, generator=gen)
    if what == "mlp_block":
        p = L.init_mlp(gen, 8, 16, "swiglu", torch.float32)

        def call(**kw):
            return L.mlp_block(p, x, "swiglu", fused=ref.fused_mlp_ref, **kw)
        full = {"width": 16}
    else:
        head = torch.randn(8, 32, generator=gen)
        labels = torch.randint(0, 32, (2, 4), generator=gen)

        def call(**kw):
            return L.chunked_cross_entropy(x, head, labels, chunk=4, **kw)
        full = {"vocab": 32}
    want = call()  # off a mesh the width is not needed
    with _ModelAxisOfTwo():
        with pytest.raises(ValueError, match="model-parallel"):
            call()
        got = call(**full)  # a weight as wide as the config: no collective
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The kernels' guards at local shapes
# ---------------------------------------------------------------------------


def _guarded(seen: dict) -> ops.FusedKernels:
    """The marker kernel set, each call first put through its wrapper's
    shape guards (the checks the card's launch makes, short of pointers)
    and its local shape recorded."""
    marked = ops.traced_kernels()

    def attention(q, k, v, *, causal=True, window=0, chunk=0):
        FA._check_args(q, k, v, window, chunk)
        assert q.shape[3] in FA.HEAD_DIMS and FA.DEFAULT_TILE in FA.TILES
        assert all(t.is_contiguous() for t in (q, k, v))
        seen.setdefault("heads", set()).add((q.shape[2], k.shape[2]))
        return marked.attention(q, k, v, causal=causal, window=window, chunk=chunk)

    def mlp(x, w1, w2, w3=None, *, act="swiglu"):
        FM._check_args(x, w1, w2, w3, act)
        d, ff = w1.shape
        assert d % 8 == 0 and ff % 8 == 0, (d, ff)
        for rows in (x.reshape(-1, d).shape[0], 8):  # the prefill's tile and a decode's
            assert FM.default_tile(rows, x.dtype) in FM.TILES
        assert all(t.is_contiguous() for t in (w1, w2) + ((w3,) if w3 is not None else ()))
        seen.setdefault("ff", set()).add(ff)
        return marked.mlp(x, w1, w2, w3, act=act)

    def ssm_scan(dA, dBx, C, h0=None, **kw):
        MS._check_tile((dA, dBx, C) + ((h0,) if h0 is not None else ()), None, None,
                       MS.SMEM_OPTIN)
        seen.setdefault("channels", set()).add(dA.shape[2])
        return marked.ssm_scan(dA, dBx, C, h0, **kw)

    return dataclasses.replace(marked, attention=attention, mlp=mlp, ssm_scan=ssm_scan)


@pytest.mark.parametrize("tp", [2, 4, 16])
def test_local_shapes_pass_every_kernels_guards(tp):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    import torch.distributed as dist

    D.fake_world(2 * tp)
    try:
        mesh = init_device_mesh("cpu", (2, tp), mesh_dim_names=("data", "model"))
        SH.rank_grid(mesh)
        shape = ShapeConfig("p", 256, 2, "prefill")
        for arch in REGISTRY:
            cfg = D.depth_cut(resolve(arch), 1)
            rc = run_config(cfg.name, "prefill_32k")
            mode = FakeTensorMode(allow_non_fake_inputs=True)
            specs = IS.input_specs(cfg, shape, ring=rc.local_ring_cache)
            aparams = M.abstract_params(cfg)
            pshard = SH.param_shardings(mesh, aparams)
            cshard = SH.cache_shardings(mesh, specs["cache"])
            seen: dict = {}
            step = ST.make_prefill_step(cfg, rc, kernels=_guarded(seen),
                                        shardings=(pshard, cshard))
            args = (D._pieces(aparams, pshard, mode), D._pieces(specs["cache"], cshard, mode),
                    D._fake_like(specs["batch"], mode))
            D.HC.trace(step, *args)
            gathered = SH.model_gathered_paths(pshard, cfg)
            if cfg.d_ff and not cfg.n_experts:
                assert seen["ff"] == {cfg.d_ff // tp}, (arch, seen)
            if "mamba" in cfg.layer_pattern:
                assert seen["channels"] == {cfg.d_inner // tp}, (arch, seen)
            if not any(p.endswith("attn/wq") for p in gathered) and "heads" in seen:
                assert {h for h, _ in seen["heads"]} == {cfg.n_heads // tp}, (arch, seen)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The dry run on 16x16
# ---------------------------------------------------------------------------

REFERENCE_RESIDENT = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.configs import resolve, run_config
    from repro.launch import dryrun as D
    cfg, shape, rc, mesh, jitted, args, resident = D.build_cell("qwen3", "train_4k",
                                                                 "single", {})
    print(json.dumps(resident))
""")


@pytest.fixture(scope="module")
def qwen3_train_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    import torch.distributed as dist

    try:
        yield D.run_cell("qwen3", "train_4k", "single", out, {})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_qwen3_train_4k_splits_its_compute_over_model(qwen3_train_record):
    rl = qwen3_train_record["roofline"]
    assert rl["flops"] <= 7.3e13, rl["flops"]  # 4.39929e14 with the model gathered
    assert rl["useful_flops_ratio"] >= 0.20, rl["useful_flops_ratio"]  # was 0.0333
    assert rl["coll_breakdown"]["all-reduce"] > 0  # the row-parallel products' sums


def test_qwen3_train_4k_resident_bytes_are_the_references(qwen3_train_record):
    pytest.importorskip("jax")
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_RESIDENT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert qwen3_train_record["resident_bytes_per_device"] == want


def test_arctic_decode_fits_an_eighth_of_the_gathered_model(tmp_path):
    import torch.distributed as dist

    try:
        rec = D.run_cell("arctic", "decode_32k", "single", tmp_path, {})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    peak = rec["memory_analysis"]["peak_live_bytes"]
    assert peak <= 934 * 2**30 / 8, peak / 2**30  # 934 GiB with every leaf gathered
    assert rec["resident_bytes_per_device"] == D.resident_bytes_per_device(
        resolve("arctic"), SHAPES["decode_32k"], run_config("arctic-480b", "decode_32k"),
        production_mesh_shape())


# (arch, the module/leaf names gathered over model on 16x16): heads or KV
# heads that do not divide 16; Mamba's in_proj (its column piece holds x-
# or z-channels); a vocabulary that does not divide 16.  Experts that do
# not divide 16 (mixtral's 8) split their d_ff columns instead.
GATHERED = [
    ("arctic", {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}),  # 56 heads
    ("internvl2", {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}),  # 14 heads
    ("llama4", {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}),  # 40 heads
    ("mixtral", {"attn/wk", "attn/wv"}),  # 8 KV heads (8 experts: their d_ff split)
    ("granite", {"attn/wk", "attn/wv"}),  # one KV head
    ("qwen3", {"attn/wk", "attn/wv"}),  # 8 KV heads
    ("falcon-mamba", {"mamba/in_proj"}),
    ("seamless", {"embed"}),  # 256,206 rows
    ("phi3", set()),
    ("gemma3", set()),
]


@pytest.mark.parametrize("arch, names", GATHERED)
def test_the_leaves_gathered_over_model_are_listed(arch, names):
    cfg = resolve(arch)
    pshard = SH.param_shardings(production_mesh_shape(), M.abstract_params(cfg))
    paths = SH.model_gathered_paths(pshard, cfg)
    assert {"/".join(p.split("/")[-2:]) if "/" in p else p for p in paths} == names
    attn = [p for p in paths if p.endswith("attn/wq")]
    assert len(attn) in (0, cfg.n_layers)  # a rule holds for every layer
