"""The port's roofline and dry run against the JAX package's, on the CPU.

``model_flops`` bit-equal to the reference's for every config and shape;
``Roofline``'s terms on the numbers of ``tests/test_roofline_and_planner.py``
(its ``mfu_bound`` against the H100's peak); ``resident_bytes_per_device``
bit-equal to the reference's ``_tree_bytes_per_device`` for all 37 cells on
the 16x16 and 2x16x16 meshes (the reference's side in one JAX subprocess
with 512 host devices); the dry run's depth extrapolation equal to the full
trace; the walked FLOPs of a training step against 6 N D; and the CLI's
record keys.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.core import roofline as JRL  # noqa: E402
from repro.core.arch import TPU_V5E  # noqa: E402
from repro_torch.configs import (REGISTRY, SHAPES, ShapeConfig, all_cells,  # noqa: E402
                                 resolve, run_config, scaled_down, supported_shapes)
from repro_torch.core import hlo_cost as HC  # noqa: E402
from repro_torch.core import roofline as RL  # noqa: E402
from repro_torch.core.arch import H100  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_model_flops_are_the_references_bit_for_bit(name):
    for shape in supported_shapes(name):
        for kind in ("train", "prefill", "decode"):
            got = RL.model_flops(REGISTRY[name], SHAPES[shape], kind=kind)
            want = JRL.model_flops(JREGISTRY[name], JSHAPES[shape], kind=kind)
            assert got == want and type(got) is type(want)


def test_the_roofline_terms_follow_the_reference():
    kw = dict(flops=1e12, hbm_bytes=1e12, coll_bytes=1e9, coll_breakdown={},
              compute_s=1e12 / TPU_V5E.peak_flops, memory_s=1e12 / TPU_V5E.hbm_bw,
              collective_s=1e9 / TPU_V5E.ici_bw, model_flops_per_device=5e11)
    want, got = JRL.Roofline(**kw), RL.Roofline(**kw)
    assert got.bound == want.bound == "memory"
    assert got.step_seconds == want.step_seconds
    assert got.useful_flops_ratio == want.useful_flops_ratio == pytest.approx(0.5)
    assert got.mfu_bound == 5e11 / got.step_seconds / 989e12
    assert H100.peak_flops == 989e12 and H100.link_bw == 450e9 and H100.hbm_bw == 3.35e12
    assert got.row().keys() == want.row().keys()


def test_roofline_from_cost_divides_by_the_h100s_rates():
    cost = HC.Cost(dot_flops=6e12, elem_flops=1e11, bytes=8e11, bytes_lo=5e11)
    cost.coll["all-gather"] = 9e9
    cost.coll_count = 3
    r = RL.roofline_from_cost(cost, model_flops_total=256 * 4e12, n_chips=256)
    assert r.flops == 6.1e12 and r.compute_s == 6.1e12 / 989e12
    assert r.memory_s == 5e11 / 3.35e12 and r.memory_s_upper == 8e11 / 3.35e12
    assert r.collective_s == 9e9 / 450e9
    assert r.model_flops_per_device == 4e12
    assert r.bound == "memory" and r.row()["coll_breakdown"]["all-gather"] == 9e9
    assert r.mfu(r.step_seconds) == r.mfu_bound


REFERENCE_RESIDENT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.configs import all_cells
    from repro.launch import dryrun as D
    out = {}
    for arch, shape in all_cells():
        for mesh in ("single", "multi"):
            out[f"{arch}/{shape}/{mesh}"] = D.build_cell(arch, shape, mesh, {})[-1]
    json.dump(out, sys.stdout)
""")


def test_resident_bytes_are_the_references_for_every_cell_and_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_RESIDENT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout)
    cells = all_cells()
    assert len(cells) == 37 and len(want) == 74
    for arch, shape in cells:
        cfg = resolve(arch)
        rc = run_config(cfg.name, shape)
        for mesh in ("single", "multi"):
            ms = production_mesh_shape(multi_pod=(mesh == "multi"))
            got = D.resident_bytes_per_device(cfg, SHAPES[shape], rc, ms)
            assert got == want[f"{arch}/{shape}/{mesh}"], (arch, shape, mesh)


# ---------------------------------------------------------------------------
# The traced per-device program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_mesh():
    import torch.distributed as dist

    mesh = D.device_mesh("single")
    yield mesh
    dist.destroy_process_group()


SMALL = {"train": ShapeConfig("train_s", 128, 32, "train"),
         "prefill": ShapeConfig("prefill_s", 128, 16, "prefill"),
         "decode": ShapeConfig("decode_s", 128, 32, "decode")}
# (arch, kind, layers, microbatches): depths of several periods, some with
# a remainder
EXTRAPOLATION_CASES = [("qwen3", "train", 5, 2), ("seamless", "train", 4, 1),
                       ("gemma3", "decode", 2 + 3 * 6, 1), ("jamba", "prefill", 3 * 8, 1),
                       ("llama4", "prefill", 3 * 4, 1), ("falcon-mamba", "train", 4, 1),
                       ("mixtral", "decode", 3, 1)]


@pytest.mark.parametrize("arch, kind, layers, micro", EXTRAPOLATION_CASES)
def test_the_extrapolated_depth_is_the_full_trace(single_mesh, arch, kind, layers, micro):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = scaled_down(resolve(arch))
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              n_enc_layers=layers if cfg.is_encoder_decoder else 0)
    rc = run_config(cfg.name, {"train": "train_4k", "prefill": "prefill_32k",
                               "decode": "decode_32k"}[kind], xent_chunk=64,
                    mamba_chunk=32, microbatches=micro)
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def build(c):
        return D.program_at(c, SMALL[kind], rc, single_mesh, mode)

    full = D.walk(cfg, build, full_depth=True)
    cut = D.walk(cfg, build)
    assert len(cut["depths"]) == 2 and full["depths"] == [layers]
    assert dataclasses.asdict(cut["cost"]) == dataclasses.asdict(full["cost"])
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert cut["live"][key] == full["live"][key]
    # the peak: a lower bound, within 2 %
    assert cut["live"]["peak_is_lower_bound"] and not full["live"]["peak_is_lower_bound"]
    for key in ("peak_live_bytes", "peak_intermediate_bytes"):
        assert 0.98 * full["live"][key] <= cut["live"][key] <= full["live"][key]
    assert full["cost"].coll["all-gather"] > 0


def test_a_training_step_walks_to_at_least_6nd():
    cfg = dataclasses.replace(scaled_down(resolve("qwen3")), n_layers=4, d_model=128,
                              d_ff=384, vocab_size=1024)
    rc = run_config(cfg.name, "train_4k", remat="full", flash_vjp=True, microbatches=2,
                    xent_chunk=64)
    B, S = 4, 128
    params = M.abstract_params(cfg)
    batch = {k: torch.zeros((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, rc, kernels=ops.traced_kernels(ops.train_kernels(64)))
    cost = HC.cost_of(step, params, init_opt_state(params, AdamWConfig()), batch)
    six_nd = RL.model_flops(cfg, ShapeConfig("t", S, B, "train"), kind="train")
    # above: every product of 6 N D is there; within 1.6x: the remat
    # recompute (a third of the trunk's forward), the chunked
    # cross-entropy's recompute and the attention's products (4 hd a pair
    # forward, 10 backward) are all that is added
    assert six_nd <= cost.dot_flops <= 1.6 * six_nd, cost.dot_flops / six_nd


def test_the_cli_writes_a_record_with_the_references_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3", "--shape",
         "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single.json").read_text())
    ref_keys = {"arch", "shape", "kind", "mesh", "n_chips", "tag", "run_config", "seconds",
                "memory_analysis", "resident_bytes_per_device", "resident_total_gib",
                "roofline", "params"}
    assert ref_keys <= set(rec)
    assert rec["n_chips"] == 256 and rec["kind"] == "decode"
    assert set(rec["roofline"]) == set(RL.Roofline(0, 0, 0, {}, 0, 0, 0, 0).row())
    assert rec["resident_bytes_per_device"] == D.resident_bytes_per_device(
        resolve("qwen3"), SHAPES["decode_32k"], run_config("qwen3-0.6b", "decode_32k"),
        production_mesh_shape())
    assert rec["params"] == resolve("qwen3").param_counts()
    assert rec["roofline"]["coll_breakdown"]["all-gather"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["trace"]["device"] == "meta" and rec["trace"]["depths"] == [1, 2]
