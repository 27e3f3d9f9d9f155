"""The run table of ``chip_smoke.py``'s phase serve_zoo, on the CPU.

The phase serves the registry's six families that no earlier phase served
(granite-34b, phi3-mini, internvl2-1b, llama4-maverick, arctic-480b and
jamba-1.5-large) at full width on one 80 GB card.  Here, with no card:

* every run's arch resolves, at the depth written out below, and that
  depth holds the sublayer kinds it is cut to cover;
* its bfloat16 weights fit beside the plain path (at most 60 GB) and its
  float32 comparison's depth at most 16 GB;
* the launch counts the phase checks, computed from the config, equal the
  counts written out by hand (and the earlier serving phases' counts);
* the kernel phases hold a row at each shape a run launches, and at the
  shapes the benchmark's prefill cells launch (``portbench/``);
* a serve sizes its cache for a vision prefix longer than its slack, and
  ``--layers`` cuts the depth the entry point serves.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import ssm

ROOT = Path(__file__).resolve().parents[1]
GB = 1e9
A, AC, M = ("attn", False), ("attn_chunked", False), ("mamba", False)
# arch: (layers served, float32 comparison depth, the served layers'
# (mixer, is_moe), launches of one serve of 8 x 512 + 32 tokens by hand)
ZOO = {
    "granite": (44, 4, (A,) * 44,
                {"flash_attention": 44, "fused_mlp": 44 * 32, "selective_scan": 0}),
    "phi3": (32, 8, (A,) * 32,
             {"flash_attention": 32, "fused_mlp": 32 * 32, "selective_scan": 0}),
    "internvl2": (24, 24, (A,) * 24,
                  {"flash_attention": 24, "fused_mlp": 24 * 32, "selective_scan": 0}),
    "llama4": (2, 1, (AC, ("attn_chunked", True)),
               {"flash_attention": 2, "fused_mlp": 32, "selective_scan": 0}),
    "arctic": (2, None, (("attn", True),) * 2,
               {"flash_attention": 2, "fused_mlp": 2 * 32, "selective_scan": 0}),
    "jamba": (4, 1, (M, ("mamba", True), M, ("attn", True)),
              {"flash_attention": 1, "fused_mlp": 2 * 32, "selective_scan": 3 * 32}),
}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cs, arch):
    return next(r for r in cs.SERVE_ZOO if r["arch"] == arch)


def _bytes(cfg, itemsize):
    return cfg.param_counts()["total"] * itemsize


def test_the_table_serves_the_six_families_no_other_phase_serves(cs):
    assert [r["arch"] for r in cs.SERVE_ZOO] == list(ZOO)
    served = {configs.resolve(r["arch"]).name
              for r in (cs.SERVE, cs.SERVE_SSM, cs.SERVE_MOE, cs.SERVE_ENCDEC, cs.SERVE_RING)}
    zoo = {configs.resolve(arch).name for arch in ZOO}
    assert not served & zoo
    assert served | zoo == set(configs.REGISTRY)
    for r in cs.SERVE_ZOO:
        assert (r["requests"], r["prompt_len"], r["gen"]) == (8, 512, 32)


@pytest.mark.parametrize("arch", list(ZOO))
def test_each_run_holds_the_sublayer_kinds_its_depth_covers(cs, arch):
    layers, _, kinds, _ = ZOO[arch]
    full = configs.resolve(arch)
    cfg = cs.serve_config(_run(cs, arch))
    assert cfg.n_layers == layers <= full.n_layers
    assert dataclasses.replace(cfg, n_layers=full.n_layers) == full  # depth cut only
    assert cfg.sublayer_kinds(0, cfg.n_layers) == kinds
    # the cut leaves out no kind of the full model but llama4's global
    # attention layer (3 of every 4; with the MoE), which 4 layers (67.5 GB)
    # would need: at a 512-token prompt its K2 launch computes what the
    # chunked layers' does
    left_out = set(full.sublayer_kinds(0, full.n_layers)) - set(kinds)
    assert left_out == ({("attn", True)} if arch == "llama4" else set())


@pytest.mark.parametrize("arch", list(ZOO))
def test_each_run_fits_the_card_beside_its_comparisons(cs, arch):
    _, f32_layers, _, _ = ZOO[arch]
    run = _run(cs, arch)
    assert run["f32_layers"] == f32_layers
    cfg = cs.serve_config(run)
    assert _bytes(cfg, 2) <= 60 * GB
    if f32_layers is None:  # arctic: one float32 layer is over the budget
        assert _bytes(dataclasses.replace(cfg, n_layers=1), 4) > 16 * GB
    else:
        assert _bytes(dataclasses.replace(cfg, n_layers=f32_layers), 4) <= 16 * GB


@pytest.mark.parametrize("arch", list(ZOO))
def test_the_launches_the_phase_expects_are_the_hand_counted_ones(cs, arch):
    want = dict(ZOO[arch][3], fused_conv3x3=0, flash_attention_bwd=0)
    assert cs.zoo_launches(cs.serve_config(_run(cs, arch)), 32) == want


def test_the_launch_rule_gives_the_earlier_serving_phases_counts(cs):
    def count(run):
        return cs.zoo_launches(cs.serve_config(run), run["gen"])

    none = dict(fused_conv3x3=0, flash_attention=0, fused_mlp=0, selective_scan=0,
                flash_attention_bwd=0)
    assert count(cs.SERVE) == dict(none, flash_attention=28, fused_mlp=28 * 32)
    assert count(cs.SERVE_SSM)["selective_scan"] == 64 * 32
    assert count(cs.SERVE_SSM)["flash_attention"] == count(cs.SERVE_SSM)["fused_mlp"] == 0
    assert (count(cs.SERVE_MOE)["flash_attention"], count(cs.SERVE_MOE)["fused_mlp"]) == (16, 0)
    assert count(cs.SERVE_RING)["fused_mlp"] == 6 * 32


@pytest.mark.parametrize("arch", list(ZOO))
def test_the_kernel_phases_hold_a_row_at_each_shape_a_run_launches(cs, arch):
    cfg = cs.serve_config(_run(cs, arch))
    B, S = 8, 512 + (cfg.frontend_len if cfg.frontend else 0)
    att = {label: (shape, causal, window, chunk)
           for label, shape, causal, window, chunk in cs.SERVE_ATTENTION}
    mlp = dict(cs.SERVE_MLP)
    hd = cfg.resolved_head_dim
    chunk = cfg.chunk_size if cfg.mixer_of(0) == "attn_chunked" else 0
    assert att[f"{arch}_prefill"] == ((B, S, S, cfg.n_heads, cfg.n_kv_heads, hd), True,
                                      0, chunk)
    launches = ZOO[arch][3]
    if launches["fused_mlp"]:
        ff = cfg.dense_residual_ff or cfg.d_ff
        assert mlp[f"{arch}_prefill"] == (B * S, cfg.d_model, ff, cfg.ffn_act)
        assert mlp[f"{arch}_decode"] == (B, cfg.d_model, ff, cfg.ffn_act)
    if arch == "llama4":  # the real chunk, crossed: no serve reaches it
        shape, causal, window, chunk = att["llama4_chunk"]
        assert shape[1] > cfg.chunk_size == chunk and shape[3:] == (40, 8, 128)


# the benchmark's prefill cells whose kernel shapes no serve reaches: the
# rows' label in the kernel phases
BENCH_CELLS = {"jamba2-mini-prefill-long": "jamba2_prefill",
               "phi3-prefill-mix": "phi3_prefill_mix"}


@pytest.mark.parametrize("cell", list(BENCH_CELLS))
def test_the_kernel_phases_hold_a_row_at_the_shapes_a_benchmark_cell_launches(cs, cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
    tr = json.loads((ROOT / "portbench" / "workloads" / f"{w['traffic']}.json").read_text())
    label, B, L = BENCH_CELLS[cell], tr["batch"], max(tr["lengths"])
    att = {shape for lab, shape, causal, window, chunk in cs.SERVE_ATTENTION
           if lab == label and causal and not window and not chunk}
    # one prompt a call: every length is its own shape; a batch: the longest
    for length in (set(tr["lengths"]) if B == 1 else {L}):
        assert (B, length, length, cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]) in att
    assert dict(cs.SERVE_MLP)[label] == (B * L, cfg["d_model"], cfg["d_ff"], cfg["ffn_act"])
    scan = {shape for lab, shape in cs.SERVE_SCAN if lab == label}
    if "mamba" in cfg["layer_pattern"]:
        di, ds = cfg["ssm_expand"] * cfg["d_model"], cfg["ssm_state"]
        chunk = ssm.time_chunk(B, di, ds)
        assert chunk < L and scan == {(B, chunk, di, ds)}
    else:
        assert not scan


def test_a_serve_sizes_its_cache_for_the_vision_prefix(cs):
    full = configs.resolve("internvl2")
    assert serve.cache_entries(full, 512, 32) == 256 + 512 + 32 + 8
    assert serve.cache_entries(configs.resolve("seamless"), 512, 32) == 512 + 32 + 8
    # a prefix longer than the 8 spare positions: the prefill writes 16 + 8
    cfg = configs.scaled_down(full, frontend_len=16)
    rc = configs.run_config(cfg.name, "decode_32k")
    out = serve.run(cfg, rc, requests=2, prompt_len=8, gen=4, device="cpu")
    assert out["ids"].shape == (2, 4) and np.isfinite(out["prefill_s"])


def test_the_entry_point_serves_a_depth_cut(capsys):
    argv = ["--arch", "jamba", "--layers", "4", "--requests", "2", "--prompt-len", "8",
            "--gen", "3", "--device", "cpu"]
    ids = serve.main(argv)
    assert ids.shape == (2, 3)
    assert capsys.readouterr().out.startswith("[serve] jamba-1.5-large-398b: 2 requests")
    with pytest.raises(ValueError, match="has 72 layers"):
        serve.main(argv[:3] + ["73"] + argv[4:])
