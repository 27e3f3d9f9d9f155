"""The run table of ``chip_smoke.py``'s phase train_zoo, and the repairs
training at full width needed, on the CPU.

The phase trains seven registry families that no earlier phase trained
(internvl2-1b, seamless-m4t-large-v2, phi3-mini-3.8b, gemma3-27b,
granite-34b, mixtral-8x7b and falcon-mamba-7b) at full width on one 80 GB
card through ``launch.train.run``.  Here, with no card:

* the table names exactly those seven, each at the depth written out
  below, and each cut (and its float32 parity's depth) holds every
  sublayer kind of its family;
* each run's training state, and its parity pass's gradients, fit the
  card with room for the activations;
* the launch counts the phase checks, computed from the config, equal the
  counts written out by hand, and the same rule gives the earlier training
  phases' counts;
* the kernel phase holds a row at each attention shape a run launches;
* ``run`` on the CPU trains each run's family, depth-cut and scaled down,
  for two steps;
* the repairs: AdamW's in-place (donated) update and the donating step give
  the functional update's bits, and the chunked scan recomputes each chunk
  in the backward (the same gradient bits, one chunk's rounds saved at a
  time).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.data import make_batch
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime.steps import make_init, make_train_step

ROOT = Path(__file__).resolve().parents[1]
GB = 1e9
ROOM = 64 * GB  # of the card's 80 GB: the rest for activations and temporaries
# arch: (layers trained, microbatches, sequences a step, hand-counted
# launches of the phase's 3 steps: (flash_attention, flash_attention_bwd))
ZOO = {
    "internvl2": (24, 1, 2, (2 * 24 * 3, 24 * 3)),
    "seamless": (24, 1, 2, (2 * (24 + 24 + 24) * 3, (24 + 24 + 24) * 3)),
    "phi3": (32, 2, 2, (2 * 32 * 2 * 3, 32 * 2 * 3)),
    "gemma3": (6, 4, 4, (2 * 6 * 4 * 3, 6 * 4 * 3)),
    "granite": (8, 4, 4, (2 * 8 * 4 * 3, 8 * 4 * 3)),
    "mixtral": (2, 1, 2, (2 * 2 * 3, 2 * 3)),
    "falcon-mamba": (24, 2, 2, (0, 0)),
}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cs, arch):
    return next(r for r in cs.TRAIN_ZOO if r["arch"] == arch)


def _f32(cs, run):
    return dataclasses.replace(cs.serve_config(run), dtype="float32",
                               **run.get("f32", {"n_layers": cs.TRAIN_F32_LAYERS}))


def _kinds(cfg) -> set:
    if cfg.is_encoder_decoder:
        return {("encoder", cfg.n_enc_layers > 0), ("decoder", cfg.n_layers > 0)}
    return set(cfg.sublayer_kinds(0, cfg.n_layers))


def test_the_table_trains_the_seven_families_no_other_phase_trains(cs):
    assert [r["arch"] for r in cs.TRAIN_ZOO] == list(ZOO)
    assert (cs.TRAIN_ZOO_STEPS, cs.TRAIN_ZOO_SEQ) == (3, 4096)
    trained = {configs.resolve(r["arch"]).name for r in (cs.TRAIN_RUN, cs.TRAIN_TP)}
    zoo = {configs.resolve(arch).name for arch in ZOO}
    assert not trained & zoo
    # the three left: one MoE layer's experts alone take 97-161 GB of state
    left = {configs.resolve(a).name for a in ("llama4", "arctic", "jamba")}
    assert trained | zoo | left == set(configs.REGISTRY)
    for name in left:
        cfg = configs.REGISTRY[name]
        experts = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        assert experts * 10 > 80 * GB  # bf16 parameter, bf16 m and v, f32 gradient


@pytest.mark.parametrize("arch", list(ZOO))
def test_each_cut_holds_every_sublayer_kind_of_its_family(cs, arch):
    layers, micro, batch, _ = ZOO[arch]
    run = _run(cs, arch)
    full = configs.resolve(arch)
    cfg = cs.serve_config(run)
    assert run["batch"] == batch and cs.train_zoo_rc(cfg).microbatches == micro
    assert cfg.n_layers == layers <= full.n_layers
    assert dataclasses.replace(cfg, n_layers=full.n_layers) == full  # depth cut only
    assert _kinds(cfg) == _kinds(full)
    assert _kinds(_f32(cs, run)) == _kinds(full)  # gemma3's global layer, the cross attention


@pytest.mark.parametrize("arch", list(ZOO))
def test_each_run_fits_the_card_beside_its_parity(cs, arch):
    run = _run(cs, arch)
    cfg = cs.serve_config(run)
    n = cfg.param_counts()["total"]
    micro = ZOO[arch][1]
    assert cs.train_state_bytes(cfg, micro) == n * (16 if micro > 1 else 12)
    assert cs.train_state_bytes(cfg, micro) <= ROOM
    assert n * (2 + 2 * 2) <= ROOM  # bf16 parameters, two gradients at once
    assert _f32(cs, run).param_counts()["total"] * (4 + 2 * 4) <= ROOM


@pytest.mark.parametrize("arch", list(ZOO))
def test_the_launches_the_phase_expects_are_the_hand_counted_ones(cs, arch):
    layers, micro, _, (k2, bwd) = ZOO[arch]
    cfg = cs.serve_config(_run(cs, arch))
    assert cs.train_launches(cfg, cs.TRAIN_ZOO_STEPS, micro) == dict(
        fused_conv3x3=0, flash_attention=k2, fused_mlp=0, selective_scan=0,
        flash_attention_bwd=bwd)


def test_the_launch_rule_gives_the_earlier_training_phases_counts(cs):
    qwen3 = configs.resolve(cs.TRAIN_RUN["arch"])
    got = cs.train_launches(qwen3, 10, cs.TRAIN_RUN["microbatches"])  # 8 steps + 2 replayed
    assert (got["flash_attention"], got["flash_attention_bwd"]) == (2240, 1120)
    got = cs.train_launches(qwen3, cs.TRAIN_SHARDED["steps"], cs.TRAIN_RUN["microbatches"])
    assert (got["flash_attention"], got["flash_attention_bwd"]) == (672, 336)
    got = cs.train_launches(qwen3, cs.TRAIN_SHARDED["compressed_steps"], 1)
    assert (got["flash_attention"], got["flash_attention_bwd"]) == (448, 224)


@pytest.mark.parametrize("arch", list(ZOO))
def test_the_kernel_phase_holds_a_row_at_each_shape_a_run_launches(cs, arch):
    run = _run(cs, arch)
    cfg = cs.serve_config(run)
    rows = {label: (shape, dname, causal, window, chunk)
            for label, shape, dname, causal, window, chunk in cs.TRAIN_KERNEL_CASES}
    shapes = cs.train_zoo_shapes(run)
    per_step = cs.train_launches(cfg, 1, ZOO[arch][1])["flash_attention_bwd"]
    assert sum(s[5] for s in shapes) * ZOO[arch][1] == per_step
    hd = cfg.resolved_head_dim
    B = run["batch"] // ZOO[arch][1]
    for label, shape, causal, window, chunk, _ in shapes:
        assert rows[label] == (shape, "bfloat16", causal, window, chunk)
        assert shape[0] == B and shape[3:] == (cfg.n_heads, cfg.n_kv_heads, hd)
    want = {  # the shapes this slice brings to K2's backward first
        "granite": ((1, 4096, 4096, 48, 1, 128), 0),
        "phi3": ((1, 4096, 4096, 32, 32, 96), 0),
        "gemma3": ((1, 4096, 4096, 32, 16, 128), 1024),
        "seamless": ((2, 4096, 1024, 16, 16, 64), 0),
        "internvl2": ((2, 4352, 4352, 14, 2, 64), 0),
    }
    if arch in want:
        assert want[arch] in {(s[1], s[3]) for s in shapes}


@pytest.mark.parametrize("arch", list(ZOO))
def test_run_trains_each_family_depth_cut_and_scaled_down_on_the_cpu(cs, arch, tmp_path):
    run = _run(cs, arch)
    full = configs.resolve(arch)
    cfg = configs.scaled_down(full, n_layers=full.pattern_period,
                              n_enc_layers=1 if full.is_encoder_decoder else 0)
    rc = dataclasses.replace(cs.train_zoo_rc(cfg), mamba_chunk=8)
    out = train.run(cfg, rc, steps=2, batch=run["batch"], seq=16, ckpt_dir=tmp_path,
                    ckpt_every=3, seed=0, device="cpu")
    losses = out["report"].losses
    assert out["report"].steps_run == len(losses) == 2
    assert all(math.isfinite(x) for x in losses)


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------


def _tree(gen, dtype):
    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen).to(dt)

    return {"w": randn(13, 11), "b": randn(29, dt=torch.float32),
            "t": randn(5, 7).T, "layers": [randn(3, 4, 5), randn(17)]}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_in_place_adamw_update_gives_the_functional_bits(monkeypatch, dtype,
                                                             state_dtype):
    """Slices of 7 elements (the leaves are 17 to 319), a non-contiguous
    leaf (the transposed one): every new parameter and moment bit-equal to
    the functional update's, written into the given tensors."""
    monkeypatch.setattr(adamw, "_SLICE", 7)
    gen = torch.Generator().manual_seed(0)
    cfg = AdamWConfig(state_dtype=state_dtype)
    params, grads = _tree(gen, dtype), _tree(gen, dtype)
    opt = adamw.init_opt_state(params, cfg)
    for i in range(2):
        opt["m"] = pytree.tree_map(lambda t: torch.randn_like(t.float()).to(t.dtype),
                                   opt["m"])
        opt["v"] = pytree.tree_map(lambda t: torch.rand_like(t.float()).to(t.dtype),
                                   opt["v"])
        want_p, want_o, want_n = adamw.adamw_update(grads, opt, params, lr=1e-2, cfg=cfg)
        given = pytree.tree_leaves((params, opt["m"], opt["v"]))
        got_p, got_o, got_n = adamw.adamw_update(grads, opt, params, lr=1e-2, cfg=cfg,
                                                 inplace=True)
        assert all(a is b for a, b in zip(pytree.tree_leaves((got_p, got_o["m"], got_o["v"])),
                                          given))
        for a, b in zip(pytree.tree_leaves((got_p, got_o, got_n)),
                        pytree.tree_leaves((want_p, want_o, want_n))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        params, opt = got_p, got_o


def test_a_donating_train_step_gives_the_functional_steps_bits():
    cfg = configs.scaled_down(configs.resolve("qwen3"))
    rc = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16, microbatches=2, remat="full",
                           flash_vjp=True, learning_rate=3e-3, warmup_steps=1)
    params, opt = make_init(cfg, rc, device="cpu")(torch.Generator().manual_seed(0))
    functional, donating = make_train_step(cfg, rc), make_train_step(cfg, rc, donate=True)
    d_params, d_opt = pytree.tree_map(torch.clone, (params, opt))
    for i in range(2):
        batch = make_batch(cfg, 4, 32, seed=0, step=i)
        before = pytree.tree_leaves((params, opt["m"], opt["v"]))
        params, opt, m = functional(params, opt, batch)
        assert not any(a is b for a, b in zip(pytree.tree_leaves(params), before))
        given = pytree.tree_leaves((d_params, d_opt["m"], d_opt["v"]))
        d_params, d_opt, d_m = donating(d_params, d_opt, batch)
        held = pytree.tree_leaves((d_params, d_opt["m"], d_opt["v"]))
        assert all(a is b for a, b in zip(held, given))  # written in place
        assert torch.equal(m["loss"], d_m["loss"])
        got = pytree.tree_leaves((d_params, d_opt))
        assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves((params, opt)), got))


def _scan_inputs(seed=0, B=1, S=64, di=24, ds=4):
    gen = torch.Generator().manual_seed(seed)
    dA = torch.rand((B, S, di, ds), generator=gen).requires_grad_(True)
    dBx = torch.randn((B, S, di, ds), generator=gen).requires_grad_(True)
    C = torch.randn((B, S, ds), generator=gen).requires_grad_(True)
    return dA, dBx, C


def _saved_bytes(fn) -> tuple:
    """(``fn()``, the bytes of the storages autograd saves for its
    backward)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def test_the_chunked_scan_recomputes_each_chunk_in_its_backward(monkeypatch):
    """falcon-mamba's doubling scan saved log2(chunk) rounds of (B, chunk,
    di, ds) pairs of every chunk for the backward: 40 GB a layer at 4096
    tokens, more than the card held beside the training state.  Each chunk
    is now recomputed in the backward: the same gradient bits, and only the
    scan's inputs and the state entering each chunk saved."""
    gen = torch.Generator().manual_seed(0)
    inputs = [torch.rand((1, 64, 24, 4), generator=gen).requires_grad_(True),
              torch.randn((1, 64, 24, 4), generator=gen).requires_grad_(True),
              torch.randn((1, 64, 4), generator=gen).requires_grad_(True)]
    w = torch.randn(inputs[0].shape[:3], generator=gen)

    def grads():
        (y, h), saved = _saved_bytes(lambda: SSM.selective_scan_chunked(*inputs, chunk=16))
        return torch.autograd.grad((y * w).sum() + h.sum(), inputs), saved

    got, saved = grads()
    monkeypatch.setattr(SSM, "checkpoint", lambda fn, *args, **kw: fn(*args))
    want, saved_before = grads()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = inputs[0].numel() * inputs[0].element_size()  # one (B, S, di, ds) tensor
    given = sum(t.numel() * t.element_size() for t in inputs)
    states = (64 // 16) * one // 64  # (B, di, ds) a chunk
    assert saved_before - given >= 4 * one
    assert saved - given <= states  # the inputs and each chunk's state, no more


def test_the_chunked_scan_keeps_its_values_under_grad_and_without():
    inputs = _scan_inputs(seed=1)
    y, h = SSM.selective_scan_chunked(*inputs, chunk=16)
    with torch.no_grad():
        y0, h0 = SSM.selective_scan_chunked(*inputs, chunk=16)
    assert torch.equal(y, y0) and torch.equal(h, h0)


def test_the_recomputed_chunks_nest_in_every_remat_policy():
    """The chunks' recompute inside the trunk's own ("dots" selective,
    "full") activation checkpointing: the loss and every gradient as
    without remat (float32 sums the backward may add in another order)."""
    cfg = configs.scaled_down(configs.resolve("falcon-mamba"))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in make_batch(cfg, 2, 32, seed=0).items()}
    out = {}
    for remat in ("none", "dots", "full"):
        rc = configs.RunConfig(xent_chunk=16, mamba_chunk=8, remat=remat)
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc, batch)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    for remat in ("dots", "full"):
        torch.testing.assert_close(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(a, b)


def _clustered(dtype, spread: float, seed: int = 0):
    """q, k, v, dout of a cross attention whose keys and values are nearly
    one vector (``spread`` of noise about it), as seamless's encoder frames
    are at random initialisation."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((1, 64, 2, 32), generator=gen, dtype=torch.float64)
    k, v = (torch.randn((1, 1, 2, 32), generator=gen, dtype=torch.float64)
            + spread * torch.randn((1, 48, 2, 32), generator=gen, dtype=torch.float64)
            for _ in range(2))
    dout = torch.randn((1, 64, 2, 32), generator=gen, dtype=torch.float64)
    return [t.to(dtype) for t in (q, k, v, dout)]


@pytest.mark.parametrize("spread", [0.05, 0.3])
def test_the_bf16_plain_backward_sums_d_from_p_and_dp(spread):
    """The backward's plain version, as the kernel, takes D = rowsum(P dP)
    for a bfloat16 output: each row of dS then adds to 0 up to float32
    sums, so the keys' gradients add to 0 (softmax does not see a shift of
    the scores) and dq and dk keep near the float32 backward when the keys
    nearly agree.  D = rowsum(dout * out) of the rounded output misses."""
    from repro_torch.kernels import ref

    mask = dict(causal=False, window=0, chunk=0)
    q, k, v, dout = _clustered(torch.bfloat16, spread)
    lse = ref.attention_lse_ref(q, k, **mask)
    out = ref.flash_attention_ref(q, k, v, **mask)
    wide = [t.float() for t in (q, k, v)]
    want = ref.flash_attention_bwd_ref(*wide, ref.flash_attention_ref(*wide, **mask),
                                       dout.float(), lse, **mask)
    got = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **mask)
    from_out = ref.flash_attention_bwd_ref(q, k, v, out.float(), dout, lse, **mask)

    def err(g):
        return max(float((a.float() - b).norm() / b.norm()) for a, b in zip(g[:2], want[:2]))

    assert err(got) <= 2e-2
    assert err(from_out) > 4 * err(got)
    dk = got[1].float()
    assert float(dk.sum(1).norm() / dk.norm()) <= 1e-2


def test_the_parity_controls_reorder_the_attention_and_the_scan(cs):
    """grad_parity's control: blocked attention, and the chunked scan at
    half the run's chunk; its plain path the sequential scan."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in ((2, 24, 4, 16), (2, 24, 2, 16),
                                                          (2, 24, 2, 16)))
    torch.testing.assert_close(cs.blocked_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v), rtol=1e-5, atol=1e-6)
    dA = torch.rand((1, 32, 4, 3), generator=gen)
    dBx, C = torch.randn((1, 32, 4, 3), generator=gen), torch.randn((1, 32, 3), generator=gen)
    for chunk in (4, 8):
        for a, b in zip(SSM.selective_scan_chunked(dA, dBx, C, chunk=chunk),
                        ref.selective_scan_ref(dA, dBx, C)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["seamless", "mixtral", "falcon-mamba"])
def test_the_parity_check_runs_its_paths_on_the_cpu(cs, arch, capsys):
    """grad_parity at a scaled-down config on the CPU, where the kernel set
    takes the plain versions: every leaf named, the reordering measured,
    mixtral's routes replayed and counted; falcon-mamba's chunked scan held
    against the sequential one."""
    cfg = configs.scaled_down(configs.resolve(arch))
    rc = dataclasses.replace(cs.train_zoo_rc(cfg), xent_chunk=16, attn_chunk_kv=16,
                             mamba_chunk=8)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    seq = 16 + (cfg.frontend_len if cfg.frontend and not cfg.is_encoder_decoder else 0)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, seq, seed=0).items()}
    batch = {k: v.long() if not v.dtype.is_floating_point else v for k, v in batch.items()}
    out = cs.grad_parity(torch, cfg, rc, "bfloat16", params, batch, "test", "cpu")
    assert len(out["leaves"]) == len(out["rel_l2"]) == len(pytree.tree_leaves(params))
    assert len(out["control_rel_l2"]) == len(out["rel_l2"])
    if arch == "falcon-mamba":  # the chunked scan against the sequential one
        assert 0 < max(out["rel_l2"]) <= 1e-4
    else:
        assert max(out["rel_l2"]) <= 1e-5
    assert (out["flips"] is not None) == (arch == "mixtral")
    assert "nearest their limits" in capsys.readouterr().out
