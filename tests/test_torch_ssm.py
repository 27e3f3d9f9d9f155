"""The port's SSM serving slice against the JAX package, on the CPU.

* the selective scans — ``ref.selective_scan_ref`` (the kernel's plain
  version), ``ops.ssm_scan(device="cpu")``, the kernel's wrapper on a CPU
  tensor, and ``models/ssm.py``'s sequential and chunked scans — against the
  Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and the
  reference's two scans, at tests/test_kernels.py's shapes, with an initial
  and a final state too;
* ``causal_depthwise_conv`` and ``mamba_block`` on the reference's
  parameters, full-sequence and token by token with the cache;
* the reduced falcon-mamba model and a (mamba, attn) hybrid through
  prefill and greedy decode against the JAX model;
* ``serve.main`` on falcon-mamba gives the same ids through ``ops.KERNELS``
  and ``ops.PLAIN``.

Tolerances: 1e-4 (tests/test_kernels.py's scan tolerance, and
tests/test_models.py's for the model's float32 logits) wherever the order
of operations differs from the reference's (the Pallas kernel's fori_loop,
an associative scan's tree, XLA's fusions); 1e-5 where the port repeats the
reference's operations in the same order.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.kernels import mamba_scan as r_mamba_scan  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels import mamba_scan, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-4  # other order of operations than the reference
SAME_ORDER_TOL = 1e-5  # the reference's operations in the same order
SCAN_SHAPES = [  # (B, S, di, ds, chunk, block_d): tests/test_kernels.py
    (1, 64, 16, 4, 16, 16),
    (2, 128, 32, 8, 32, 16),
    (1, 64, 64, 16, 64, 32),
]
SCAN_IDS = [str(s) for s in SCAN_SHAPES]


def _scan_inputs(shape, seed=5):
    """dA in [0.3, 0.98], dBx ~ 0.1 N(0, 1), C ~ N(0, 1), h0 ~ 0.5 N(0, 1)
    (tests/test_kernels.py's ranges), as numpy float32."""
    B, S, di, ds = shape[:4]
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.3, 0.98, (B, S, di, ds)).astype(np.float32)
    dBx = (rng.standard_normal((B, S, di, ds)) * 0.1).astype(np.float32)
    C = rng.standard_normal((B, S, ds)).astype(np.float32)
    h0 = (rng.standard_normal((B, di, ds)) * 0.5).astype(np.float32)
    return dA, dBx, C, h0


@functools.lru_cache(maxsize=None)
def _pallas_y(shape):
    """The Pallas kernel's y (interpret mode) at ``shape``."""
    dA, dBx, C, _ = _scan_inputs(shape)
    B, S, di, ds, chunk, bd = shape
    return np.asarray(r_mamba_scan.selective_scan(
        jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C), chunk=chunk, block_d=bd))


PORT_SCANS = {  # name -> fn(dA, dBx, C, h0, shape) -> (y, h_last)
    "ref.selective_scan_ref": lambda a, b, c, h0, shape: ref.selective_scan_ref(a, b, c, h0),
    "ops.ssm_scan": lambda a, b, c, h0, shape: ops.ssm_scan(
        a, b, c, h0=h0, chunk=shape[4], block_d=shape[5], device="cpu"),
    "mamba_scan.selective_scan": lambda a, b, c, h0, shape: mamba_scan.selective_scan(
        a, b, c, h0, chunk=shape[4], block_d=shape[5]),
    "ssm.selective_scan_reference": lambda a, b, c, h0, shape:
        SSM.selective_scan_reference(a, b, c, h0),
    "ssm.selective_scan_chunked": lambda a, b, c, h0, shape:
        SSM.selective_scan_chunked(a, b, c, h0, chunk=shape[4]),
}


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
@pytest.mark.parametrize("name", sorted(PORT_SCANS))
def test_scan_matches_the_pallas_kernel(name, shape):
    # no initial state: the Pallas kernel's own function
    dA, dBx, C, _ = _scan_inputs(shape)
    y, h = PORT_SCANS[name](*(torch.from_numpy(a) for a in (dA, dBx, C)), None, shape)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape[:3]
    np.testing.assert_allclose(y.numpy(), _pallas_y(shape), atol=TOL, rtol=TOL)
    _, r_h = r_ssm.selective_scan_reference(*(jnp.asarray(a) for a in (dA, dBx, C)))
    np.testing.assert_allclose(h.numpy(), np.asarray(r_h), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
@pytest.mark.parametrize("name", sorted(PORT_SCANS))
def test_scan_with_state_matches_the_reference_scans(name, shape):
    # an initial state in, the final state out, as serving uses them
    arrays = _scan_inputs(shape, seed=6)
    y, h = PORT_SCANS[name](*(torch.from_numpy(a) for a in arrays), shape)
    r_args = [jnp.asarray(a) for a in arrays]
    if name == "ssm.selective_scan_chunked":
        want_y, want_h = r_ssm.selective_scan_chunked(*r_args, chunk=shape[4])
        tol = TOL  # both associative, in different trees
    else:
        want_y, want_h = r_ssm.selective_scan_reference(*r_args)
        tol = SAME_ORDER_TOL  # both sequential: a * h + b, then the readout
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=tol, rtol=tol)


def test_chunked_scan_with_a_ragged_length_takes_one_chunk():
    # S % chunk != 0: the reference falls back to one chunk of S, so does the port
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in _scan_inputs((2, 37, 24, 8)))
    y, h = SSM.selective_scan_chunked(dA, dBx, C, h0, chunk=16)
    want_y, want_h = ref.selective_scan_ref(dA, dBx, C, h0)
    torch.testing.assert_close(y, want_y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h, want_h, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(PORT_SCANS))
def test_scan_final_state_owns_its_memory(name):
    # a cache holds the final state of every layer: it must not be a view
    # into a (B, S, di, ds) state sequence
    shape = (2, 32, 16, 4, 16, 16)
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in _scan_inputs(shape))
    _, h = PORT_SCANS[name](dA, dBx, C, h0, shape)
    assert h.untyped_storage().nbytes() == h.numel() * h.element_size()


def test_scan_wrapper_checks_shapes_and_drops_the_state_on_request():
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in _scan_inputs((2, 8, 16, 4)))
    y, h = mamba_scan.selective_scan(dA, dBx, C, h0, final_state=False)
    assert h is None
    torch.testing.assert_close(y, ref.selective_scan_ref(dA, dBx, C, h0)[0])
    with pytest.raises(ValueError, match="dBx"):
        mamba_scan.selective_scan(dA, dBx[:, :4], C)
    with pytest.raises(ValueError, match="C must be"):
        mamba_scan.selective_scan(dA, dBx, C[:, :, :2])
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan.selective_scan(dA, dBx, C, h0[:1])
    with pytest.raises(ValueError, match="empty"):
        mamba_scan.selective_scan(dA[:, :0], dBx[:, :0], C[:, :0])
    with pytest.raises(ValueError, match="device='cpu'"):
        ops.ssm_scan(dA.to("meta"), dBx, C, device="cpu")


def test_cached_launch_checks_refuse_the_same_bad_inputs_at_a_new_shape():
    # the CUDA path checks shapes, dtypes, devices and the tile once per
    # launch key: a key it has not seen is checked in full, and contiguity
    # and alignment are checked on every call, a cached key's too
    limit = planner.H100.smem_per_block_optin
    good = tuple(torch.from_numpy(a) for a in _scan_inputs((2, 8, 16, 4)))
    assert mamba_scan._checked_tile(good, None, None, limit) == (64, 16)
    assert mamba_scan._checked_tile(good, None, None, limit) == (64, 16)  # cached
    dA, dBx, C, h0 = (torch.from_numpy(a) for a in _scan_inputs((3, 5, 24, 4)))
    bad = [
        (TypeError, None, (dA.double(), dBx.double(), C.double()), {}),
        (ValueError, "dBx", (dA, dBx[:, :4], C), {}),
        (ValueError, "C must be", (dA, dBx, C[:, :, :2]), {}),
        (ValueError, "h0 must be", (dA, dBx, C, h0[:1]), {}),
        (ValueError, "block_d", (dA, dBx, C), {"block_d": 1024}),
        (ValueError, "chunk", (dA, dBx, C), {"chunk": 100_000}),
        (ValueError, "contiguous", (dA, dBx, C, h0.transpose(1, 2).contiguous()
                                    .transpose(1, 2)), {}),
        (ValueError, "aligned", (torch.empty(dA.numel() + 1)[1:].view(dA.shape),
                                 dBx, C), {}),
    ]
    for exc, match, ins, tile in bad:
        for _ in range(2):  # a refused key is not cached: refused again
            with pytest.raises(exc, match=match):
                mamba_scan._checked_tile(ins, tile.get("chunk"), tile.get("block_d"), limit)
    big = tuple(torch.from_numpy(a) for a in _scan_inputs((1, 4, 8, 17)))
    with pytest.raises(ValueError, match="ds 17"):
        mamba_scan._checked_tile(big, None, None, limit)
    # the good key's layout checks still run
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan._checked_tile(good[:3] + (good[3].transpose(1, 2).contiguous()
                                             .transpose(1, 2),), None, None, limit)
    flat = torch.empty(good[0].numel() + 1)[1:].view(good[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        mamba_scan._checked_tile((flat,) + good[1:], None, None, limit)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_the_planner_tile_is_the_kernels_default_and_fits_a_block(name):
    cfg = configs.REGISTRY[name]
    plan = planner.plan_model(cfg, 4096)
    assert (plan.mamba_chunk, plan.mamba_block_d) == mamba_scan.default_tile(cfg.d_inner)
    smem = mamba_scan.smem_bytes(plan.mamba_chunk, plan.mamba_block_d, cfg.ssm_state)
    assert smem == 64 * 16 * 4 <= planner.H100.smem_per_block_optin
    assert cfg.ssm_state <= mamba_scan.MAX_DS


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def _ssm_cfg(**kw):
    base = dict(name="s", family="ssm", n_layers=1, d_model=32, n_heads=1,
                n_kv_heads=1, d_ff=0, layer_pattern=("mamba",), vocab_size=64,
                ssm_state=8, ssm_dt_rank=4, dtype="float32")
    base.update(kw)
    return r_configs.ModelConfig(**base), configs.ModelConfig(**base)


def _mamba_pair(r_cfg, seed):
    r_p = r_ssm.init_mamba(jax.random.key(seed), r_cfg, jnp.float32)
    return r_p, L.params_from_jax(r_p)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    want_y, want_s = r_ssm.causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    y, s = SSM.causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SAME_ORDER_TOL,
                               rtol=SAME_ORDER_TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_init_mamba_has_the_reference_shapes_dtypes_and_ranges():
    r_cfg, cfg = _ssm_cfg(dtype="bfloat16")
    want = r_ssm.init_mamba(jax.random.key(0), r_cfg, jnp.bfloat16)
    got = SSM.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
    # log [1..ds]: torch's and XLA's logarithms may differ in the last bit
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]),
                               atol=SAME_ORDER_TOL, rtol=SAME_ORDER_TOL)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6


@pytest.mark.parametrize("impl", ["reference", "chunked", "kernels"])
def test_mamba_block_matches_the_jax_block(impl):
    r_cfg, cfg = _ssm_cfg()
    r_p, p = _mamba_pair(r_cfg, 0)
    x = np.random.default_rng(1).standard_normal((2, 32, 32)).astype(np.float32)
    r_impl = "reference" if impl == "kernels" else impl
    want, _ = r_ssm.mamba_block(r_p, jnp.asarray(x), r_cfg, impl=r_impl, chunk=8)
    scan = {"reference": SSM.selective_scan_reference,
            "chunked": functools.partial(SSM.selective_scan_chunked, chunk=8),
            "kernels": None}[impl]  # None: ops.KERNELS.ssm_scan
    got, cache = SSM.mamba_block(p, torch.from_numpy(x), cfg, scan=scan)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scan", ["kernels", "plain"])
def test_mamba_block_token_by_token_matches_the_jax_block_and_the_full_sequence(scan):
    # tests/test_models.py::test_mamba_decode_matches_full, against the JAX
    # block at every step
    r_cfg, cfg = _ssm_cfg(d_model=16, ssm_state=4)
    r_p, p = _mamba_pair(r_cfg, 2)
    fn = (ops.KERNELS if scan == "kernels" else ops.PLAIN).ssm_scan
    x = np.random.default_rng(3).standard_normal((1, 8, 16)).astype(np.float32)
    full, _ = SSM.mamba_block(p, torch.from_numpy(x), cfg, scan=fn)
    r_cache = r_ssm.init_mamba_cache(r_cfg, 1, jnp.float32)
    cache = SSM.init_mamba_cache(cfg, 1, torch.float32, "cpu")
    steps = []
    for t in range(8):
        r_y, r_cache = r_ssm.mamba_block(r_p, jnp.asarray(x[:, t:t + 1]), r_cfg, r_cache)
        y, cache = SSM.mamba_block(p, torch.from_numpy(x[:, t:t + 1]), cfg, cache, scan=fn)
        np.testing.assert_allclose(y.numpy(), np.asarray(r_y), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(cache["h"].numpy(), np.asarray(r_cache["h"]),
                                   atol=TOL, rtol=TOL)
        steps.append(y)
    assert cache["conv"].dtype == torch.float32 and cache["h"].dtype == torch.float32
    torch.testing.assert_close(torch.cat(steps, dim=1), full, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------


def _rc(name):
    # the reference's chunked scan in chunks of 8 (two or more per prompt)
    return (dataclasses.replace(r_configs.run_config(name, "decode_32k"),
                                attn_chunk_kv=16, mamba_chunk=8),
            dataclasses.replace(configs.run_config(name, "decode_32k"), attn_chunk_kv=16))


def _model_pair(cfg, seed):
    r_cfg = r_configs.ModelConfig(**dataclasses.asdict(cfg))
    r_params = r_model.init_params(jax.random.key(seed), r_cfg)
    return r_cfg, r_params, T.params_from_jax(jax.tree.map(np.asarray, r_params))


def _prefill_and_decode_match(cfg, seed, *, B=2, S=16, steps=4):
    """Prefill + greedy decode of ``cfg`` through the port (the kernels'
    wrappers, on the CPU) and the JAX model; logits within TOL, the same
    ids."""
    r_cfg, r_params, params = _model_pair(cfg, seed)
    r_rc, rc = _rc(cfg.name)
    max_seq = S + steps + 8
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    r_logits, r_cache = r_model.prefill(r_params, r_cfg, r_rc, {"tokens": jnp.asarray(tokens)},
                                        r_model.init_cache(r_cfg, B, max_seq))
    logits, cache = M.prefill(params, cfg, rc, {"tokens": torch.from_numpy(tokens)},
                              M.init_cache(cfg, B, max_seq, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    # the uncached forward's last position gives the same logits
    h, _, _ = M.forward(params, cfg, rc, {"tokens": torch.from_numpy(tokens)})
    torch.testing.assert_close(T.logits_last(params, cfg, rc, h), logits, atol=TOL, rtol=TOL)
    r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
    tok = logits[:, -1].argmax(-1)[:, None]
    for _ in range(steps):
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        r_logits, r_cache = r_model.decode(r_params, r_cfg, r_rc, r_tok, r_cache)
        logits, cache = M.decode(params, cfg, rc, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
        r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
    assert np.array_equal(tok.numpy(), np.asarray(r_tok))
    assert cache["len"] == int(r_cache["len"]) == S + steps
    return params, cache


def test_reduced_falcon_mamba_prefill_and_decode_match_the_jax_model():
    cfg = configs.scaled_down(configs.resolve("falcon-mamba"))
    params, cache = _prefill_and_decode_match(cfg, 4)
    sub = params["segments"][0][0]["sub0"]
    assert "norm2" not in sub and "mlp" not in sub  # mixer-only blocks
    assert sub["mamba"]["A_log"].dtype == torch.float32
    c = cache["segments"][0][0]["sub0"]
    assert sorted(c) == ["conv", "h"]
    assert tuple(c["h"].shape) == (2, cfg.d_inner, cfg.ssm_state)


def test_bfloat16_falcon_mamba_keeps_the_reference_dtypes():
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve("falcon-mamba")),
                              dtype="bfloat16")
    params = M.init_params(cfg, device="cpu")
    mixer = params["segments"][0][0]["sub0"]["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        assert mixer[k].dtype == torch.float32, k
    for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "out_proj"):
        assert mixer[k].dtype == torch.bfloat16, k
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    c = cache["segments"][0][0]["sub0"]
    assert c["conv"].dtype == torch.bfloat16 and c["h"].dtype == torch.float32
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    logits, cache = M.prefill(params, cfg, configs.RunConfig(), {"tokens": tokens}, cache)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


def test_hybrid_mamba_attention_model_matches_the_jax_model():
    # tests/test_models.py's hybrid family: Mamba and attention caches in
    # one segment, no MoE
    cfg = configs.ModelConfig(name="hyb", family="hybrid", n_layers=4, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                              layer_pattern=("mamba", "attn"), ssm_state=8,
                              ssm_dt_rank=4, dtype="float32")
    params, cache = _prefill_and_decode_match(cfg, 5)
    seg = cache["segments"][0]
    assert len(seg) == 2  # two repeats of the (mamba, attn) superblock
    assert sorted(seg[0]["sub0"]) == ["conv", "h"] and sorted(seg[0]["sub1"]) == ["k", "v"]
    assert "mlp" in params["segments"][0][0]["sub0"]  # d_ff > 0: an FFN after each mixer


def test_serve_falcon_mamba_gives_the_same_ids_through_kernels_and_plain(capsys):
    argv = ["--arch", "falcon-mamba", "--requests", "2", "--prompt-len", "8",
            "--gen", "4", "--device", "cpu"]
    ids = serve.main(argv)
    assert ids.shape == (2, 4) and ids.dtype.kind == "i"
    assert (ids >= 0).all() and (ids < 256).all()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith("[serve] falcon-mamba-7b: 2 requests")
    assert np.array_equal(ids, serve.main(argv, kernels=ops.PLAIN))
