"""The port's flash attention (K2) and fused MLP (K3) on the CPU, against
the JAX package.

On a CPU tensor each wrapper takes its kernel's plain PyTorch version;
here that is held against the reference's Pallas kernel in interpret mode
and its oracle (``repro.kernels.ref``), at the shapes and tolerances of
tests/test_kernels.py.  The CUDA kernels themselves run only on the card
(tests/test_torch_on_card.py and chip_smoke.py).

The bfloat16 bodies of both kernels run on the tensor cores and round one
intermediate to bfloat16 that the TPU kernels keep in float32: K2 rounds
the probabilities P before P @ V (with the row sums l over the float32 P),
K3 rounds the hidden tile h before h @ w2.  ``_k2_tensor_core`` and
``_k3_tensor_core`` below emulate that arithmetic in plain PyTorch, and the
tests hold them to the Pallas kernels within the bf16 tolerances.

Each kernel's shared-memory sizing (``smem_bytes``, the flash-attention
backward's too) is held under a Hopper block's opt-in limit at every tile,
head dim and dtype it is built for.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fused_attention as r_fa  # noqa: E402
from repro.kernels import fused_mlp as r_fm  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.core import arch  # noqa: E402
from repro_torch.kernels import (flash_attention_bwd, fused_attention, fused_mlp, ops,  # noqa: E402
                                 ref)

# tests/test_kernels.py: attention f32 2e-5, bf16 2e-2; MLP 10x those.
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLP_TOL = {"float32": 2e-4, "bfloat16": 2e-1}
SMEM_LIMIT = 232_448  # shared memory one Hopper block may opt in to
ATT_SHAPES = [  # (B, Sq, Skv, H, KV, hd), those of tests/test_kernels.py
    (1, 128, 128, 4, 4, 64),   # MHA
    (2, 256, 256, 8, 2, 64),   # GQA 4:1
    (1, 128, 256, 4, 1, 128),  # MQA, cross-length
    (2, 384, 384, 6, 2, 32),   # non-pow2 heads
]
MLP_SHAPES = [  # (T, d, ff, act), those of tests/test_kernels.py
    (128, 64, 256, "swiglu"),
    (256, 128, 512, "geglu"),
    (128, 64, 128, "gelu"),
    (384, 96, 384, "relu"),
]


def _qkv(B, Sq, Skv, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32))


def _both(arrays, dtype):
    """The same numpy inputs as JAX arrays and as torch tensors of ``dtype``."""
    j = tuple(jnp.asarray(a).astype(dtype) for a in arrays)
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _k2_tensor_core(q, k, v, *, causal=True, window=0, chunk=0, block_k=64,
                    round_p=True):
    """The bf16 K2 body's arithmetic: bf16 products summed in float32, the
    online softmax over ``block_k``-key tiles with the finite -1e30 mask,
    P rounded to bf16 before P @ V (``round_p``) while l sums the float32
    P, the output rounded to bf16."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    idx = torch.arange(H) // (H // KV)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.index_select(2, idx).float().permute(0, 2, 1, 3)
    vf = v.index_select(2, idx).float().permute(0, 2, 1, 3)
    qp = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), ref.NEG_INF)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Skv, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= (qp - kp) < window
        if chunk:
            ok &= (qp // chunk) == (kp // chunk)
        s = torch.where(ok, (qf @ kt.transpose(-1, -2)) / math.sqrt(hd), ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * corr[..., None] + pv @ vt
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _k3_tensor_core(x, w1, w2, w3=None, *, act="swiglu"):
    """The bf16 K3 body's arithmetic: bf16 products summed in float32, the
    activation in float32, h rounded to bf16 before h @ w2, the output
    rounded to bf16."""
    xf = x.float()
    h = xf @ w1.float()
    if act == "swiglu":
        h = torch.nn.functional.silu(h) * (xf @ w3.float())
    elif act == "geglu":
        h = torch.nn.functional.gelu(h, approximate="tanh") * (xf @ w3.float())
    elif act == "gelu":
        h = torch.nn.functional.gelu(h, approximate="tanh")
    else:
        h = torch.relu(h)
    return (h.to(torch.bfloat16).float() @ w2.float()).to(x.dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", ATT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_version_matches_reference(B, Sq, Skv, H, KV, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Sq, Skv, H, KV, hd, 0), dtype)
    got = ops.attention(tq, tk, tv, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    got = got.float().numpy()
    kernel = r_fa.flash_attention(jq, jk, jv, block_q=128, block_k=128)
    _close(got, kernel, ATT_TOL[dtype])
    _close(got, r_ref.flash_attention_ref(jq, jk, jv), ATT_TOL[dtype])


@pytest.mark.parametrize("window,chunk", [(0, 0), (64, 0), (0, 128), (32, 0)])
def test_attention_masks_match_reference(window, chunk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 256, 256, 4, 2, 64, 1), "float32")
    got = fused_attention.flash_attention(tq, tk, tv, window=window, chunk=chunk)
    _close(got.numpy(), r_fa.flash_attention(jq, jk, jv, window=window, chunk=chunk),
           ATT_TOL["float32"])
    _close(got.numpy(), r_ref.flash_attention_ref(jq, jk, jv, window=window,
                                                  chunk=chunk), ATT_TOL["float32"])


@pytest.mark.parametrize("blocks", [(128, 128), (256, 128), (128, 256)])
def test_attention_is_block_invariant(blocks):
    bq, bk = blocks
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 256, 256, 2, 2, 64, 2), "float32")
    got = ops.attention(tq, tk, tv, block_q=bq, block_k=bk, device="cpu")
    _close(got.numpy(), r_fa.flash_attention(jq, jk, jv, block_q=bq, block_k=bk),
           ATT_TOL["float32"])


def test_attention_rows_masked_in_their_first_tile():
    # window 32 with 64-key tiles: rows 96.. see no key of the first tile,
    # which the reference's finite NEG_INF mask wipes out again
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 192, 192, 2, 1, 32, 3), "float32")
    got = fused_attention.flash_attention(tq, tk, tv, window=32)
    assert torch.isfinite(got).all()
    _close(got.numpy(), r_fa.flash_attention(jq, jk, jv, window=32, block_q=64,
                                             block_k=64), ATT_TOL["float32"])


K2_ROUNDING_CASES = [  # (B, Sq, Skv, H, KV, hd, window, chunk)
    (1, 128, 128, 4, 2, 128, 0, 0),   # head_dim 128, GQA 2:1
    (1, 64, 64, 16, 8, 64, 0, 0),     # qwen3's 16 query / 8 KV heads
    (1, 128, 256, 4, 1, 128, 0, 0),   # MQA, cross-length
    (1, 192, 192, 2, 1, 128, 32, 0),  # rows fully masked in their first tile
    (2, 128, 128, 4, 2, 64, 0, 64),   # chunked-local
]


@pytest.mark.parametrize("case", K2_ROUNDING_CASES, ids=str)
def test_attention_tensor_core_rounding_matches_reference(case):
    B, Sq, Skv, H, KV, hd, window, chunk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Sq, Skv, H, KV, hd, 6), "bfloat16")
    got = _k2_tensor_core(tq, tk, tv, window=window, chunk=chunk)
    assert torch.isfinite(got.float()).all()
    kernel = r_fa.flash_attention(jq, jk, jv, window=window, chunk=chunk,
                                  block_q=64, block_k=64)
    _close(got.float().numpy(), kernel, ATT_TOL["bfloat16"])
    _close(got.float().numpy(), r_ref.flash_attention_ref(jq, jk, jv, window=window,
                                                          chunk=chunk),
           ATT_TOL["bfloat16"])
    # the rounding of P is exercised: without it the outputs differ
    kept = _k2_tensor_core(tq, tk, tv, window=window, chunk=chunk, round_p=False)
    assert not torch.equal(got, kept)


@pytest.mark.parametrize("case", K2_ROUNDING_CASES, ids=str)
def test_attention_tensor_core_rounding_at_the_wgmma_tile(case):
    # the wgmma body's training tile takes 128 keys at a time: its online
    # softmax and P's rounding over those tiles against the Pallas kernel
    B, Sq, Skv, H, KV, hd, window, chunk = case
    assert hd in fused_attention.WGMMA_HEAD_DIMS
    bq, bk = fused_attention.DEFAULT_TILE
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Sq, Skv, H, KV, hd, 7), "bfloat16")
    got = _k2_tensor_core(tq, tk, tv, window=window, chunk=chunk, block_k=bk)
    assert torch.isfinite(got.float()).all()
    # the Pallas kernel takes blocks that divide the sequences
    kernel = r_fa.flash_attention(jq, jk, jv, window=window, chunk=chunk,
                                  block_q=bq if Sq % bq == 0 else 64,
                                  block_k=bk if Skv % bk == 0 else 64)
    _close(got.float().numpy(), kernel, ATT_TOL["bfloat16"])
    _close(got.float().numpy(), r_ref.flash_attention_ref(jq, jk, jv, window=window,
                                                          chunk=chunk),
           ATT_TOL["bfloat16"])


def test_attention_refuses_window_and_chunk_together():
    q, k, v = (torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 1, 32),
               torch.zeros(1, 8, 1, 32))
    with pytest.raises(ValueError, match="exclusive"):
        fused_attention.flash_attention(q, k, v, window=4, chunk=4)
    with pytest.raises(ValueError, match="multiple"):
        kv3 = torch.zeros(1, 8, 3, 32)
        fused_attention.flash_attention(q, kv3, kv3)


@pytest.mark.parametrize("T,d,ff,act", MLP_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_plain_version_matches_reference(T, d, ff, act, dtype):
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal((T, d), dtype=np.float32),
              rng.standard_normal((d, ff), dtype=np.float32) * np.float32(0.1),
              rng.standard_normal((ff, d), dtype=np.float32) * np.float32(0.1),
              rng.standard_normal((d, ff), dtype=np.float32) * np.float32(0.1))
    (jx, jw1, jw2, jw3), (tx, tw1, tw2, tw3) = _both(arrays, dtype)
    got = ops.mlp(tx, tw1, tw2, tw3, act=act, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, d)
    kernel = r_fm.fused_mlp(jx, jw1, jw2, jw3, act=act, block_m=128, block_f=128)
    _close(got.float().numpy(), kernel, MLP_TOL[dtype])
    _close(got.float().numpy(), r_ref.fused_mlp_ref(jx, jw1, jw2, jw3, act=act),
           MLP_TOL[dtype])


@pytest.mark.parametrize("T,d,ff,act", MLP_SHAPES)
def test_mlp_tensor_core_rounding_matches_reference(T, d, ff, act):
    rng = np.random.default_rng(7)
    arrays = (rng.standard_normal((T, d), dtype=np.float32),
              rng.standard_normal((d, ff), dtype=np.float32) * np.float32(0.1),
              rng.standard_normal((ff, d), dtype=np.float32) * np.float32(0.1),
              rng.standard_normal((d, ff), dtype=np.float32) * np.float32(0.1))
    (jx, jw1, jw2, jw3), (tx, tw1, tw2, tw3) = _both(arrays, "bfloat16")
    got = _k3_tensor_core(tx, tw1, tw2, tw3, act=act).float().numpy()
    kernel = r_fm.fused_mlp(jx, jw1, jw2, jw3, act=act, block_m=128, block_f=128)
    _close(got, kernel, MLP_TOL["bfloat16"])
    _close(got, r_ref.fused_mlp_ref(jx, jw1, jw2, jw3, act=act), MLP_TOL["bfloat16"])


@pytest.mark.parametrize("act", ["geglu", "gelu"])
def test_mlp_gelu_is_the_tanh_form(act):
    # inputs where erf-gelu and tanh-gelu differ by far more than the
    # tolerance: the plain version must follow jax.nn.gelu's tanh form
    rng = np.random.default_rng(5)
    arrays = (rng.standard_normal((16, 32), dtype=np.float32) * np.float32(0.5),
              rng.standard_normal((32, 64), dtype=np.float32),
              rng.standard_normal((64, 32), dtype=np.float32),
              rng.standard_normal((32, 64), dtype=np.float32))
    (jx, jw1, jw2, jw3), t = _both(arrays, "float32")
    got = fused_mlp.fused_mlp(*t, act=act).numpy()
    want = np.asarray(r_ref.fused_mlp_ref(jx, jw1, jw2, jw3, act=act))
    _close(got, want, MLP_TOL["float32"])
    x, w1, w2, w3 = t
    h = x @ w1
    erf = torch.nn.functional.gelu(h) * ((x @ w3) if act == "geglu" else 1.0)
    tol = MLP_TOL["float32"]
    assert not np.allclose((erf @ w2).numpy(), want, atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 2, 1, 32, 4))
    a0, m0 = fused_attention.flash_attention.launches, fused_mlp.fused_mlp.launches
    assert torch.equal(fused_attention.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
    x, w1, w2 = torch.ones(4, 8), torch.ones(8, 16), torch.ones(16, 8)
    assert torch.equal(fused_mlp.fused_mlp(x, w1, w2, act="relu"),
                       ref.fused_mlp_ref(x, w1, w2, act="relu"))
    assert fused_attention.flash_attention.launches == a0
    assert fused_mlp.fused_mlp.launches == m0


def test_mlp_wrapper_rejects_what_it_does_not_take():
    x, w1, w2 = torch.ones(4, 8), torch.ones(8, 16), torch.ones(16, 8)
    with pytest.raises(ValueError, match="unknown act"):
        fused_mlp.fused_mlp(x, w1, w2, act="tanh")
    with pytest.raises(ValueError, match="needs w3"):
        fused_mlp.fused_mlp(x, w1, w2, act="swiglu")
    with pytest.raises(ValueError, match="chain"):
        fused_mlp.fused_mlp(x, w1, w2[:8], act="relu")


@pytest.mark.parametrize("hd", fused_attention.HEAD_DIMS)
@pytest.mark.parametrize("tile", fused_attention.TILES)
def test_attention_tiles_fit_a_hopper_block(hd, tile):
    bq, bk = tile
    for dtype in (torch.bfloat16, torch.float32):
        assert fused_attention.smem_bytes(bq, bk, hd, dtype) <= SMEM_LIMIT
    # the planner sizes for the serving dtype, bf16
    assert fused_attention.smem_bytes(bq, bk, hd) == \
        fused_attention.smem_bytes(bq, bk, hd, torch.bfloat16)
    assert bq % 16 == 0 and bk % 16 == 0 and hd % 16 == 0
    assert fused_attention.DEFAULT_TILE in fused_attention.TILES
    assert fused_attention.SHORT_TILE in fused_attention.TILES
    if hd in fused_attention.WGMMA_HEAD_DIMS:
        # the wgmma body: 64-row warpgroups, S's wgmma N 64 or 128; the Q
        # tile, 3 stages (two warpgroups) or 2 (one) of K and V in unpadded
        # 128-byte-swizzled rows, the mbarriers, the alignment
        assert bq % 64 == 0 and bk in (64, 128)
        row = 2 * hd
        assert fused_attention.smem_bytes(bq, bk, hd) == (
            bq * row + (3 if bq == 128 else 2) * 2 * bk * row + 64 + 1024)
        long, short = fused_attention.LONG_KV, fused_attention.LONG_KV - 1
        assert fused_attention.default_tile(hd, torch.bfloat16, long) == \
            fused_attention.DEFAULT_TILE
        assert fused_attention.default_tile(hd, torch.bfloat16, short) == \
            fused_attention.SHORT_TILE
        assert fused_attention.default_tile(hd, torch.float32, long) == \
            fused_attention.SHORT_TILE
    else:
        assert fused_attention.default_tile(hd, torch.bfloat16, 1 << 20) == \
            fused_attention.SHORT_TILE


@pytest.mark.parametrize("hd", flash_attention_bwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_backward_fits_a_hopper_block(hd, dtype):
    # the larger of the dK/dV and dQ kernels' shared memory (the C library
    # reports the same number, checked when it loads) against the card's
    # opt-in limit: a layout that outgrows the card fails here, not at launch
    smem = flash_attention_bwd.smem_bytes(hd, dtype)
    assert 0 < smem <= arch.H100.smem_per_block_optin == SMEM_LIMIT
    assert flash_attention_bwd.smem_bytes(hd) == flash_attention_bwd.smem_bytes(
        hd, torch.bfloat16)
    if dtype == torch.bfloat16 and hd in flash_attention_bwd.WGMMA_HEAD_DIMS:
        # resident 128-row tiles, three 64-row stages of 128-byte-swizzled
        # rows, the mbarriers, the alignment
        row = 2 * hd
        assert smem == max(2 * 128 * row + 3 * (2 * 64 * row + 1024) + 64 + 1024,
                           2 * 128 * row + 3 * 2 * 64 * row + 64 + 1024)
    with pytest.raises(ValueError, match="not built"):
        flash_attention_bwd.smem_bytes(hd + 8, dtype)


@pytest.mark.parametrize("tile", fused_mlp.TILES)
def test_mlp_tiles_fit_a_hopper_block(tile):
    for dtype in (torch.bfloat16, torch.float32):
        assert fused_mlp.smem_bytes(*tile, dtype) <= SMEM_LIMIT
        assert fused_mlp.default_tile(8, dtype) in fused_mlp.TILES
        assert fused_mlp.default_tile(4096, dtype) in fused_mlp.TILES
        assert fused_mlp.default_tile(8, dtype)[0] == 16  # decode: 16-row tiles
    assert fused_mlp.smem_bytes(*tile) == fused_mlp.smem_bytes(*tile, torch.bfloat16)
    assert tile[0] % 16 == 0 and tile[1] % 16 == 0


def test_kernel_sources_name_what_they_replace_and_build_for_sm90a():
    for mod, fn in ((fused_attention, "fused_attention.py::flash_attention"),
                    (fused_mlp, "fused_mlp.py::fused_mlp")):
        assert f"src/repro/kernels/{fn}" in mod.SOURCE.read_text()
        assert "arch=compute_90a,code=sm_90a" in " ".join(mod.NVCC_FLAGS)
        assert mod.KERNEL.library_path().parent == mod.builder.BUILD_DIR
    src = fused_attention.SOURCE.read_text()
    for hd in fused_attention.HEAD_DIMS:
        for bq, bk in fused_attention.TILES:
            assert f"X({hd}, {bq}, {bk})" in src
    src = fused_mlp.SOURCE.read_text()
    for bm, bf in fused_mlp.TILES:
        assert f"X({bm}, {bf})" in src
    # the bf16 bodies: tensor-core products (mma.sync; wgmma for K3's
    # prefill tiles), cp.async tiles, a shared header that is part of each
    # library's build hash
    header = fused_attention.CSRC / "mma_bf16.cuh"
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header.read_text()
    assert "cp.async.cg.shared.global" in header.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in header.read_text()
    assert "fused_mlp_mma_prefill_kernel" in fused_mlp.SOURCE.read_text()
    for mod in (fused_attention, fused_mlp):
        assert '#include "mma_bf16.cuh"' in mod.SOURCE.read_text()
        assert header in mod.KERNEL.headers


def test_attention_forward_and_backward_share_one_copy_of_the_tma_helpers():
    # the TMA, mbarrier and wgmma-descriptor helpers and the host's
    # tensor-map encoder live in one header, part of both libraries' build
    # hashes; neither source defines its own
    header = fused_attention.CSRC / "tma_wgmma.cuh"
    text = header.read_text()
    for helper in ("mbar_init", "mbar_expect", "mbar_wait", "tma_tile", "desc_kmajor",
                   "desc_mnmajor", "aligned_smem", "tensor_map", "cuTensorMapEncodeTiled"):
        assert helper in text
    for mod in (fused_attention, flash_attention_bwd):
        src = mod.SOURCE.read_text()
        assert '#include "tma_wgmma.cuh"' in src and header in mod.KERNEL.headers
        assert "cp.async.bulk.tensor" not in src and "mbarrier.init" not in src
        assert "typedef CUresult (*EncodeTiled)" not in src
    # K2's forward at head dims 64 and 128 is the wgmma body, with the
    # producer's empty/full ring
    src = fused_attention.SOURCE.read_text()
    assert "flash_attention_wgmma_kernel" in src and "mbar_arrive(empty" in src
    assert fused_attention.WGMMA_HEAD_DIMS == flash_attention_bwd.WGMMA_HEAD_DIMS
