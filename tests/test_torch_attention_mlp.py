"""The port's flash attention (K2) and fused MLP (K3) on the CPU, against
the JAX package.

On a CPU tensor each wrapper takes its kernel's plain PyTorch version;
here that is held against the reference's Pallas kernel in interpret mode
and its oracle (``repro.kernels.ref``), at the shapes and tolerances of
tests/test_kernels.py.  The CUDA kernels themselves run only on the card
(tests/test_torch_on_card.py and chip_smoke.py).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fused_attention as r_fa  # noqa: E402
from repro.kernels import fused_mlp as r_fm  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.kernels import fused_attention, fused_mlp, ops, ref  # noqa: E402

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
    assert fused_attention.smem_bytes(bq, bk, hd) <= SMEM_LIMIT
    assert bq % 16 == 0 and bk % 16 == 0 and hd % 16 == 0


@pytest.mark.parametrize("tile", fused_mlp.TILES)
def test_mlp_tiles_fit_a_hopper_block(tile):
    assert fused_mlp.smem_bytes(*tile) <= SMEM_LIMIT
    assert fused_mlp.default_tile(8) in fused_mlp.TILES
    assert fused_mlp.default_tile(4096) in fused_mlp.TILES


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
