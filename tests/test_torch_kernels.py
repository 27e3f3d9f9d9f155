"""The port's fused conv3x3 group (K1) on the CPU, against the JAX package.

On a CPU tensor the wrapper takes the group's plain PyTorch version; here it
is held against the reference's oracle (``repro.kernels.ref``) and its
Pallas kernel in interpret mode, at the shapes and tolerances of
tests/test_kernels.py.  The CUDA kernel itself runs only on the card
(tests/test_torch_on_card.py and chip_smoke.py).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fused_conv as r_fused_conv  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.core.ir import VGG16_CONV_PLAN  # noqa: E402
from repro_torch.kernels import fused_conv, ops, ref  # noqa: E402

# tests/test_kernels.py checks conv at 10x its TOLS (f32 2e-5, bf16 2e-2):
# float32 sums are taken in another order than XLA's, and bfloat16 results
# round from float32 sums that may differ in their last bits.
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
SHAPES = [  # (B, H, W, Cin, Cout, pool), those of tests/test_kernels.py
    (1, 8, 8, 4, 8, False),
    (2, 16, 16, 8, 16, True),
    (1, 32, 32, 3, 8, True),
    (2, 8, 8, 16, 32, False),
]
SMEM_LIMIT = 232_448  # shared memory one Hopper block may opt in to


def _inputs(B, H, W, Cin, Cout, seed=4):
    """float32 numpy inputs scaled as the reference test scales them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, Cin, Cout), dtype=np.float32) * 0.2)
    b = rng.standard_normal((Cout,), dtype=np.float32)
    return x, w, b


@pytest.mark.parametrize("B,H,W,Cin,Cout,pool", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference(B, H, W, Cin, Cout, pool, dtype):
    x, w, b = _inputs(B, H, W, Cin, Cout)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, w, b))
    got = ops.conv3x3(tx, tw, tb, pool=pool, device="cpu")
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    oracle = np.asarray(r_ref.fused_conv3x3_ref(jx, jw, jb, pool=pool),
                        np.float32)
    kernel = np.asarray(r_fused_conv.fused_conv3x3(
        jx, jw, jb, pool=pool, block_c=min(8, Cout), interpret=True),
        np.float32)
    assert got.shape == oracle.shape == kernel.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, kernel, atol=tol, rtol=tol)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 6, 6, 3, 8))
    before = fused_conv.fused_conv3x3.launches
    got = fused_conv.fused_conv3x3(x, w, b, pool=True)
    assert fused_conv.fused_conv3x3.launches == before
    assert torch.equal(got, ref.fused_conv3x3_ref(x, w, b, pool=True))
    assert got.shape == (1, 3, 3, 8) and got.is_contiguous()


def test_conv3x3_refuses_a_tensor_on_another_device():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 3, 8))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="was given a tensor on cpu"):
            ops.conv3x3(x, w, b)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ops.conv3x3(x, w, b)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ops.fused_conv_fn()


@pytest.mark.parametrize("name,n_in,n_out,hw,pooled", VGG16_CONV_PLAN,
                         ids=[p[0] for p in VGG16_CONV_PLAN])
def test_launch_geometry_fits_hopper_at_every_vgg_layer(name, n_in, n_out,
                                                        hw, pooled):
    geo = fused_conv.launch_geometry(8, hw, hw, n_in, n_out)
    assert geo.smem_bytes == fused_conv.smem_bytes() <= SMEM_LIMIT
    assert geo.threads <= 1024 and geo.threads % 32 == 0
    tiles_h = geo.grid[0] // geo.tiles_w
    # every output pixel and channel is covered, and tiles are even, so no
    # 2x2 pool window straddles two blocks
    assert tiles_h * fused_conv.TILE_H >= hw and geo.tiles_w * fused_conv.TILE_W >= hw
    assert fused_conv.TILE_H % 2 == 0 and fused_conv.TILE_W % 2 == 0
    assert geo.grid[1] * fused_conv.BLOCK_C >= n_out and geo.grid[2] == 8


def test_smem_bytes_counts_the_staged_tiles():
    # haloed input tile + weight slice, float32
    assert fused_conv.smem_bytes(16, 16, 8, 64) == (18 * 18 * 8 + 9 * 8 * 64) * 4
    assert fused_conv.smem_bytes() < 48 * 1024  # no opt-in needed at the default


@pytest.mark.parametrize("bad,exc", [
    ("x3d", ValueError), ("w_cin", ValueError), ("b_len", ValueError),
    ("dtype", TypeError), ("f16", TypeError), ("strided", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 8))
    if bad == "x3d":
        x = x[0]
    elif bad == "w_cin":
        w = w[:, :, :3]
    elif bad == "b_len":
        b = b[:4]
    elif bad == "dtype":
        w = w.double()
    elif bad == "f16":
        x, w, b = x.half(), w.half(), b.half()
    elif bad == "strided":
        x = x.transpose(1, 2)
    with pytest.raises(exc):
        fused_conv._check(x, w, b)


def test_plain_version_keeps_tf32_off_and_restores_it():
    prev = torch.backends.cudnn.allow_tf32
    with ref.no_tf32():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev


def test_plain_version_pools_odd_frames_like_a_valid_window():
    x, w, b = _inputs(1, 7, 5, 3, 4)
    got = ref.fused_conv3x3_ref(*(torch.from_numpy(a) for a in (x, w, b)),
                                pool=True).numpy()
    want = np.asarray(r_ref.fused_conv3x3_ref(
        *(jnp.asarray(a) for a in (x, w, b)), pool=True))
    assert got.shape == want.shape == (1, 3, 2, 4)
    np.testing.assert_allclose(got, want, atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_build_flags_carry_every_tile_constant():
    flags = " ".join(fused_conv.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name, value in (("TILE_H", fused_conv.TILE_H),
                        ("TILE_W", fused_conv.TILE_W),
                        ("CIN_CHUNK", fused_conv.CIN_CHUNK),
                        ("BLOCK_C", fused_conv.BLOCK_C),
                        ("CPT", fused_conv.CHANNELS_PER_THREAD)):
        assert f"-D{name}={value}" in flags
    src = fused_conv.SOURCE.read_text()
    assert "src/repro/kernels/fused_conv.py::fused_conv3x3" in src
    assert fused_conv.BUILD_DIR.parts[-2:] == ("build", "kernels")
