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
    assert geo.tile in fused_conv.TILES and geo.tile % 2 == 0
    assert geo.smem_bytes == fused_conv.smem_bytes(geo.tile) <= SMEM_LIMIT
    assert geo.threads == fused_conv.threads(geo.tile)
    assert geo.threads <= 1024 and geo.threads % 32 == 0
    # a block for every SM of the card at batch 8; 14x14 takes the small
    # tile, and so does 56x56, which it covers without padding (tile 16
    # would compute 64x64)
    assert geo.grid[0] * geo.grid[1] * geo.grid[2] >= fused_conv.SM_COUNT == 132
    assert geo.tile == (fused_conv.TILES[-1] if hw in (14, 56) else fused_conv.TILES[0])
    assert -(-hw // geo.tile) * geo.tile == (32 if hw == 28 else 16 if hw == 14 else hw)
    tiles_h = geo.grid[0] // geo.tiles_w
    # every output pixel and channel is covered, and tiles are even, so no
    # 2x2 pool window straddles two blocks
    assert tiles_h * geo.tile >= hw and geo.tiles_w * geo.tile >= hw
    assert geo.grid[1] * fused_conv.BLOCK_C >= n_out and geo.grid[2] == 8


def test_smem_bytes_counts_the_staged_tiles():
    f32, bf16 = torch.float32, torch.bfloat16
    # float32 (wgmma): stages x (the raw haloed tile, 8 channels of 4 bytes a
    # pixel, + the chunk's weights as two tf32 planes of 9 taps x 8 x 64),
    # + each consumer warpgroup's big and small planes of its 10 halo rows
    # for two chunks, + 64 for the mbarriers and 1024 to align the start
    weights = 2 * 9 * 8 * 64 * 4
    assert fused_conv.smem_bytes(16) == (3 * (18 * 18 * 32 + weights)
                                         + 2 * (2 * 2 * 10 * 18 * 32) + 64 + 1024)
    assert fused_conv.smem_bytes(8) == (2 * (10 * 10 * 32 + weights)
                                        + 1 * (2 * 2 * 10 * 10 * 32) + 64 + 1024)
    # bfloat16 (mma.sync): STAGES x (haloed input tile, a 32-byte chunk + 16
    # bytes of pad a pixel, + the weight slice: 9 taps x 32 bytes of
    # channels x (64 + 8) outputs)
    assert fused_conv.smem_bytes(16, bf16) == 3 * (18 * 18 * 48 + 9 * 32 * 72)
    assert fused_conv.smem_bytes(8, bf16) == 3 * (10 * 10 * 48 + 9 * 32 * 72)
    assert fused_conv.smem_bytes() == fused_conv.smem_bytes(fused_conv.TILES[0], f32)
    # a chunk is one k-step: 8 float32 (wgmma tf32 k8) or 16 bfloat16
    # (mma.sync m16n8k16) channels
    assert fused_conv.cin_chunk(f32) == 8
    assert fused_conv.cin_chunk(bf16) == 16
    # above the 48 KB default: the kernel opts in, once per device; two
    # float32 blocks of the small tile share an SM's 228 KB (1 KB each kept)
    assert all(48 * 1024 < fused_conv.smem_bytes(t, d) <= SMEM_LIMIT
               for t in fused_conv.TILES for d in (f32, bf16))
    assert 2 * (fused_conv.smem_bytes(fused_conv.TILES[1]) + 1024) <= 228 * 1024
    # a consumer warpgroup per 8 tile rows and the producer warp
    assert [fused_conv.threads(t) for t in fused_conv.TILES] == [2 * 128 + 32, 128 + 32]


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
    for name, value in (("BLOCK_C", fused_conv.BLOCK_C),
                        ("CHUNK_BYTES", fused_conv.CHUNK_BYTES),
                        ("STAGES", fused_conv.STAGES),
                        ("F32_STAGES_BIG", fused_conv.F32_STAGES[fused_conv.TILES[0]]),
                        ("F32_STAGES_SMALL", fused_conv.F32_STAGES[fused_conv.TILES[1]]),
                        ("TILE_BIG", fused_conv.TILES[0]),
                        ("TILE_SMALL", fused_conv.TILES[1])):
        assert f"-D{name}={value}" in flags
    src = fused_conv.SOURCE.read_text()
    assert "src/repro/kernels/fused_conv.py::fused_conv3x3" in src
    # the tensor-core and TMA helpers are part of the build hash
    assert [h.name for h in fused_conv.KERNEL.headers] == ["mma_bf16.cuh", "tma_wgmma.cuh"]
    assert '#include "mma_bf16.cuh"' in src and '#include "tma_wgmma.cuh"' in src
    assert fused_conv.BUILD_DIR.parts[-2:] == ("build", "kernels")


# ---------------------------------------------------------------------------
# The tensor-core design, on the CPU: the 3xTF32 arithmetic and the
# sub-pixel-major row order
# ---------------------------------------------------------------------------


def _tf32(v: np.ndarray) -> np.ndarray:
    """float32 rounded to tf32 as ``cvt.rna.tf32.f32`` and the kernel's
    ``mma::tf32_rna`` do: 10 stored mantissa bits, to nearest, ties away
    from zero (half an ulp added to the magnitude bits, then cut)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _conv_tf32(x, w, b, *, pool, passes):
    """The kernel's float32 arithmetic emulated: operands split into tf32
    big + small, per chunk of 8 input channels and per tap one m16n8k8 step
    of ``passes`` products (3: small*big, big*small, big*big, in that order;
    1: big*big alone, single-pass TF32), each product's k8 sum added to the
    chunk's float32 partial and the partial to the accumulator, in the
    kernel's K order (rounding to nearest throughout: the tensor cores'
    truncating sums are not emulated); then bias, ReLU, pool."""
    B, H, W, Cin = x.shape
    kc = fused_conv.cin_chunk(torch.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    xb, wb = _tf32(xp), _tf32(w)
    xs, ws = _tf32(xp - xb), _tf32(w - wb)
    acc = torch.zeros((B, H, W, w.shape[-1]), dtype=torch.float32)
    for c0 in range(0, Cin, kc):
        part = torch.zeros_like(acc)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            rows = (slice(None), slice(dy, dy + H), slice(dx, dx + W), slice(c0, c0 + kc))
            a_big, a_small = torch.from_numpy(xb[rows]), torch.from_numpy(xs[rows])
            b_big = torch.from_numpy(wb[dy, dx, c0:c0 + kc])
            b_small = torch.from_numpy(ws[dy, dx, c0:c0 + kc])
            if passes == 3:
                part += a_small @ b_big
                part += a_big @ b_small
            part += a_big @ b_big
        acc += part
    y = torch.relu(acc + torch.from_numpy(b))
    if pool:
        y = torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return y.numpy()


def _pallas(x, w, b, pool):
    return np.asarray(r_fused_conv.fused_conv3x3(
        *(jnp.asarray(a) for a in (x, w, b)), pool=pool,
        block_c=min(64, w.shape[-1]), interpret=True), np.float32)


VGG_LIKE = (1, 14, 14, 512, 512, True)  # conv5_3 of VGG-16 at batch 1


@pytest.mark.parametrize("B,H,W,Cin,Cout,pool", SHAPES + [VGG_LIKE],
                         ids=[str(s) for s in SHAPES + [VGG_LIKE]])
def test_3xtf32_arithmetic_matches_the_pallas_kernel(B, H, W, Cin, Cout, pool):
    x, w, b = _inputs(B, H, W, Cin, Cout)
    got = _conv_tf32(x, w, b, pool=pool, passes=3)
    want = _pallas(x, w, b, pool)
    tol = TOL["float32"]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_single_pass_tf32_misses_the_float32_tolerance():
    # why the kernel takes three products: one tf32 product a step rounds
    # each operand to 11 significant bits, and over K = 4,608 that misses
    # the tolerance the 3xTF32 arithmetic meets on the same inputs
    x, w, b = _inputs(*VGG_LIKE[:5])
    want = _pallas(x, w, b, True)
    tol = TOL["float32"]
    one = np.abs(_conv_tf32(x, w, b, pool=True, passes=1) - want)
    three = np.abs(_conv_tf32(x, w, b, pool=True, passes=3) - want)
    assert (one > tol + tol * np.abs(want)).any()
    assert not (three > tol + tol * np.abs(want)).any()
    assert three.max() < one.max() / 100


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # of a tf32 value in [1, 2)
    v = np.array([1.0, 1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                  1 + 0.75 * one_ulp], np.float32)
    assert _tf32(v).tolist() == [1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp]
    big = _tf32(v)
    small = _tf32(v - big)
    assert np.all(np.abs(v - big - small) <= 2.0 ** -22 * np.abs(v))


def _window_rows(tile: int, dtype) -> list:
    """The GEMM rows of each 2x2 window as one store of the kernel's pooled
    epilogue sees them, in the accumulator layout of its tensor-core
    instruction (lane 4 g + t of warp w holds rows g and g + 8 of the
    warp's 16).  bfloat16: one lane, rows g or g + 8 of the four m16 tiles
    (sub-pixels).  float32: rows 16 w + g and + 8 of an m64 tile in lane g
    (g even) and the same rows + 1 in lane g + 1, a shuffle away."""
    groups = []
    if dtype == torch.float32:
        for m64 in range(tile * tile // 64):
            for w in range(4):
                for g in range(0, 8, 2):
                    base = m64 * 64 + 16 * w
                    groups.append([base + g, base + g + 1, base + g + 8, base + g + 9])
    else:
        for warp in range(tile * tile // 64):
            for g in range(8):
                for r in (g, g + 8):
                    groups.append([warp * 64 + mt * 16 + r for mt in range(4)])
    return groups


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", fused_conv.TILES)
def test_gemm_rows_map_one_to_one_and_lanes_hold_whole_windows(tile, dtype):
    rows = [fused_conv.gemm_row_pixel(tile, m, dtype) for m in range(tile * tile)]
    assert sorted(rows) == [(h, w) for h in range(tile) for w in range(tile)]
    if dtype == torch.float32:  # a consumer warpgroup per 8 tile rows, + the producer warp
        assert tile // 8 * 128 + 32 == fused_conv.threads(tile, dtype)
        # an m64 tile is 8 x 8 pixels in raster order: its 8-row groups are
        # eight pixels of one tile row, so a tap's shift is a start address
        for m in range(0, tile * tile, 8):
            h, w = rows[m]
            assert rows[m:m + 8] == [(h, w + i) for i in range(8)] and w % 8 == 0
    else:  # 2 warps a 64 rows
        assert tile * tile // 64 * 32 * 2 == fused_conv.threads(tile, dtype)
    for group in _window_rows(tile, dtype):
        px = [rows[m] for m in group]
        h, w = min(px)
        assert h % 2 == 0 and w % 2 == 0
        assert sorted(px) == [(h, w), (h, w + 1), (h + 1, w), (h + 1, w + 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W", [(2, 7, 9), (1, 14, 14), (3, 30, 18)])
def test_gemm_rows_cover_a_frame_once_and_every_pool_window_in_one_lane(B, H, W, dtype):
    # float32: "one lane" is the lane pair joined by one shuffle
    geo = fused_conv.launch_geometry(B, H, W, 3, 8, dtype)
    tile = geo.tile
    stored, pooled = [], {}
    for n in range(geo.grid[2]):
        for t in range(geo.grid[0]):
            h0, w0 = t // geo.tiles_w * tile, t % geo.tiles_w * tile
            for m in range(tile * tile):
                h, w = fused_conv.gemm_row_pixel(tile, m, dtype)
                if h0 + h < H and w0 + w < W:  # the kernel's store mask
                    stored.append((n, h0 + h, w0 + w))
            for group in _window_rows(tile, dtype):
                px = [fused_conv.gemm_row_pixel(tile, m, dtype) for m in group]
                ph, pw = (h0 + min(px)[0]) // 2, (w0 + min(px)[1]) // 2
                if ph < H // 2 and pw < W // 2:  # the pooled store mask
                    assert (n, ph, pw) not in pooled
                    pooled[n, ph, pw] = {(h0 + h, w0 + w) for h, w in px}
    assert sorted(stored) == [(n, h, w) for n in range(B) for h in range(H) for w in range(W)]
    assert sorted(pooled) == [(n, i, j) for n in range(B) for i in range(H // 2)
                              for j in range(W // 2)]
    for (n, i, j), px in pooled.items():
        assert px == {(2 * i + a, 2 * j + c) for a in (0, 1) for c in (0, 1)}


def test_unaligned_or_ragged_rows_are_staged_element_by_element():
    x, w, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 64, 64))
    assert fused_conv.vectorised(x, w)
    assert fused_conv.vectorised(x.bfloat16(), w.bfloat16())
    assert not fused_conv.vectorised(x[..., :3].contiguous(), w[:, :, :3].contiguous())
    assert not fused_conv.vectorised(x[..., :4].bfloat16().contiguous(), w.bfloat16())
    flat = torch.empty(x.numel() + 1)
    assert not fused_conv.vectorised(flat[1:].view(x.shape), w)


# ---------------------------------------------------------------------------
# The float32 body on wgmma, on the CPU: the weight preparation, the input
# staging and the summation of the products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(3, 64), (5, 72), (64, 128), (16, 8)])
def test_weight_prep_is_k_major_big_and_small_planes_bit_for_bit(cin, cout):
    # the prep kernel's plain version against the tf32 split of the HWIO
    # weights, element by element: piece (nb, chunk), plane, tap, k half,
    # channel, k, zero past Cin and Cout
    w = (np.random.default_rng(cin * 100 + cout).standard_normal((3, 3, cin, cout))
         .astype(np.float32))
    got = fused_conv.prep_weights(torch.from_numpy(w)).numpy()
    assert torch.equal(fused_conv.prep_weights_ref(torch.from_numpy(w)), torch.from_numpy(got))
    nc, nbs = -(-cin // 8), -(-cout // 64)
    assert got.size == fused_conv.prep_floats(cin, cout) == nbs * nc * 2 * 9 * 2 * 64 * 4
    big = _tf32(w)
    planes = {0: big, 1: _tf32(w - big)}
    nb, chunk, plane, tap, kh, nn, e = np.unravel_index(np.arange(got.size),
                                                         (nbs, nc, 2, 9, 2, 64, 4))
    ci, co = 8 * chunk + 4 * kh + e, 64 * nb + nn
    inside = (ci < cin) & (co < cout)
    want = np.zeros(got.size, np.float32)
    for p, v in planes.items():
        sel = inside & (plane == p)
        want[sel] = v[tap[sel] // 3, tap[sel] % 3, ci[sel], co[sel]]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the torch rounding is the numpy one
    v = np.concatenate([w.ravel(), np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0])])
    assert np.array_equal(fused_conv.tf32_round(torch.from_numpy(v)).numpy().view(np.uint32),
                          _tf32(v).view(np.uint32))


def test_float32_inputs_the_tma_map_cannot_take_go_through_the_staged_copy():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 6, 6, 16, 8))
    assert fused_conv.tma_ready(x)
    flat = torch.empty(x.numel() + 1)
    assert not fused_conv.tma_ready(flat[1:].view(x.shape))  # 4 bytes off
    x3 = x[..., :3].contiguous()
    assert not fused_conv.tma_ready(x3)  # VGG's Cin = 3: rows of 12 bytes
    staged = fused_conv.staged_input(x3)
    assert staged.shape == (1, 6, 6, 8) and fused_conv.tma_ready(staged)
    assert torch.equal(staged[..., :3], x3) and not staged[..., 3:].any()
    # channels past Cin meet zero weights: the same conv
    w3 = w[:, :, :3].contiguous()
    w8 = torch.zeros(3, 3, 8, 8)
    w8[:, :, :3] = w3
    torch.testing.assert_close(ref.fused_conv3x3_ref(staged, w8, b, pool=True),
                               ref.fused_conv3x3_ref(x3, w3, b, pool=True))


def _truncate32(d: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero, as the tensor cores round
    the sums they accumulate."""
    r = d.astype(np.float32)
    return np.where(np.abs(r.astype(np.float64)) > np.abs(d),
                    np.nextafter(r, np.float32(0)), r)


def _wgmma_sums(x, w, *, chunk: int, partials: bool):
    """The float32 body's sums (before bias, ReLU and pool) emulated: the
    operands split into tf32 big + small; per chunk of ``chunk`` input
    channels and per tap three k-steps (small*big, big*small, big*big), each
    an exact sum of its products added to the accumulator and truncated to
    float32, as one wgmma does.  With ``partials`` each chunk sums into a
    zeroed partial that a float32 add (to nearest) folds into the sum, as
    the kernel does; without, every step truncates into one accumulator over
    all of K.  Returns (the float32 sums, the same products summed exactly
    in float64)."""
    B, H, W, Cin = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    xb = _tf32(xp)
    xs = _tf32(xp - xb)
    wb = _tf32(w)
    ws = _tf32(w - wb)
    acc = np.zeros((B * H * W, w.shape[-1]), np.float32)
    exact = np.zeros(acc.shape)
    for c0 in range(0, Cin, chunk):
        part = np.zeros_like(acc) if partials else acc
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            win = (slice(None), slice(dy, dy + H), slice(dx, dx + W), slice(c0, c0 + chunk))
            a_big = xb[win].reshape(-1, chunk).astype(np.float64)
            a_small = xs[win].reshape(-1, chunk).astype(np.float64)
            b_big = wb[dy, dx, c0:c0 + chunk].astype(np.float64)
            b_small = ws[dy, dx, c0:c0 + chunk].astype(np.float64)
            for a, bm in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                step = a @ bm
                exact += step
                part[:] = _truncate32(part + step)
        if partials:
            acc += part
    return acc.reshape(B, H, W, -1), exact.reshape(B, H, W, -1)


def _bias_relu_pool(s, b):
    y = torch.relu(torch.from_numpy(s) + torch.from_numpy(b))
    return torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def vgg_depth_sums():
    # conv5_3 of VGG-16 at batch 1: K = 9 x 512 = 4,608, 64 chunks of 8
    x, w, b = _inputs(*VGG_LIKE[:5])
    chunked = _wgmma_sums(x, w, chunk=fused_conv.cin_chunk(torch.float32), partials=True)
    straight = _wgmma_sums(x, w, chunk=fused_conv.cin_chunk(torch.float32), partials=False)
    return x, w, b, chunked, straight, _pallas(x, w, b, True)


def test_chunked_partials_keep_the_truncation_inside_the_float32_tolerance(vgg_depth_sums):
    # the kernel's summation, held to the Pallas kernel at conv5_3 depth
    _x, _w, b, (sums, exact), _straight, want = vgg_depth_sums
    tol = TOL["float32"]
    got = _bias_relu_pool(sums, b)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # truncation leans toward zero, but a chunk's partial is small: the
    # error stays a few hundred times below the tolerance's scale
    err = sums - exact
    assert np.abs(err).max() < tol / 2
    assert (err * np.sign(exact)).mean() < 0


def test_one_truncating_accumulator_over_all_of_k_misses_the_tolerance(vgg_depth_sums):
    # why the kernel folds a partial a chunk: the same products truncated
    # straight into one accumulator carry an error that grows with the
    # running sum, leans toward zero and leaves the float32 tolerance
    _x, _w, b, (sums, exact), (straight, _), want = vgg_depth_sums
    tol = TOL["float32"]
    err_c, err_s = sums - exact, straight - exact
    assert np.abs(err_s).mean() > 20 * np.abs(err_c).mean()
    assert (err_s * np.sign(exact)).mean() < -0.75 * np.abs(err_s).mean()  # toward zero
    assert (np.abs(err_s) > tol + tol * np.abs(exact)).any()
    got = _bias_relu_pool(straight, b)
    assert (np.abs(got - want) > tol + tol * np.abs(want)).any()
