"""Fused MLP (K3): ``act(x @ w1) [* (x @ w3)] @ w2`` in one kernel.

The fusion group of the transformer's feed-forward: the (T, d_ff) hidden
activation never reaches device memory.  The Pallas kernel keeps a
(block_m, d) accumulator across a sequential d_ff loop, which does not fit
a Hopper block; the CUDA kernel ``csrc/fused_mlp.cu`` splits d_ff across
blocks instead and adds their partial products into a float32 (T, d)
buffer with atomics (its head comment gives the design, the FLOP and byte
cost, and why float32 results may differ between runs in their last bits).
bfloat16 runs on the tensor cores (``wgmma`` for the prefill tiles,
warp-level ``mma.sync`` for the decode tiles; tiles streamed by
``cp.async``, the hidden tile kept in registers and rounded to bf16 before
the second product, float4 atomics); float32 runs on the CUDA cores, since
TF32 would miss the float32 tolerance.  It is built by
:mod:`repro_torch.kernels.builder` at its first launch and loaded with
``ctypes``, for the (block_m, block_f) tiles :data:`TILES`: two 16-row
decode tiles and two prefill tiles.

:func:`fused_mlp` is the wrapper: a CPU tensor goes to the plain PyTorch
version (:func:`repro_torch.kernels.ref.fused_mlp_ref`), a CUDA tensor
launches the kernel or raises.  ``fused_mlp.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..device import refuse_autograd
from . import builder, ref

ACTS = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu": 3}
GATED = ("swiglu", "geglu")
TILES = ((16, 16), (16, 32), (64, 128), (128, 256))  # (block_m, block_f)
ALIGN = 16  # bytes: the bf16 body copies rows in 16-byte cp.async chunks
# float32 body (csrc F32Tiles): d slice staged per step of the first
# products, hidden units per step of the second, output columns per pass
DK, FK, BN = 32, 32, 128

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_mlp.cu"
NVCC_FLAGS = builder.BASE_FLAGS
KERNEL = builder.KernelSource("fused_mlp", SOURCE, NVCC_FLAGS,
                              (CSRC / "mma_bf16.cuh",))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mma_smem_bytes(block_m: int, block_f: int) -> int:
    """csrc DecodeTiles / PrefillTiles: a ring of 4 (or 3) stages, each the
    larger of the (x, w1, w3) slices of the first products and the w2 slice
    of the second.  Decode tiles (8 warps split d; rows padded by 8
    elements) add the float32 split-d partials; prefill tiles (wgmma, 64
    d-rows a stage, passes of 128 hidden units, 64 output columns a slice,
    x and the weights in 128-byte-swizzled layouts) add 1024 bytes of
    alignment slack."""
    if block_m == 16:  # 8 warps, each 16 d-rows a stage and 32 output columns
        kt, nc = 16 * 8, 32 * 8
        p1 = block_m * (kt + 8) + 2 * kt * (block_f + 8)
        p2 = block_f * (nc + 8)
        stage, extra = 2 * max(p1, p2), 8 * block_f * 32 * 4
        return (4 if 4 * stage + extra <= 200 * 1024 else 3) * stage + extra
    return 4 * 2 * max(block_m * 64 + 2 * 64 * 128, block_f * 64) + 1024


def smem_bytes(block_m: int, block_f: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one block stages (bytes) — the Hopper counterpart of
    the reference kernel's ``vmem_bytes``; independent of d and d_ff, both
    are streamed.  bfloat16 (the serving dtype, the default): the ring of
    ``cp.async`` stages (and split-d partials), :func:`_mma_smem_bytes`.
    float32: the x / w1 / w3 slices of the first products (the w2 slice of
    the second reuses them) and the (block_m, block_f + 1) hidden tile."""
    if dtype == torch.bfloat16:
        return _mma_smem_bytes(block_m, block_f)
    if dtype == torch.float32:
        stage = max(block_m * DK + 2 * DK * block_f, FK * BN)
        return (stage + block_m * (block_f + 1)) * 4
    raise TypeError(f"fused_mlp is built for float32 and bfloat16, not {dtype}")


def default_tile(n_rows: int, dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """The tile for ``n_rows`` rows: a 16-row decode tile for decode-sized
    calls (few wasted rows, enough blocks to stream the weights on every
    SM), else a prefill tile."""
    if n_rows <= 16:
        return (16, 32)
    return (128, 256) if dtype == torch.bfloat16 else (64, 128)


def build() -> builder.BuildResult:
    """Compile ``csrc/fused_mlp.cu`` into ``build/kernels/``."""
    return builder.build(KERNEL)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures; its
    shared-memory sizes are checked against :func:`smem_bytes`."""
    lib = builder.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.fused_mlp_launch.restype = i32
    lib.fused_mlp_smem_bytes.argtypes = [i32, i32, i32]
    lib.fused_mlp_smem_bytes.restype = i32
    for dtype, code in _DTYPES.items():
        for bm, bf in TILES:
            built = lib.fused_mlp_smem_bytes(bm, bf, code)
            want = smem_bytes(bm, bf, dtype)
            if built != want:
                raise RuntimeError(f"{SOURCE.name} stages {built} bytes at tile "
                                   f"{bm}x{bf}, {dtype}; smem_bytes says {want}")
    return lib


def _check_args(x, w1, w2, w3, act: str) -> None:
    """Shapes and activations both versions take."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (one of {tuple(ACTS)})")
    if x.dim() < 1 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x must be (..., d), w1 (d, ff), w2 (ff, d)")
    d, ff = w1.shape
    if x.shape[-1] != d or tuple(w2.shape) != (ff, d):
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)} and w2 "
                         f"{tuple(w2.shape)} do not chain")
    if act in GATED and (w3 is None or w3.shape != w1.shape):
        raise ValueError(f"{act} needs w3 shaped like w1 {tuple(w1.shape)}")


def _check_cuda(x, ws, block_m: int, block_f: int) -> None:
    """Reject what the kernel does not take."""
    if (block_m, block_f) not in TILES:
        raise ValueError(f"tile {block_m}x{block_f} is not built (built: {TILES})")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"x and the weights must share float32 or bfloat16, "
                        f"got {x.dtype}, {[w.dtype for w in ws]}")
    if any(w.device != x.device for w in ws):
        raise ValueError("x and the weights must lie on one device")
    for t in (x, *ws):
        if not t.is_contiguous():
            raise ValueError("x and the weights must be contiguous")
    if x.dtype == torch.bfloat16:
        d, ff = ws[0].shape
        if d % 8 or ff % 8:
            raise ValueError(f"bfloat16 d ({d}) and d_ff ({ff}) must be multiples "
                             "of 8 (16-byte rows)")
        if any(t.data_ptr() % ALIGN for t in (x, *ws)):
            raise ValueError(f"bfloat16 x and weights must be {ALIGN}-byte aligned")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              w3: torch.Tensor | None = None, *, act: str = "swiglu",
              block_m: int | None = None,
              block_f: int | None = None) -> torch.Tensor:
    """``act(x @ w1) [* (x @ w3)] @ w2`` for ``x`` (..., d), in float32,
    the result in ``x.dtype`` and ``x``'s shape; acts swiglu, geglu (gated,
    need ``w3``), gelu (tanh form, as ``jax.nn.gelu``) and relu.  The kernel
    takes the T rows of ``x``; the plain version any leading shape.

    A CPU tensor takes the plain version (tiles ignored); a CUDA tensor
    launches the kernel (counted in ``fused_mlp.launches``) at the tile
    ``block_m`` x ``block_f`` (default :func:`default_tile`) or raises --
    also when one requires grad with grad mode on: the kernel has no
    backward.
    """
    _check_args(x, w1, w2, w3, act)
    if x.device.type == "cpu":
        return ref.fused_mlp_ref(x, w1, w2, w3, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd("fused_mlp", x, w1, w2, w3)
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    T, d = x.shape
    ff = w1.shape[1]
    dm, df = default_tile(T, x.dtype)
    bm = dm if block_m is None else block_m
    bf = df if block_f is None else block_f
    gated = act in GATED
    ws = (w1, w2, w3) if gated else (w1, w2)
    _check_cuda(x, ws, bm, bf)
    y = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.reshape(shape)
    # float32 sums go straight into y; bfloat16 ones into a float32 buffer
    acc = y if x.dtype == torch.float32 else torch.empty(
        (T, d), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.fused_mlp_launch(
            x.data_ptr(), w1.data_ptr(), (w3 if gated else w1).data_ptr(),
            w2.data_ptr(), y.data_ptr(), acc.data_ptr(), T, d, ff, ACTS[act],
            bm, bf, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_mlp launch failed with CUDA error {err} (T {T}, d {d}, "
            f"ff {ff}, {act}, tile {bm}x{bf}, {smem_bytes(bm, bf, x.dtype)} B shared)")
    fused_mlp.launches += 1
    return y.reshape(shape)


fused_mlp.launches = 0
