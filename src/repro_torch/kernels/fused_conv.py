"""Fused conv3x3 + bias + ReLU (+ 2x2 max-pool) — the paper's own workload.

This is the fusion group the paper's DLA executes (Fig. 1: PE array + the
inline ReLU/BN/pool functional unit): the pre-pool output frame (the
``out_words_prepool`` quantity of the evaluator's area model) stays on
chip and only the pooled frame is written to device memory — the traffic
the evaluator's Eq. (1) credits a fused group.

The kernel is hand-written CUDA for Hopper, ``csrc/fused_conv3x3.cu`` (its
head comment gives the design): an implicit GEMM on the tensor cores,
``mma.sync`` in three TF32 products for float32 (3xTF32, float32-exact to
about 2^-22 a product; single-pass TF32 would miss the float32 tolerance)
and one bfloat16 product for bfloat16, the 2x2 pool in registers through a
sub-pixel-major row order (:func:`gemm_row_pixel`).  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
its first launch, into ``build/kernels/`` of the repository checkout, and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.builder`).  The tile constants
below are the single source of truth: they are passed to ``nvcc`` as
``-D`` flags, and the launch grid and shared memory size are computed here
(:func:`launch_geometry`).

:func:`fused_conv3x3` is the wrapper: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.kernels.ref.fused_conv3x3_ref`), a CUDA
tensor launches the kernel or raises.  ``fused_conv3x3.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from ..core.arch import H100
from ..device import refuse_autograd
from . import builder, ref

# Tile constants of the kernel (see the head comment of the CUDA source).
BLOCK_C = 64  # output channels a block: the planner's conv_block_c
WARP_C = 32  # output channels a warp (a warp owns 64 pixels x WARP_C)
TILES = (16, 8)  # square pre-pool pixel tiles built, largest first (even)
CHUNK_BYTES = 32  # input channels staged a pixel a loop step: one mma k-step
STAGES = 3  # depth of the cp.async ring
PIX_BYTES = CHUNK_BYTES + 16  # a staged pixel's row, padded
SM_COUNT = H100.sm_count  # the grid a tile must fill

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_conv3x3.cu"
BUILD_DIR = builder.BUILD_DIR
NVCC_FLAGS = builder.BASE_FLAGS + (
    f"-DBLOCK_C={BLOCK_C}", f"-DCHUNK_BYTES={CHUNK_BYTES}", f"-DSTAGES={STAGES}",
    f"-DTILE_BIG={TILES[0]}", f"-DTILE_SMALL={TILES[1]}",
)
KERNEL = builder.KernelSource("fused_conv3x3", SOURCE, NVCC_FLAGS,
                              (CSRC / "mma_bf16.cuh",))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cin_chunk(dtype: torch.dtype) -> int:
    """Input channels staged a loop step: one mma k-step, 8 float32 (tf32
    m16n8k8) or 16 bfloat16 (m16n8k16)."""
    return CHUNK_BYTES * 8 // torch.finfo(dtype).bits


def threads(tile: int) -> int:
    """Threads a block at ``tile``: a warp per 16 pool windows (64 pixels)
    and per WARP_C output channels."""
    return (tile // 2) ** 2 // 16 * (BLOCK_C // WARP_C) * 32


def smem_bytes(tile: int = TILES[0]) -> int:
    """Shared memory one block stages (bytes): STAGES x (the haloed input
    tile, a PIX_BYTES row a pixel, plus the 9 x chunk x BLOCK_C weight
    slice, rows padded by 8 elements) -- the Hopper counterpart of the
    reference kernel's ``vmem_bytes``.  A chunk is CHUNK_BYTES of channels
    in either dtype, so the size does not depend on it."""
    return STAGES * ((tile + 2) ** 2 * PIX_BYTES + 9 * CHUNK_BYTES * (BLOCK_C + 8))


def choose_tile(batch: int, H: int, W: int, Cout: int) -> int:
    """The largest built tile whose grid has a block for every SM, else the
    smallest."""
    for tile in TILES:
        if -(-H // tile) * -(-W // tile) * -(-Cout // BLOCK_C) * batch >= SM_COUNT:
            return tile
    return TILES[-1]


def gemm_row_pixel(tile: int, m: int) -> tuple[int, int]:
    """(h, w) in a ``tile`` x ``tile`` block of GEMM row ``m``, the kernel's
    sub-pixel-major order: warp ``m // 64`` owns windows 16 (m // 64) ..
    + 15 (row-major in the tile); in its rows, m16 tile ``mt = m % 64 //
    16`` is the window's sub-pixel (mt // 2, mt % 2) and the row in the
    tile, ``m % 16``, the window.  So the C fragment rows a lane holds (l/4
    and l/4 + 8 of every m16 tile) are the four pixels of two windows."""
    warp, mt, r = m // 64, m % 64 // 16, m % 16
    wy, wx = divmod(warp * 16 + r, tile // 2)
    return 2 * wy + mt // 2, 2 * wx + mt % 2


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Tile, grid, block and shared memory of one launch."""

    tile: int
    grid: tuple[int, int, int]  # (spatial tiles, Cout blocks, batch)
    threads: int
    smem_bytes: int
    tiles_w: int


def launch_geometry(batch: int, H: int, W: int, Cin: int, Cout: int) -> LaunchGeometry:
    """The launch for an NHWC ``(batch, H, W, Cin)`` input and ``Cout``
    output channels: one block per (spatial tile, BLOCK_C channels, image),
    at the tile :func:`choose_tile` picks."""
    del Cin  # looped over inside the block, a chunk at a time
    tile = choose_tile(batch, H, W, Cout)
    tiles_w = -(-W // tile)
    return LaunchGeometry(
        tile=tile,
        grid=(-(-H // tile) * tiles_w, -(-Cout // BLOCK_C), batch),
        threads=threads(tile),
        smem_bytes=smem_bytes(tile),
        tiles_w=tiles_w,
    )


def vectorised(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel may stage x and w in 16-byte cp.async pieces:
    both 16-byte aligned and their Cin and Cout rows whole pieces (else it
    stages element by element, as at Cin = 3)."""
    es = x.element_size()
    return (x.shape[-1] * es % 16 == 0 and w.shape[-1] * es % 16 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def build() -> builder.BuildResult:
    """Compile ``csrc/fused_conv3x3.cu`` into ``build/kernels/`` (see
    :mod:`repro_torch.kernels.builder`); raises with ``nvcc``'s output if
    the build fails."""
    return builder.build(KERNEL)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures."""
    lib = builder.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_conv3x3_launch.argtypes = [ptr] * 4 + [i32] * 13 + [ptr]
    lib.fused_conv3x3_launch.restype = i32
    for name in ("fused_conv3x3_threads", "fused_conv3x3_smem_bytes"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = i32
    for tile in TILES:
        built = (lib.fused_conv3x3_threads(tile), lib.fused_conv3x3_smem_bytes(tile))
        if built != (threads(tile), smem_bytes(tile)):
            raise RuntimeError(
                f"{SOURCE.name} was built for {built[0]} threads and {built[1]} "
                f"bytes a block at tile {tile}; the wrapper expects "
                f"{(threads(tile), smem_bytes(tile))}")
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """Reject what the kernel does not take, naming the offending input."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (B, H, W, Cin), got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be HWIO (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"b must be ({w.shape[-1]},), got {tuple(b.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"x, w and b must share float32 or bfloat16, got "
            f"{x.dtype}, {w.dtype}, {b.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w and b must lie on one device, got "
                         f"{x.device}, {w.device}, {b.device}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  pool: bool = False) -> torch.Tensor:
    """3x3 SAME conv + bias + ReLU (+ 2x2/2 max-pool when ``pool``).

    ``x`` NHWC ``(B, H, W, Cin)``, ``w`` HWIO ``(3, 3, Cin, Cout)``, ``b``
    ``(Cout,)``, all float32 or all bfloat16; accumulates in float32 and
    returns NHWC in ``x.dtype`` (``(B, H // 2, W // 2, Cout)`` when
    pooled).  A CPU tensor takes the plain PyTorch version; a CUDA tensor
    launches the Hopper kernel (counted in ``fused_conv3x3.launches``) or
    raises -- also when one requires grad with grad mode on: the kernel has
    no backward.
    """
    if x.device.type == "cpu":
        return ref.fused_conv3x3_ref(x, w, b, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3 runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd("fused_conv3x3", x, w, b)
    _check(x, w, b)
    B, H, W, Cin = x.shape
    Cout = w.shape[-1]
    out_hw = (H // 2, W // 2) if pool else (H, W)
    y = torch.empty((B, *out_hw, Cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    geo = launch_geometry(B, H, W, Cin, Cout)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.fused_conv3x3_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            H, W, Cin, Cout, int(pool), _DTYPES[x.dtype], geo.tile, *geo.grid,
            geo.tiles_w, geo.smem_bytes, int(vectorised(x, w)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_conv3x3 launch failed with CUDA error {err} (tile {geo.tile}, "
            f"grid {geo.grid}, {geo.threads} threads, {geo.smem_bytes} B shared)")
    fused_conv3x3.launches += 1
    return y


fused_conv3x3.launches = 0
