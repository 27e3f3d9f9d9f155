"""Fused conv3x3 + bias + ReLU (+ 2x2 max-pool) — the paper's own workload.

This is the fusion group the paper's DLA executes (Fig. 1: PE array + the
inline ReLU/BN/pool functional unit): the pre-pool output frame (the
``out_words_prepool`` quantity of the evaluator's area model) stays on
chip and only the pooled frame is written to device memory — the traffic
the evaluator's Eq. (1) credits a fused group.

The kernel is hand-written CUDA for Hopper, ``csrc/fused_conv3x3.cu`` (its
head comment gives the design).  It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at its first
launch, into ``build/kernels/`` of the repository checkout, and loaded with
``ctypes`` (:mod:`repro_torch.kernels.builder`).  The tile constants
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

from . import builder, ref

# Tile constants of the kernel (see the head comment of the CUDA source).
TILE_H = 16  # pre-pool output rows per block (even: pool windows stay whole)
TILE_W = 16  # pre-pool output columns per block (even)
CIN_CHUNK = 8  # input channels staged in shared memory per loop step
BLOCK_C = 64  # output channels per block
CHANNELS_PER_THREAD = 16  # CPT in the source: 4 x 16 accumulators a thread

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_conv3x3.cu"
BUILD_DIR = builder.BUILD_DIR
NVCC_FLAGS = builder.BASE_FLAGS + (
    f"-DTILE_H={TILE_H}", f"-DTILE_W={TILE_W}",
    f"-DCIN_CHUNK={CIN_CHUNK}", f"-DBLOCK_C={BLOCK_C}",
    f"-DCPT={CHANNELS_PER_THREAD}",
)
KERNEL = builder.KernelSource("fused_conv3x3", SOURCE, NVCC_FLAGS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(tile_h: int = TILE_H, tile_w: int = TILE_W,
               cin_chunk: int = CIN_CHUNK, block_c: int = BLOCK_C) -> int:
    """Shared memory one block stages (bytes): the haloed float32 input tile
    plus the float32 ``cin_chunk x 9 x block_c`` weight slice — the Hopper
    counterpart of the reference kernel's ``vmem_bytes``."""
    return ((tile_h + 2) * (tile_w + 2) * cin_chunk
            + 9 * cin_chunk * block_c) * 4


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Grid, block and shared memory of one launch."""

    grid: tuple[int, int, int]  # (spatial tiles, Cout blocks, batch)
    threads: int
    smem_bytes: int
    tiles_w: int


def launch_geometry(batch: int, H: int, W: int, Cin: int, Cout: int) -> LaunchGeometry:
    """The launch for an NHWC ``(batch, H, W, Cin)`` input and ``Cout``
    output channels: one block per (spatial tile, BLOCK_C channels, image)."""
    del Cin  # looped over inside the block, in CIN_CHUNK steps
    tiles_h = -(-H // TILE_H)
    tiles_w = -(-W // TILE_W)
    threads = (TILE_H // 2) * (TILE_W // 2) * (BLOCK_C // CHANNELS_PER_THREAD)
    return LaunchGeometry(
        grid=(tiles_h * tiles_w, -(-Cout // BLOCK_C), batch),
        threads=threads,
        smem_bytes=smem_bytes(),
        tiles_w=tiles_w,
    )


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
    lib.fused_conv3x3_launch.argtypes = [ptr] * 4 + [i32] * 11 + [ptr]
    lib.fused_conv3x3_launch.restype = i32
    lib.fused_conv3x3_threads.argtypes = []
    lib.fused_conv3x3_threads.restype = i32
    expected = launch_geometry(1, TILE_H, TILE_W, 1, BLOCK_C).threads
    if lib.fused_conv3x3_threads() != expected:
        raise RuntimeError(
            f"{SOURCE.name} was built for {lib.fused_conv3x3_threads()} "
            f"threads a block, the wrapper expects {expected}")
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
    raises.
    """
    if x.device.type == "cpu":
        return ref.fused_conv3x3_ref(x, w, b, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3 runs on cuda or cpu tensors, got {x.device}")
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
            H, W, Cin, Cout, int(pool), _DTYPES[x.dtype], *geo.grid,
            geo.tiles_w, geo.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_conv3x3 launch failed with CUDA error {err} "
            f"(grid {geo.grid}, {geo.threads} threads, {geo.smem_bytes} B shared)")
    fused_conv3x3.launches += 1
    return y


fused_conv3x3.launches = 0
