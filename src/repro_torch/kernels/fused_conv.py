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
``ctypes``.  The tile constants below are the single source of truth: they
are passed to ``nvcc`` as ``-D`` flags, and the launch grid and shared
memory size are computed here (:func:`launch_geometry`).

:func:`fused_conv3x3` is the wrapper: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.kernels.ref.fused_conv3x3_ref`), a CUDA
tensor launches the kernel or raises.  ``fused_conv3x3.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import ref

# Tile constants of the kernel (see the head comment of the CUDA source).
TILE_H = 16  # pre-pool output rows per block (even: pool windows stay whole)
TILE_W = 16  # pre-pool output columns per block (even)
CIN_CHUNK = 8  # input channels staged in shared memory per loop step
BLOCK_C = 64  # output channels per block
CHANNELS_PER_THREAD = 16  # CPT in the source: 4 x 16 accumulators a thread

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_conv3x3.cu"
# build/kernels/ of the checkout: kernels -> repro_torch -> src -> root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DTILE_H={TILE_H}", f"-DTILE_W={TILE_W}",
    f"-DCIN_CHUNK={CIN_CHUNK}", f"-DBLOCK_C={BLOCK_C}",
    f"-DCPT={CHANNELS_PER_THREAD}",
)
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


def _nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the fused_conv3x3 kernel")
    return str(path)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """A built kernel library: its path, the seconds ``nvcc`` took (0.0 when
    an up-to-date library was already there) and ``nvcc``'s output (the
    ``-Xptxas -v`` register and shared-memory report)."""

    path: Path
    seconds: float
    log: str


def build() -> BuildResult:
    """Compile ``csrc/fused_conv3x3.cu`` into ``build/kernels/``.

    The library's file name carries a hash of the source and the flags, so
    an edited source is rebuilt and an unchanged one reused; it is written
    under a temporary name and renamed into place, so a concurrent build
    never loads a half-written file.  Raises with ``nvcc``'s output if the
    build fails.
    """
    digest = hashlib.sha256(
        SOURCE.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libfused_conv3x3-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return BuildResult(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures."""
    lib = ctypes.CDLL(str(build().path))
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
