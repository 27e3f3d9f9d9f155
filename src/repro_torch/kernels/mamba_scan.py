"""Selective scan (K4): the Mamba-1 recurrence ``h_t = dA_t * h + dBx_t``
with the readout ``y_t = sum_s h_t[:, s] * C_t[s]``.

The fusion group of the SSM mixer: the (di, ds) state stays on chip between
steps, so the (S, di, ds) state sequence never reaches device memory.  The
Pallas kernel stages (chunk, block_d, ds) tiles of dA and dBx in VMEM (2 MiB
each at its default tile), which does not fit a Hopper block; the CUDA
kernel ``csrc/mamba_scan.cu`` keeps one channel's state in one thread's
registers and streams dA and dBx from device memory step by step, with C
staged in shared memory a chunk of steps at a time; a decode step (S = 1)
takes a body of its own with no staging and no barrier (its head comment
gives the design and the byte count).  The wrapper checks shapes, dtypes,
devices and the tile once per launch key, and contiguity and alignment on
every call.  It is built by :mod:`repro_torch.kernels.builder` at its
first launch and loaded with ``ctypes``.

Unlike the Pallas kernel, which zero-initialises its state and drops it at
the end, the kernel takes an optional initial state ``h0`` and optionally
writes the final one: serving carries both ends in its cache, as the
reference's ``mamba_block`` does.  With neither it computes exactly the
Pallas kernel's function.  Any S >= 1 and any d_inner are taken (the ragged
last channel block is masked); ds is at most :data:`MAX_DS`.

:func:`selective_scan` is the wrapper: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.kernels.ref.selective_scan_ref`), a CUDA
tensor launches the kernel or raises.  ``selective_scan.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..device import refuse_autograd
from . import builder, ref

DEFAULT_CHUNK = 64  # steps of C staged at a time: the planner's mamba_chunk
MAX_BLOCK_D = 512  # channels (threads) a block, at most: the planner's cap
MAX_DS = 16  # state width the kernel is built for, at most
ALIGN = 16  # bytes: the kernel reads the state rows as float4
SMEM_OPTIN = 232_448  # shared memory a Hopper block may opt in to

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
NVCC_FLAGS = builder.BASE_FLAGS
KERNEL = builder.KernelSource("mamba_scan", SOURCE, NVCC_FLAGS)


def smem_bytes(chunk: int, block_d: int, ds: int) -> int:
    """Shared memory one block stages (bytes): C for ``chunk`` steps, float32
    — the Hopper counterpart of the reference kernel's ``vmem_bytes``.  The
    state lives in registers and dA / dBx are streamed, so ``block_d`` does
    not enter."""
    del block_d
    return chunk * ds * 4


def default_tile(di: int) -> tuple[int, int]:
    """(chunk, block_d) for ``di`` channels: the planner's ``mamba_chunk``
    and ``mamba_block_d``."""
    return DEFAULT_CHUNK, min(MAX_BLOCK_D, di)


def build() -> builder.BuildResult:
    """Compile ``csrc/mamba_scan.cu`` into ``build/kernels/``."""
    return builder.build(KERNEL)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures; its
    limits and shared-memory size are checked against this module's."""
    lib = builder.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.selective_scan_launch.restype = i32
    lib.selective_scan_smem_bytes.argtypes = [i32, i32]
    for name in ("selective_scan_smem_bytes", "selective_scan_max_block_d",
                 "selective_scan_max_ds"):
        getattr(lib, name).restype = i32
    limits = (lib.selective_scan_max_block_d(), lib.selective_scan_max_ds())
    if limits != (MAX_BLOCK_D, MAX_DS):
        raise RuntimeError(f"{SOURCE.name} takes (block_d, ds) up to {limits}; "
                           f"this module says {(MAX_BLOCK_D, MAX_DS)}")
    built = lib.selective_scan_smem_bytes(DEFAULT_CHUNK, MAX_DS)
    if built != smem_bytes(DEFAULT_CHUNK, 0, MAX_DS):
        raise RuntimeError(f"{SOURCE.name} stages {built} bytes at chunk "
                           f"{DEFAULT_CHUNK}, ds {MAX_DS}; smem_bytes says "
                           f"{smem_bytes(DEFAULT_CHUNK, 0, MAX_DS)}")
    return lib


def _check_args(dA, dBx, C, h0) -> None:
    """Shapes both versions take."""
    if dA.dim() != 4 or tuple(dBx.shape) != tuple(dA.shape):
        raise ValueError(f"dA and dBx must both be (B, S, di, ds), got "
                         f"{tuple(dA.shape)} and {tuple(dBx.shape)}")
    B, S, di, ds = dA.shape
    if tuple(C.shape) != (B, S, ds):
        raise ValueError(f"C must be (B, S, ds) = {(B, S, ds)}, got {tuple(C.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, di, ds):
        raise ValueError(f"h0 must be (B, di, ds) = {(B, di, ds)}, got "
                         f"{tuple(h0.shape)}")
    if min(B, S, di, ds) < 1:
        raise ValueError(f"empty scan {tuple(dA.shape)}: B, S, di and ds must be >= 1")


def _check_tile(ins, chunk: int | None, block_d: int | None,
                smem_limit: int) -> tuple[int, int]:
    """Reject what the kernel does not take, as far as shapes, dtypes,
    devices and the tile decide it, and return the tile (``None``s replaced
    by :func:`default_tile`)."""
    dA, dBx, C = ins[:3]
    _check_args(dA, dBx, C, ins[3] if len(ins) > 3 else None)
    ds = dA.shape[-1]
    d_chunk, d_block = default_tile(dA.shape[2])
    chunk = d_chunk if chunk is None else chunk
    block_d = d_block if block_d is None else block_d
    if ds > MAX_DS:
        raise ValueError(f"ds {ds} > {MAX_DS}: the kernel holds at most "
                         f"{MAX_DS} state values a channel in registers")
    if not 1 <= block_d <= MAX_BLOCK_D:
        raise ValueError(f"block_d {block_d} outside 1..{MAX_BLOCK_D}")
    if chunk < 1 or smem_bytes(chunk, block_d, ds) > smem_limit:
        raise ValueError(f"chunk {chunk} stages {smem_bytes(chunk, block_d, ds)} "
                         f"bytes of C; a block has {smem_limit}")
    for t in ins:
        if t.dtype != torch.float32:
            raise TypeError(f"the scan's inputs must be float32, got {t.dtype}")
        if t.device != dA.device:
            raise ValueError("dA, dBx, C and h0 must lie on one device")
    return chunk, block_d


# Launch key -> the tile _check_tile returned for it.  The key holds every
# input's shape, dtype and device index (-1 on the CPU) and the tile asked
# for, so a key seen before has passed those checks; contiguity and
# alignment depend on strides and pointers, and are checked on every call.
_CHECKED: dict = {}
_SMEM_LIMIT: dict = {}  # device index -> opt-in shared memory a block


def _checked_tile(ins, chunk: int | None, block_d: int | None,
                  smem_limit: "int | None" = None) -> tuple[int, int]:
    """The launch's tile, its checks run once per launch key; contiguity
    and alignment checked every call.  ``smem_limit``: the device's opt-in
    shared memory a block (read once per device when ``None``)."""
    key = (chunk, block_d, *[(t.shape, t.dtype, t.get_device()) for t in ins])
    tile = _CHECKED.get(key)
    if tile is None:
        if smem_limit is None:
            idx = ins[0].device.index
            if idx not in _SMEM_LIMIT:
                props = torch.cuda.get_device_properties(ins[0].device)
                _SMEM_LIMIT[idx] = getattr(props, "shared_memory_per_block_optin",
                                           SMEM_OPTIN)
            smem_limit = _SMEM_LIMIT[idx]
        tile = _CHECKED[key] = _check_tile(ins, chunk, block_d, smem_limit)
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("dA, dBx, C and h0 must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"dA, dBx, C and h0 must be {ALIGN}-byte aligned")
    return tile


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                   h0: torch.Tensor | None = None, *, final_state: bool = True,
                   chunk: int | None = None, block_d: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The selective scan of ``dA``, ``dBx`` (B, S, di, ds) and ``C``
    (B, S, ds), float32, from the state ``h0`` (B, di, ds) (zeros when
    ``None``).  Returns ``(y (B, S, di), h_last (B, di, ds))``, or
    ``(y, None)`` when ``final_state`` is false.

    A CPU tensor takes the plain version (tile ignored); a CUDA tensor
    launches the kernel (counted in ``selective_scan.launches``) at the tile
    ``chunk`` x ``block_d`` (default :func:`default_tile`; a decode step, S
    = 1, runs the kernel's own S = 1 body, which stages nothing) or raises
    -- also when one requires grad with grad mode on: the kernel has no
    backward.
    """
    if dA.device.type != "cuda":
        _check_args(dA, dBx, C, h0)
        if dA.device.type != "cpu":
            raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {dA.device}")
        y, h = ref.selective_scan_ref(dA, dBx, C, h0)
        return y, (h if final_state else None)
    refuse_autograd("selective_scan", dA, dBx, C, h0)
    ins = (dA, dBx, C) if h0 is None else (dA, dBx, C, h0)
    chunk, block_d = _checked_tile(ins, chunk, block_d)
    B, S, di, ds = dA.shape
    dev = dA.device
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h = torch.empty((B, di, ds), dtype=torch.float32, device=dev) if final_state else None
    lib = _library()
    args = (dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(), B, S, di, ds, chunk, block_d,
            torch._C._cuda_getCurrentRawStream(dev.index))  # current_stream's, cheaper
    if dev.index == torch.cuda.current_device():
        err = lib.selective_scan_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.selective_scan_launch(*args)
    if err != 0:
        raise RuntimeError(
            f"selective_scan launch failed with CUDA error {err} (B {B}, S {S}, "
            f"di {di}, ds {ds}, tile {chunk}x{block_d}, "
            f"{smem_bytes(chunk, block_d, ds)} B shared)")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
