"""Flash attention backward: dq, dk, dv of the flash-attention kernel (K2)
from the forward's (q, k, v, out, lse) and the output's gradient.

The training path's attention backward: the counterpart of the custom-VJP
backward of the JAX package's ``models/flash.py`` (the TPU kernel it
trains with has none).  The kernel is hand-written CUDA for Hopper,
``csrc/flash_attention_bwd.cu`` (its head comment gives the design), built
by :mod:`repro_torch.kernels.builder` at its first launch and loaded with
``ctypes``: a pass for ``D = rowsum(dO * O)`` (in bfloat16 summed as
``rowsum(P * dP)``, which does not see the stored output's rounding), a
dK/dV kernel and a dQ kernel.  It masks the pairs K2 masks (the predicates are shared,
``csrc/flash_common.cuh``); a masked pair has probability 0, so a query
that sees no key gets dq = 0.

What bounds it is the tensor cores: at training shapes the products take
hundreds of flops for every byte read.  bfloat16 at head dims 64 and 128
(:data:`WGMMA_HEAD_DIMS`, qwen3's 128 among them) runs on Hopper's
warpgroup products (``wgmma``) from 128-byte-swizzled shared memory, two
warpgroups of 64 keys (dK/dV) or 64 queries (dQ) a block, the tiles
brought by TMA; head dims 32 and 96 on warp-level ``mma.sync``; float32 on
the CUDA cores.  It is deterministic, two runs bit-equal: no atomics, each
output written once by one thread, every sum in a fixed order.  That costs
seven products a visible (query, key) pair and head (nine in bfloat16,
whose D pass computes S and dP once more) where the arithmetic needs five,
since the dQ kernel recomputes S and dP rather than have the dK/dV blocks
add into dq in whatever order they finish.

:func:`flash_attention_bwd` is the wrapper: a CPU tensor goes to the plain
version (:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`), a CUDA
tensor launches the kernels or raises.  ``flash_attention_bwd.launches``
counts its calls on CUDA tensors (three device kernels each).
:func:`smem_bytes` is a block's shared memory, checked against the built
library's own count when it loads.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from . import builder, ref

HEAD_DIMS = (32, 64, 96, 128)  # head widths the kernels are built for (K2's)
WGMMA_HEAD_DIMS = (64, 128)  # bfloat16 on wgmma; the others on mma.sync
ALIGN = 16  # bytes: the bf16 bodies copy rows in 16-byte chunks (cp.async, TMA)
STAGES = 3  # ring of streamed tiles of the wgmma bodies

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention_bwd.cu"
KERNEL = builder.KernelSource("flash_attention_bwd", SOURCE, builder.BASE_FLAGS,
                              (CSRC / "mma_bf16.cuh", CSRC / "flash_common.cuh",
                               CSRC / "tma_wgmma.cuh"))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(hd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one block takes (bytes), the larger of the dK/dV and
    dQ kernels' at head dim ``hd``.  bfloat16 on ``wgmma``: K and V of 128
    keys resident and STAGES stages of 64 rows of Q and dO with their lse
    and D rows padded to a 1024-byte atom (dK/dV), or Q and dO of 128
    queries resident and STAGES stages of 64 rows of K and V (dQ); then
    64 bytes of mbarriers and 1024 to align the swizzle atoms.  bfloat16 on
    ``mma.sync``: 64-row tiles with rows padded by 8 elements, two
    resident, two stages of two, and the dK/dV kernel's two stages of lse
    and D.  float32: the dK/dV kernel's static 16-row tiles of K, V, Q and
    dO (rows padded by one float), its two 16 x 17 score tiles, lse and D."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not built (built: {HEAD_DIMS})")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        row = 2 * hd
        dkv = 2 * 128 * row + STAGES * (2 * 64 * row + 1024) + 64 + 1024
        dq = 2 * 128 * row + STAGES * 2 * 64 * row + 64 + 1024
        return max(dkv, dq)
    if dtype == torch.bfloat16:
        tile = 64 * (hd + 8)
        return 6 * tile * 2 + 2 * 2 * 64 * 4
    if dtype == torch.float32:
        return 4 * (4 * 16 * (hd + 1) + 2 * 16 * 17 + 2 * 16)
    raise TypeError(f"flash_attention_bwd is built for float32 and bfloat16, not {dtype}")


def build() -> builder.BuildResult:
    """Compile ``csrc/flash_attention_bwd.cu`` into ``build/kernels/``."""
    return builder.build(KERNEL)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures; its
    shared-memory sizes are checked against :func:`smem_bytes`."""
    lib = builder.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 10 + [i32] * 9 + [ctypes.c_float, i32, ptr])
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_smem.argtypes = [i32, i32]
    lib.flash_attention_bwd_smem.restype = i32
    for dtype, code in _DTYPES.items():
        for hd in HEAD_DIMS:
            built, want = lib.flash_attention_bwd_smem(hd, code), smem_bytes(hd, dtype)
            if built != want:
                raise RuntimeError(f"{SOURCE.name} stages {built} bytes at head_dim {hd}, "
                                   f"{dtype}; smem_bytes says {want}")
    return lib


def _check(q, k, v, out, dout, lse) -> None:
    """Reject what the kernels do not take, naming the offending input."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Sq, H, hd) and k, v (B, Skv, KV, hd) alike")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({B}, {H}, {Sq}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not built (built: {HEAD_DIMS})")
    ts = {"q": q, "k": k, "v": v, "out": out, "dout": dout}
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts.values()):
        raise TypeError("q, k, v, out and dout must share float32 or bfloat16, got "
                        + ", ".join(str(t.dtype) for t in ts.values()))
    for name, t in {**ts, "lse": lse}.items():
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and name != "lse" and t.data_ptr() % ALIGN:
            raise ValueError(f"bfloat16 {name} must be {ALIGN}-byte aligned")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0, chunk: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention of ``q`` (B, Sq, H, hd) over ``k``,
    ``v`` (B, Skv, KV, hd) at positions 0.. under the masks ``causal``,
    ``window``, ``chunk``, given its output ``out``, the output's gradient
    ``dout`` and the rows' logsumexp ``lse`` (B, H, Sq), as
    ``fused_attention.flash_attention_lse`` returns them; in the inputs'
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (counted in ``flash_attention_bwd.launches``) or raises."""
    if window > 0 and chunk > 0:
        raise ValueError("window and chunk masks are exclusive")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                           window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, out, dout, lse)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Sq, Skv, H, KV, hd, int(causal), int(window), int(chunk),
            1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed with CUDA error {err} (B {B}, Sq "
            f"{Sq}, Skv {Skv}, H {H}, KV {KV}, head_dim {hd}, {q.dtype})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
