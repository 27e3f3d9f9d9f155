"""Flash attention forward (K2): QK^T -> mask -> online softmax -> PV.

The fusion group of the transformer's attention: the (Sq, Skv) score frame
(the paper's Eq. (1) group-internal tensor) never reaches device memory,
which cuts attention's traffic from O(Sq * Skv) to O(Sq * hd + Skv * hd).

The kernel is hand-written CUDA for Hopper, ``csrc/flash_attention.cu``
(its head comment gives the design), built by
:mod:`repro_torch.kernels.builder` at its first launch and loaded with
``ctypes``.  bfloat16 at head dims 64 and 128 (:data:`WGMMA_HEAD_DIMS`)
runs on Hopper's warpgroup tensor cores: one or two consumer warpgroups of
64 queries a block and a producer warp that brings the Q tile and a ring of
K/V tiles by TMA into 128-byte-swizzled shared memory; S = Q K^T is a
``wgmma`` with both operands in shared memory, the online softmax runs on
its float32 accumulators, and P, rounded to bf16, is the register operand
of the ``wgmma`` for P V.  bfloat16 at head dims 32 and 96 runs on
warp-level ``mma.sync`` (K/V tiles double-buffered by ``cp.async``);
float32 on the CUDA cores, since TF32 would miss the float32 tolerance.
It is built for the head dims :data:`HEAD_DIMS` and the (block_q, block_k)
tiles :data:`TILES`; :func:`smem_bytes` is its shared memory per block for
each dtype, which the planner sizes against, and :func:`default_tile` the
tile a launch takes when none is given.

:func:`flash_attention` is the wrapper: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.kernels.ref.flash_attention_ref`,
differentiable by torch autograd), a CUDA tensor launches the kernel or
raises.  :func:`flash_attention_lse` also returns each row's float32
logsumexp ``lse`` (B, H, Sq), which the kernel writes when asked.  On a
CUDA tensor that requires grad (with grad mode on) :func:`flash_attention`
is an ``autograd.Function``: the forward is :func:`flash_attention_lse`,
saving only (q, k, v, out, lse); the backward is the flash-attention
backward kernel
(:func:`repro_torch.kernels.flash_attention_bwd.flash_attention_bwd`).
``flash_attention.launches`` counts kernel launches (with ``lse`` or
without).  Any Sq and Skv are taken: keys past the ragged last tile are
excluded and queries past Sq are not stored.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..runtime import spans
from . import builder, flash_attention_bwd, ref

HEAD_DIMS = (32, 64, 96, 128)  # head widths the kernel is built for
WGMMA_HEAD_DIMS = (64, 128)  # bfloat16 on wgmma; the others on mma.sync
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))  # (block_q, block_k)
DEFAULT_TILE = (128, 128)  # the wgmma body's from LONG_KV keys on (training)
SHORT_TILE = (64, 64)  # below LONG_KV keys (serving), and the other bodies'
LONG_KV = 2048  # keys from which DEFAULT_TILE's longer tiles pay on the wgmma body
ALIGN = 16  # bytes: the bf16 bodies copy rows in 16-byte chunks (cp.async, TMA)
BARRIER_BYTES = 64  # the wgmma body's mbarriers
ATOM = 1024  # bytes: the slack that aligns its swizzle atoms

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
NVCC_FLAGS = builder.BASE_FLAGS
KERNEL = builder.KernelSource("flash_attention", SOURCE, NVCC_FLAGS,
                              (CSRC / "mma_bf16.cuh", CSRC / "flash_common.cuh",
                               CSRC / "tma_wgmma.cuh"))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def on_wgmma(hd: int, dtype: torch.dtype) -> bool:
    """Whether a launch at head dim ``hd`` and ``dtype`` runs the wgmma
    body (bfloat16 at :data:`WGMMA_HEAD_DIMS`)."""
    return dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS


def default_tile(hd: int, dtype: torch.dtype, skv: int) -> tuple[int, int]:
    """The (block_q, block_k) a launch over ``skv`` keys takes when none is
    given: :data:`DEFAULT_TILE` on the wgmma body from :data:`LONG_KV` keys
    on, where two warpgroups sharing each 128-key tile make fewer, longer
    blocks pay; :data:`SHORT_TILE` below it (more blocks fill the card at
    serving lengths) and on the other bodies."""
    return DEFAULT_TILE if on_wgmma(hd, dtype) and skv >= LONG_KV else SHORT_TILE


def smem_bytes(block_q: int, block_k: int, hd: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one block stages (bytes) — the Hopper counterpart of
    the reference kernel's ``vmem_bytes``.  bfloat16 (the serving dtype,
    the default) at head dims 64 and 128: the Q tile and a ring of K and V
    tiles in unpadded 128-byte-swizzled rows (3 stages for two warpgroups,
    block_q 128, which hold the SM alone; 2 for one, whose SM holds a
    second block), the mbarriers and the slack that aligns the swizzle
    atoms.  bfloat16 at 32 and 96: the Q tile and two stages of K and V
    tiles, rows padded by 8 elements.  float32: the Q tile and one K-or-V tile, rows padded by 4
    floats, and the (block_q, block_k + 4) probability tile."""
    if on_wgmma(hd, dtype):
        row = 2 * hd
        stages = 3 if block_q == 128 else 2
        return block_q * row + stages * 2 * block_k * row + BARRIER_BYTES + ATOM
    if dtype == torch.bfloat16:
        return (block_q + 4 * block_k) * (hd + 8) * 2
    if dtype == torch.float32:
        return (block_q * (hd + 4) + block_k * (hd + 4) + block_q * (block_k + 4)) * 4
    raise TypeError(f"flash_attention is built for float32 and bfloat16, not {dtype}")


def build() -> builder.BuildResult:
    """Compile ``csrc/flash_attention.cu`` into ``build/kernels/``."""
    return builder.build(KERNEL)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures; its
    shared-memory sizes are checked against :func:`smem_bytes`."""
    lib = builder.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 5 + [i32] * 12 + [ctypes.c_float, i32, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32] * 4
    lib.flash_attention_smem_bytes.restype = i32
    for dtype, code in _DTYPES.items():
        for hd in HEAD_DIMS:
            for bq, bk in TILES:
                built = lib.flash_attention_smem_bytes(hd, bq, bk, code)
                want = smem_bytes(bq, bk, hd, dtype)
                if built != want:
                    raise RuntimeError(
                        f"{SOURCE.name} stages {built} bytes at head_dim {hd}, "
                        f"tile {bq}x{bk}, {dtype}; smem_bytes says {want}")
    return lib


def _check_args(q, k, v, window: int, chunk: int) -> None:
    """Shapes and masks both versions take, naming the offending input."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Skv, KV, {hd}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    KV = k.shape[2]
    if k.shape[1] == 0:
        raise ValueError("k and v hold no keys")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if window > 0 and chunk > 0:
        raise ValueError("window and chunk masks are exclusive")


def _check_cuda(q, k, v, block_q: int, block_k: int) -> None:
    """Reject what the kernel does not take."""
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not built (built: {HEAD_DIMS})")
    if (block_q, block_k) not in TILES:
        raise ValueError(f"tile {block_q}x{block_k} is not built (built: {TILES})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must lie on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % ALIGN:
            raise ValueError(f"bfloat16 {name} must be {ALIGN}-byte aligned")


def _launch(q, k, v, *, causal: bool, window: int, chunk: int, block_q, block_k,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the kernel on CUDA tensors: (o, lse or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    tile = default_tile(q.shape[3], q.dtype, k.shape[1])
    bq = tile[0] if block_q is None else block_q
    bk = tile[1] if block_k is None else block_k
    _check_cuda(q, k, v, bq, bk)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, H, KV, hd, bq, bk, int(causal), int(window),
            int(chunk), int(Sq <= Skv), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed with CUDA error {err} (B {B}, Sq "
            f"{Sq}, Skv {Skv}, H {H}, KV {KV}, head_dim {hd}, tile {bq}x{bk}, "
            f"{smem_bytes(bq, bk, hd, q.dtype)} B shared)")
    flash_attention.launches += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """The kernel with its backward kernel, saving (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, block_q, block_k):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     chunk=chunk, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, chunk=chunk)
        return o

    @staticmethod
    def backward(ctx, dout):
        with spans.span(spans.ATTENTION_BACKWARD):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd.flash_attention_bwd(
                q, k, v, o, dout.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, H, hd) over ``k``, ``v`` (B, Skv, KV, hd)
    with queries and keys at positions 0.., in ``q.dtype``.

    ``causal``, ``window`` (sliding window; 0 = off) and ``chunk``
    (chunked-local; 0 = off) mask by absolute position.  A CPU tensor takes
    the plain version (tiles ignored); a CUDA tensor launches the kernel
    (counted in ``flash_attention.launches``) at the tile ``block_q`` x
    ``block_k`` (default :func:`default_tile`) or raises.  On CUDA tensors
    of which one requires grad, with grad mode on, the result is
    differentiable through the backward kernel.  With tracing on
    (:mod:`repro_torch.runtime.spans`) a CUDA call runs in the span
    ``repro_torch.attention`` and its backward in
    ``repro_torch.attention.backward``.
    """
    _check_args(q, k, v, window, chunk)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk)
    with spans.span(spans.ATTENTION):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, window, chunk, block_q, block_k)
        return _launch(q, k, v, causal=causal, window=window, chunk=chunk,
                       block_q=block_q, block_k=block_k, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        block_q: int | None = None, block_k: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the attention and each row's float32 logsumexp of its
    masked, scaled scores (B, H, Sq), the backward's inputs.  A CPU tensor
    takes the plain versions; a CUDA tensor one launch of the kernel
    (counted in ``flash_attention.launches``).  Not differentiable: it is
    the forward of :func:`flash_attention`'s ``autograd.Function``."""
    _check_args(q, k, v, window, chunk)
    if q.device.type == "cpu":
        mask = dict(causal=causal, window=window, chunk=chunk)
        return (ref.flash_attention_ref(q, k, v, **mask),
                ref.attention_lse_ref(q, k, **mask))
    return _launch(q, k, v, causal=causal, window=window, chunk=chunk,
                   block_q=block_q, block_k=block_k, with_lse=True)
