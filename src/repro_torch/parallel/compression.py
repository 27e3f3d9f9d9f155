"""Gradient compression for the slow cross-pod link (int8 + error feedback).

The port of the JAX package's ``parallel/compression.py``.  At 2 pods the
inter-pod all-reduce carries the full gradient every step over the slowest
links in the system.  :func:`compressed_psum` quantises each tensor to
int8 with a scale shared by every rank, all-reduces the int8 payload (1
byte an element on the wire instead of 4 or 2) and de-quantises; the
quantisation residual is fed back into the next step's gradient (error
feedback, :func:`ef_apply`), which keeps SGD / Adam convergence
(Karimireddy et al., 2019).

Overflow: an int8 sum wraps (gloo and NCCL add int8 modulo 256) once the
summed magnitudes pass 127, so the scale is sized for the *sum* over the
group (the largest rank's scale times the group's size).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, n_summands: int = 1):
    """-> (q int8, scale float32).  Scale sized so an n-way sum cannot
    saturate; rounding is half-to-even, as ``jnp.round``'s."""
    amax = torch.max(torch.abs(x.float()))
    scale = torch.clamp(amax * n_summands, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group=None, *, mean: bool = True):
    """int8 all-reduce of ``x`` over the ranks of ``group`` (default: every
    rank).  Returns (reduced float32, this rank's quantisation error for
    feedback).  Two collectives: the scale's maximum (4 bytes) and the
    int8 payload, a tensor of dtype ``torch.int8`` handed to
    ``torch.distributed.all_reduce``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    _q_local, scale_local = quantize_int8(x, n_summands=1)
    # Every rank must use the same scale or the int8 sum is meaningless:
    # the largest, with headroom for the n-way sum.
    scale = (scale_local * 1).contiguous()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale * n
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    err = x.float() - q * scale
    payload = q.to(torch.int8)
    dist.all_reduce(payload, op=dist.ReduceOp.SUM, group=group)  # 1 byte an element
    out = payload.float() * scale
    if mean:
        out = out / n
    return out, err


def ef_apply(grads, errors):
    """Add carried error feedback into this step's gradients (trees of one
    structure; ``errors`` None adds nothing)."""
    from torch.utils import _pytree as pytree

    if errors is None:
        return grads
    return pytree.tree_map(lambda g, e: g + e.to(g.dtype), grads, errors)
