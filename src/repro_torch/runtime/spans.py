"""Spans and counters at the port's layer boundaries.

Tracing is off unless a caller turns it on for a block with
:func:`enabled`.  Off, :func:`span` is one test of a module flag that
returns a shared ``contextlib.nullcontext()`` and :func:`count` returns at
once: nothing is allocated or recorded and no tensor op runs.  On:

* a span is a ``torch.profiler.record_function`` range, a host range in the
  profiler's trace on the clock of the device activity it records, so that
  each kernel belongs to the span whose thread launched it (matched by
  correlation id) and each idle gap to the span the host was in;
* a count adds into a total per name: a Python int on the host, a tensor
  summed on its device in ``int64`` into an ``int64`` tensor there, with no
  host sync until :func:`counters`.

The spans (:data:`NAMES`, and the Mamba mixer's :data:`MAMBA_NAMES`) nest
on a thread: ``train.step`` holds each
microbatch's ``train.forward``, the ``train.grad_accum`` pieces (the float32
sums' zeros, each microbatch's sum, the division) and ``optim.adamw`` (the
sharded step has the forward, backward and AdamW spans alone);
``train.backward`` runs on the thread that runs the backward (on CUDA
tensors the autograd engine's own), from the backward's first node to the
end of the pass, and holds the recomputation of a checkpointed forward and
``attention.backward``.  ``prefill.step`` holds the trunk, each MoE layer
``moe.dispatch``, ``moe.experts`` and ``moe.combine``, and each Mamba
layer, one after another, ``mamba.in`` (in_proj, the convolution, SiLU),
``mamba.discretize`` (x_proj, the inner norms, dt; then, a chunk of time
at a time, dA and dBx), ``mamba.scan`` (each call of the selective scan)
and ``mamba.out`` (the D skip, the gate, out_proj); ``attention`` is the
flash-attention kernel's call on CUDA tensors.  The counters
(:data:`COUNTERS`) are the MoE layer's: ``moe.claims`` the routed (token, k)
claims, ``moe.kept`` those within their expert's capacity, ``moe.slots``
every expert's capacity slots, ``moe.rows`` the rows the expert products
ran on (the slots of this rank's experts on the capacity path, the kept
claims on the sorted one); and the Mamba layer's: ``mamba.tokens`` the
B x S tokens of each layer's call, summed over the calls, ``mamba.scans``
the scan calls.  A forward recomputed in the backward counts again.
"""
from __future__ import annotations

import contextlib

import torch

TRAIN_STEP = "repro_torch.train.step"
TRAIN_FORWARD = "repro_torch.train.forward"
TRAIN_BACKWARD = "repro_torch.train.backward"
GRAD_ACCUM = "repro_torch.train.grad_accum"
ADAMW = "repro_torch.optim.adamw"
PREFILL_STEP = "repro_torch.prefill.step"
MOE_DISPATCH = "repro_torch.moe.dispatch"
MOE_EXPERTS = "repro_torch.moe.experts"
MOE_COMBINE = "repro_torch.moe.combine"
MAMBA_IN = "repro_torch.mamba.in"
MAMBA_DISCRETIZE = "repro_torch.mamba.discretize"
MAMBA_SCAN = "repro_torch.mamba.scan"
MAMBA_OUT = "repro_torch.mamba.out"
ATTENTION = "repro_torch.attention"
ATTENTION_BACKWARD = "repro_torch.attention.backward"

NAMES = (TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD, GRAD_ACCUM, ADAMW, PREFILL_STEP,
         MOE_DISPATCH, MOE_EXPERTS, MOE_COMBINE, ATTENTION, ATTENTION_BACKWARD)
MAMBA_NAMES = (MAMBA_IN, MAMBA_DISCRETIZE, MAMBA_SCAN, MAMBA_OUT)
COUNTERS = ("moe.claims", "moe.kept", "moe.slots", "moe.rows", "mamba.tokens",
            "mamba.scans")

_NULL = contextlib.nullcontext()
_on = False
_host: dict = {}  # name -> int
_device: dict = {}  # (name, device) -> int64 tensor


def span(name: str):
    """A context manager: the range ``name`` while tracing is on, else the
    shared null context."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while tracing is on: an int on
    the host, or a tensor of whole numbers summed on its device in
    ``int64`` (each element cast to ``int64`` first, so a bfloat16 0/1 mask
    sums exactly)."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        key = (name, value.device)
        part = value.sum(dtype=torch.int64)
        total = _device.get(key)
        _device[key] = part if total is None else total + part
    else:
        _host[name] = _host.get(name, 0) + int(value)


def counters() -> dict:
    """{name: int} of every counter counted since :func:`reset`: one sync
    a device that holds counters."""
    out = dict(_host)
    by_device: dict = {}
    for (name, dev), total in _device.items():
        by_device.setdefault(dev, []).append((name, total))
    for items in by_device.values():
        for (name, _), v in zip(items, torch.stack([t for _, t in items]).tolist()):
            out[name] = out.get(name, 0) + v
    return out


def reset() -> None:
    """Zero every counter."""
    _host.clear()
    _device.clear()


@contextlib.contextmanager
def enabled():
    """Tracing on for the block (and back to what it was after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


class _BackwardSpan(torch.autograd.Function):
    """Identity on the loss; its backward, the pass's first node, opens
    :data:`TRAIN_BACKWARD` on the thread that runs the pass and queues its
    close for the end of the pass on the same thread."""

    @staticmethod
    def forward(ctx, loss):
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, grad):
        rf = torch.profiler.record_function(TRAIN_BACKWARD)
        rf.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: rf.__exit__(None, None, None))
        return grad


def backward_span(loss: torch.Tensor) -> torch.Tensor:
    """``loss``, the same values; while tracing is on, a loss whose backward
    pass runs inside the span :data:`TRAIN_BACKWARD`."""
    return _BackwardSpan.apply(loss) if _on else loss
