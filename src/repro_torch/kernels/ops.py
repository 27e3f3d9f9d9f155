"""Dispatch wrappers the models call, and the kernel sets they run through.

A CPU tensor goes to the plain PyTorch version of a kernel; a CUDA tensor
goes to the hand-written Hopper kernel or raises — nothing on a GPU falls
back to the plain version.  This replaces the reference's ``INTERPRET``
flag: the tensor's device decides, and ``device=`` (default ``"cuda"``)
states which one the caller means, so a CPU run has to be asked for.

Three kernel sets (:class:`FusedKernels`): :data:`KERNELS` (serving: K2,
K3, K4), :data:`PLAIN` (their plain versions, for comparison) and
:func:`train_kernels` (training: K2 with its backward kernel; the MLP and
the scan in the model's own torch ops, as the reference trains them
through ``jnp``).  K1, K3 and K4 have no backward
kernel and raise on CUDA tensors that require grad.

The kernels are reached through ``ctypes``, so a trace (``make_fx``) or
``FlopCounterMode`` sees neither them nor their work.  :func:`traced_kernels`
swaps each kernel of a set for a marker op (``repro_torch::traced_*``, a
``torch.library.custom_op`` whose fake implementation gives the launch's
output shapes and whose body is the plain version): a fake-tensor trace of
a step through it holds one node per launch, with the launch's shapes and
dtypes, which :mod:`repro_torch.core.hlo_cost` bills as one fusion group
(:data:`MARKERS`).  The attention marker's backward is K2's backward
marker.  The sets the model runs on the card keep their ``ctypes``
launches: the markers are for tracing only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..device import resolve_device
from . import fused_attention, fused_conv, fused_mlp, mamba_scan, ref


def _on(device, x: torch.Tensor, name: str) -> None:
    """Resolve ``device`` and check that ``x`` lies on it."""
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(f"{name}(device={str(dev)!r}) was given a tensor on {x.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, chunk: int = 0,
              block_q: int | None = None, block_k: int | None = None,
              device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Flash attention (K2) of ``q`` (B, Sq, H, hd) over ``k``, ``v``
    (B, Skv, KV, hd), positions from 0.  On ``device="cuda"`` (the
    default) the tensors must be CUDA tensors and the kernel runs at the
    tile ``block_q`` x ``block_k`` (``None``: the kernel's default); on
    ``device="cpu"`` the plain version runs.  Without CUDA the default
    raises."""
    _on(device, q, "attention")
    return fused_attention.flash_attention(
        q, k, v, causal=causal, window=window, chunk=chunk,
        block_q=block_q, block_k=block_k)


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
        w3: torch.Tensor | None = None, *, act: str = "swiglu",
        block_m: int | None = None, block_f: int | None = None,
        device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Fused MLP (K3), ``act(x @ w1) [* (x @ w3)] @ w2`` for ``x`` (T, d).
    Devices as :func:`attention`; ``None`` tiles take the kernel's default
    for T."""
    _on(device, x, "mlp")
    return fused_mlp.fused_mlp(x, w1, w2, w3, act=act, block_m=block_m,
                               block_f=block_f)


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor, *,
             h0: torch.Tensor | None = None, chunk: int | None = None,
             block_d: int | None = None,
             device: "str | torch.device" = "cuda"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (K4) of ``dA``, ``dBx`` (B, S, di, ds) and ``C``
    (B, S, ds) from the state ``h0`` (zeros when ``None``); returns ``(y
    (B, S, di), h_last (B, di, ds))``.  Devices as :func:`attention`;
    ``None`` tiles take the planner's (chunk 64, block_d min(512, di))."""
    _on(device, dA, "ssm_scan")
    return mamba_scan.selective_scan(dA, dBx, C, h0, chunk=chunk, block_d=block_d)


@dataclasses.dataclass(frozen=True)
class FusedKernels:
    """The fusion groups the model runs through: ``attention(q, k, v, *,
    causal, window, chunk)``, ``mlp(x, w1, w2, w3, *, act)`` and
    ``ssm_scan(dA, dBx, C, h0) -> (y, h_last)``.  The default is the
    kernels' wrappers (the kernels on a CUDA tensor, their plain versions on
    a CPU one); :data:`PLAIN` is the plain versions on any device, for
    comparison."""

    attention: Callable = fused_attention.flash_attention
    mlp: Callable = fused_mlp.fused_mlp
    ssm_scan: Callable = mamba_scan.selective_scan
    conv3x3: Callable = fused_conv.fused_conv3x3


KERNELS = FusedKernels()
PLAIN = FusedKernels(attention=ref.flash_attention_ref, mlp=ref.fused_mlp_ref,
                     ssm_scan=ref.selective_scan_ref, conv3x3=ref.fused_conv3x3_ref)


def train_kernels(mamba_chunk: int = 256) -> FusedKernels:
    """The training path's kernel set: attention through K2, which is
    differentiable on CUDA tensors (its backward kernel); the MLP and the
    selective scan (chunks of ``mamba_chunk``) in the model's own torch
    ops, as the reference trains them."""
    from ..models.ssm import selective_scan_chunked

    return FusedKernels(attention=fused_attention.flash_attention, mlp=ref.mlp,
                        ssm_scan=functools.partial(selective_scan_chunked, chunk=mamba_chunk))


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            pool: bool = False,
            device: "str | torch.device" = "cuda") -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + ReLU (+ 2x2 max-pool), NHWC / HWIO.

    On ``device="cuda"`` (the default) ``x`` must be a CUDA tensor and the
    fused_conv3x3 kernel runs; on ``device="cpu"`` ``x`` must be a CPU
    tensor and the plain version runs.  Without CUDA the default raises.
    """
    _on(device, x, "conv3x3")
    return fused_conv.fused_conv3x3(x, w, b, pool=pool)


def fused_conv_fn(plan=None, *, device: "str | torch.device" = "cuda"):
    """Adapter for ``VGG16.forward(x, fused_conv_fn=...)``: every conv +
    ReLU (+ pool) group through :func:`conv3x3` on ``device``.

    ``plan`` is a :class:`repro_torch.core.planner.FusionPlan` or ``None``.
    The Hopper kernel's tiles are fixed at build time, so a plan is taken
    when its ``conv_block_c`` is the built ``fused_conv.BLOCK_C`` (the
    planner's choice) and refused otherwise.
    """
    if plan is not None and plan.conv_block_c != fused_conv.BLOCK_C:
        raise ValueError(
            f"plan.conv_block_c = {plan.conv_block_c}: the fused_conv3x3 "
            f"kernel is built for {fused_conv.BLOCK_C} output channels a block"
        )
    resolve_device(device)

    def fn(x, w, b, *, pool):
        return conv3x3(x, w, b, pool=pool, device=device)

    return fn


# ---------------------------------------------------------------------------
# Marker ops: one traced node per kernel launch
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::traced_flash_attention", mutates_args=())
def _attention_marker(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      window: int, chunk: int, with_lse: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 as one op: (out, the float32 logsumexp (B, H, Sq), or an empty
    tensor without ``with_lse``)."""
    mask = dict(causal=causal, window=window, chunk=chunk)
    lse = (ref.attention_lse_ref(q, k, **mask) if with_lse
           else q.new_empty((0,), dtype=torch.float32))
    return ref.flash_attention_ref(q, k, v, **mask), lse


@_attention_marker.register_fake
def _(q, k, v, causal, window, chunk, with_lse):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq) if with_lse else (0,),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::traced_flash_attention_bwd", mutates_args=())
def _attention_bwd_marker(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                          causal: bool, window: int, chunk: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's backward as one op: (dq, dk, dv)."""
    return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                       window=window, chunk=chunk)


@_attention_bwd_marker.register_fake
def _(q, k, v, out, dout, lse, causal, window, chunk):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal, window, chunk, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.mask = (causal, window, chunk)


def _attention_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _attention_bwd_marker(q, k, v, out, dout.contiguous(), lse, *ctx.mask)
    return dq, dk, dv, None, None, None, None


_attention_marker.register_autograd(_attention_backward, setup_context=_attention_setup)


@torch.library.custom_op("repro_torch::traced_fused_mlp", mutates_args=())
def _mlp_marker(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor | None, act: str) -> torch.Tensor:
    """K3 as one op."""
    return ref.fused_mlp_ref(x, w1, w2, w3, act=act)


@_mlp_marker.register_fake
def _(x, w1, w2, w3, act):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::traced_mamba_scan", mutates_args=())
def _scan_marker(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                 h0: torch.Tensor | None, final_state: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 as one op: (y, the final state, or an empty tensor without
    ``final_state``)."""
    y, h = ref.selective_scan_ref(dA, dBx, C, h0)
    return y, (h.clone() if final_state else dA.new_empty((0,)))


@_scan_marker.register_fake
def _(dA, dBx, C, h0, final_state):
    B, S, di, ds = dA.shape
    return (dA.new_empty((B, S, di), dtype=torch.float32),
            dA.new_empty((B, di, ds) if final_state else (0,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::traced_fused_conv3x3", mutates_args=())
def _conv_marker(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 pool: bool) -> torch.Tensor:
    """K1 as one op."""
    return ref.fused_conv3x3_ref(x, w, b, pool=pool)


@_conv_marker.register_fake
def _(x, w, b, pool):
    B, H, W, _ = x.shape
    hw = (H // 2, W // 2) if pool else (H, W)
    return x.new_empty((B, *hw, w.shape[-1]))


def traced_attention(q, k, v, *, causal: bool = True, window: int = 0, chunk: int = 0,
                     block_q=None, block_k=None):
    """:func:`fused_attention.flash_attention` through the K2 marker: with
    the logsumexp (and the backward marker) when an input needs a
    gradient, as the kernel's own wrapper."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _attention_marker(q, k, v, causal, window, chunk, grad)[0]


def traced_mlp(x, w1, w2, w3=None, *, act: str = "swiglu", block_m=None, block_f=None):
    """:func:`fused_mlp.fused_mlp` through the K3 marker."""
    return _mlp_marker(x, w1, w2, w3, act)


def traced_ssm_scan(dA, dBx, C, h0=None, *, final_state: bool = True, chunk=None,
                    block_d=None):
    """:func:`mamba_scan.selective_scan` through the K4 marker."""
    y, h = _scan_marker(dA, dBx, C, h0, final_state)
    return y, (h if final_state else None)


def traced_conv3x3(x, w, b, *, pool: bool = False):
    """:func:`fused_conv.fused_conv3x3` through the K1 marker."""
    return _conv_marker(x, w, b, pool)


# marker op -> the kernel whose launch it stands for
MARKERS = {
    torch.ops.repro_torch.traced_flash_attention.default: "flash_attention",
    torch.ops.repro_torch.traced_flash_attention_bwd.default: "flash_attention_bwd",
    torch.ops.repro_torch.traced_fused_mlp.default: "fused_mlp",
    torch.ops.repro_torch.traced_mamba_scan.default: "selective_scan",
    torch.ops.repro_torch.traced_fused_conv3x3.default: "fused_conv3x3",
}
_TRACED = {
    fused_attention.flash_attention: traced_attention,
    fused_mlp.fused_mlp: traced_mlp,
    mamba_scan.selective_scan: traced_ssm_scan,
    fused_conv.fused_conv3x3: traced_conv3x3,
}


def traced_kernels(kernels: FusedKernels = KERNELS) -> FusedKernels:
    """``kernels`` with every hand-written kernel swapped for its marker op
    (the torch ops of a set, as :func:`train_kernels`' MLP and scan, stay):
    a trace of a step through it records one node per launch the step
    makes on the card.  The default is every kernel."""
    return FusedKernels(**{f.name: _TRACED.get(getattr(kernels, f.name),
                                               getattr(kernels, f.name))
                           for f in dataclasses.fields(kernels)})
