"""Three-term roofline of one step on the H100, from the aten-graph cost walker.

    compute    = FLOPs_per_device / peak bfloat16 FLOP/s     (989 TFLOP/s)
    memory     = HBM_bytes_per_device / HBM bandwidth          (3.35 TB/s)
    collective = collective_bytes_per_device / link bandwidth  (450 GB/s)

The port of the JAX package's ``core/roofline.py``.  The peaks are
:class:`~repro_torch.core.arch.GPUSpec`'s data-sheet values (NVIDIA H100
SXM, dense, at 700 W); the link term is one direction of NVLink 4.  The
reference reads FLOPs from XLA's ``cost_analysis()`` and collectives from
the optimized HLO text with regexes; PyTorch has neither, so:

* ``shape_bytes`` (bytes of an HLO shape string) is replaced by the bytes
  of each traced node's fake tensors (:func:`repro_torch.core.hlo_cost.
  tensor_bytes`);
* ``collective_bytes`` and ``_OP_RE`` (collectives parsed from HLO text)
  are replaced by the walker's count of the c10d and functional-collective
  nodes of the aten graph (:func:`repro_torch.core.hlo_cost.module_cost`,
  ``Cost.coll``), each billed by its output bytes;
* ``roofline_from_compiled`` is :func:`roofline_from_cost`, which takes the
  walker's :class:`~repro_torch.core.hlo_cost.Cost`.

:func:`kernel_cost` bills each hand-written kernel's launch as one fusion
group (the paper's Eq. (1)): every input byte read once, every output byte
written once, FLOPs from the shapes.  The walker bills the kernels' marker
nodes with it, and ``chip_smoke.py`` takes each kernel row's bound from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .arch import H100, GPUSpec

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "broadcast",
)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Per-device roofline decomposition of one traced step."""

    flops: float  # per-device FLOPs (dots + elementwise + kernels)
    hbm_bytes: float  # per-device bytes, fusion-optimistic (primary)
    coll_bytes: float  # per-device collective bytes
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_device: float  # 6*N*D / devices (or serve analogue)
    hbm_bytes_upper: float = 0.0  # Eq.(1)-grouped upper bound
    memory_s_upper: float = 0.0
    peak_flops: float = H100.peak_flops

    @property
    def bound(self) -> str:
        """Which resource dominates: compute / memory / collective."""
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_seconds(self) -> float:
        """Lower-bound step time: perfectly-overlapped roofline max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over total executed FLOPs."""
        return self.model_flops_per_device / max(self.flops, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilisation at the roofline step time, against the
        card's bfloat16 peak."""
        return (self.model_flops_per_device / max(self.step_seconds, 1e-30)
                / self.peak_flops)

    def mfu(self, seconds: float) -> float:
        """Model-FLOPs utilisation of a step measured at ``seconds``."""
        return self.model_flops_per_device / seconds / self.peak_flops

    def row(self) -> dict:
        """Flat dict row for the JSON record writers."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_upper": self.hbm_bytes_upper,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_upper": self.memory_s_upper,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "coll_breakdown": {
                k: v for k, v in self.coll_breakdown.items() if v and k != "count"
            },
        }


def roofline_from_cost(cost, *, model_flops_total: float, n_chips: int,
                       spec: GPUSpec = H100) -> Roofline:
    """The roofline of a walked per-device program: ``cost`` is the
    :class:`~repro_torch.core.hlo_cost.Cost` of its aten graph; the
    primary memory term is the fusion-optimistic ``bytes_lo``, the Eq. (1)
    group bytes its upper bound."""
    flops = cost.dot_flops + cost.elem_flops
    coll = dict(cost.coll)
    coll["count"] = cost.coll_count
    coll["dot_flops"] = cost.dot_flops
    coll["elem_flops"] = cost.elem_flops
    cbytes = float(sum(cost.coll.values()))
    return Roofline(
        flops=flops,
        hbm_bytes=cost.bytes_lo,
        hbm_bytes_upper=cost.bytes,
        coll_bytes=cbytes,
        coll_breakdown=coll,
        compute_s=flops / spec.peak_flops,
        memory_s=cost.bytes_lo / spec.hbm_bw,
        memory_s_upper=cost.bytes / spec.hbm_bw,
        collective_s=cbytes / spec.link_bw,
        model_flops_per_device=model_flops_total / n_chips,
        peak_flops=spec.peak_flops,
    )


# ---------------------------------------------------------------------------
# The hand-written kernels, each launch one fusion group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One launch's FLOPs and the bytes its fusion group moves."""

    flops: int
    bytes: int


def visible_pairs(Sq: int, Skv: int, causal: bool = True, window: int = 0,
                  chunk: int = 0) -> int:
    """(query, key) pairs the attention masks leave visible, queries and
    keys at positions 0..: the work a launch does.  ``window`` masks
    ``q - k >= window`` (and ``k - q >= window`` when not causal);
    ``chunk`` keeps pairs in the same ``chunk``-wide block."""
    q = np.arange(Sq, dtype=np.int64)
    lo = np.zeros(Sq, dtype=np.int64)
    hi = np.full(Sq, Skv, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, q + 1)
    if window:
        lo = np.maximum(lo, q - window + 1)
        if not causal:
            hi = np.minimum(hi, q + window)
    elif chunk:
        lo = np.maximum(lo, q // chunk * chunk)
        hi = np.minimum(hi, (q // chunk + 1) * chunk)
    return int(np.maximum(hi - lo, 0).sum())


def kernel_cost(kernel: str, **kw) -> KernelCost:
    """FLOPs and bytes of one launch of ``kernel``, the paper's fusion-group
    billing: each input read once, each output written once.

    * ``"fused_conv3x3"``: ``x=(B, H, W, Cin)``, ``cout``, ``pool``,
      ``itemsize``; reads x, the 3x3 weights and the bias, writes the
      (pooled) frame; 2 x 9 x Cin x Cout FLOPs a pre-pool pixel;
    * ``"flash_attention"``: ``q=(B, Sq, H, hd)``, ``kv=(B, Skv, KV, hd)``,
      ``itemsize``, ``causal``, ``window``, ``chunk``, ``lse``; reads q, k,
      v, writes the output (and the float32 logsumexp with ``lse``); 4 hd
      FLOPs a visible pair and head (QK and PV);
    * ``"flash_attention_bwd"``: as K2; three q-sized tensors (q, dout,
      dq), four kv-sized ones (k, v, dk, dv) and the logsumexp; 10 hd FLOPs
      a visible pair and head (the five products of the backward).  The
      output ``out``, which the kernel reads too, is not billed: the count
      the kernel rows have used since the kernel was written, kept so that
      their bounds stay comparable (it is one q-sized tensor short);
    * ``"fused_mlp"``: ``x=(T, d)``, ``ff``, ``gated``, ``itemsize``; reads
      x and the two or three weights, writes (T, d);
    * ``"selective_scan"``: ``x=(B, S, di, ds)``, ``h0``, ``final_state``;
      float32; reads dA, dBx, C (and h0), writes y (and the final state);
      an FMA for h and one for y a state element and step.
    """
    if kernel == "fused_conv3x3":
        B, H, W, cin = kw["x"]
        cout, es = kw["cout"], kw["itemsize"]
        oh, ow = (H // 2, W // 2) if kw["pool"] else (H, W)
        return KernelCost(flops=2 * 9 * cin * cout * H * W * B,
                          bytes=es * (B * H * W * cin + 9 * cin * cout + cout
                                      + B * oh * ow * cout))
    if kernel in ("flash_attention", "flash_attention_bwd"):
        B, Sq, H, hd = kw["q"]
        _, Skv, KV, _ = kw["kv"]
        es = kw["itemsize"]
        pairs = visible_pairs(Sq, Skv, kw.get("causal", True), kw.get("window", 0),
                              kw.get("chunk", 0))
        n_q, n_kv, n_lse = B * Sq * H * hd, B * Skv * KV * hd, B * H * Sq
        if kernel == "flash_attention":
            return KernelCost(flops=4 * B * H * hd * pairs,
                              bytes=es * (2 * n_q + 2 * n_kv)
                              + (4 * n_lse if kw.get("lse", False) else 0))
        return KernelCost(flops=10 * B * H * hd * pairs,
                          bytes=es * (3 * n_q + 4 * n_kv) + 4 * n_lse)
    if kernel == "fused_mlp":
        T, d = kw["x"]
        ff, gated, es = kw["ff"], kw["gated"], kw["itemsize"]
        return KernelCost(flops=2 * T * d * ff * (2 if gated else 1) + 2 * T * ff * d,
                          bytes=es * (2 * T * d + (3 if gated else 2) * d * ff))
    if kernel == "selective_scan":
        B, S, di, ds = kw["x"]
        n_state = B * di * ds
        return KernelCost(flops=4 * B * S * di * ds,
                          bytes=4 * (2 * B * S * di * ds + B * S * ds + B * S * di
                                     + n_state * (int(kw.get("h0", False))
                                                  + int(kw.get("final_state", False)))))
    raise ValueError(f"unknown kernel {kernel!r}")


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful" compute of the cell)
# ---------------------------------------------------------------------------


def model_flops(cfg, shape, *, kind: str) -> float:
    """6*N_active*D for training; 2*N_active*D per forward token for serving."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the KV cache but that
    # is memory-, not FLOP-dominated — 2*N_active*B is the standard count.
    return 2.0 * n_active * shape.global_batch
