"""Fusion planner: the paper's optimization flow sizing the Hopper kernels.

The paper's flow (Sec. II-C) picks hardware + layer-group configuration by
evaluating candidates against constraints.  Here the "hardware config" is
a kernel tile shape and the constraint is the shared memory one Hopper
block may opt in to (``GPUSpec.smem_per_block_optin``, 232,448 bytes on an
H100): for attention (K2) and the MLP (K3) the planner takes the tile
shapes the kernel is built for, keeps those whose shared-memory working
set (the kernel modules' ``smem_bytes``) fits, and picks the largest.  The
model stack runs those kernels through :mod:`repro_torch.kernels.ops`.

``plan_model`` also runs the *layer-grouping* half of the flow over the
architecture's transformer-block IR (:func:`repro_torch.core.ir.transformer_block_ir`)
to report the per-block bandwidth saving of fused vs. layer-by-layer
execution; those verdicts (``bw_lbl_words``, ``bw_fused_words``,
``search_engine``, ``bw_saving``) equal the JAX reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import fusion
from . import ir as IR
from . import metrics as M
from .arch import H100, GPUSpec

ATTENTION_MIXERS = ("attn", "attn_local", "attn_chunked")


@functools.lru_cache(maxsize=256)
def _block_bandwidths(
    name: str,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    seq_len: int,
    ffn_act: str,
    n_experts: int,
    top_k: int,
) -> tuple[float, float, str]:
    """(layer-by-layer, fused, engine) Eq. (1) bandwidth of one transformer
    block plus the search-engine provenance of the fused grouping.

    Memoised on the block-shaping config fields + seq_len: building the
    block IR and running ``optimal_cuts`` dominate ``plan_model``, and
    callers ask for the same few (cfg, seq_len) points.
    """
    block_ir = IR.as_graph(IR.transformer_block_ir(
        name=name, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
        d_ff=d_ff, seq_len=seq_len, ffn_act=ffn_act, n_experts=n_experts,
        top_k=top_k,
    ))
    # fused grouping: {q,kv} | {qk, pv} (flash) | {o} | {w1/w3, w2} (fused MLP)
    dp = fusion.optimal_cuts(block_ir)
    bws = M.bandwidth_batch_graph(
        block_ir, np.stack([fusion.layer_by_layer_cuts(block_ir), dp.cuts])
    )
    return float(bws[0]), float(bws[1]), dp.engine


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Kernel tile choices for one (arch, seq_len) plus the evaluator's
    fused-vs-layer-by-layer bandwidth verdict.

    ``attn_vmem_bytes`` and ``mlp_vmem_bytes`` keep the reference's names
    so that a reader finds the counterpart, but hold the Hopper kernels'
    shared-memory bytes per block.  A config with no attention sublayer
    (falcon-mamba) has ``use_flash=False`` and zero attention tiles: there
    is no K2 launch to size.
    """

    arch: str
    seq_len: int
    # attention
    use_flash: bool
    attn_block_q: int
    attn_block_k: int
    attn_vmem_bytes: int
    # mlp
    use_fused_mlp: bool
    mlp_block_m: int
    mlp_block_f: int
    mlp_vmem_bytes: int
    # ssm
    mamba_chunk: int
    mamba_block_d: int
    # conv (vgg path)
    conv_block_c: int
    # evaluator outputs
    bw_fused_words: float
    bw_lbl_words: float
    # grouping-search provenance ("chain_dp" for transformer block chains)
    search_engine: str = ""

    @property
    def bw_saving(self) -> float:
        """Fractional DRAM-traffic reduction of fused over lbl."""
        return 1.0 - self.bw_fused_words / max(self.bw_lbl_words, 1.0)

    def describe(self) -> str:
        """One-line tiling + bandwidth-saving summary."""
        return (
            f"{self.arch}@{self.seq_len}: flash({self.attn_block_q}x"
            f"{self.attn_block_k}, {self.attn_vmem_bytes / 2**10:.1f}KiB) "
            f"mlp({self.mlp_block_m}x{self.mlp_block_f}, "
            f"{self.mlp_vmem_bytes / 2**10:.1f}KiB) "
            f"block-BW saving {self.bw_saving*100:.1f}%"
        )


def _largest_fitting(tiles, size, budget: int):
    """(a, b, bytes) of the largest-area tile whose ``size(a, b)`` fits
    ``budget`` (the first listed on a tie), or None."""
    best = None
    for a, b in tiles:
        n = size(a, b)
        if n <= budget and (best is None or a * b > best[0] * best[1]):
            best = (a, b, n)
    return best


def _plan_attention(hd: int, seq: int, spec: GPUSpec):
    """The largest built K2 tile (block_q, block_k) within ``seq`` whose
    shared memory fits one block, or (0, 0, 0) when K2 is not built for
    head width ``hd``."""
    from ..kernels.fused_attention import HEAD_DIMS, TILES, smem_bytes

    if hd not in HEAD_DIMS:
        return (0, 0, 0)
    tiles = [t for t in TILES if t[0] <= seq and t[1] <= seq] or [min(TILES)]
    best = _largest_fitting(tiles, lambda bq, bk: smem_bytes(bq, bk, hd),
                            spec.smem_per_block_optin)
    return best if best is not None else (0, 0, 0)


def _plan_mlp(ff: int, spec: GPUSpec):
    """The largest built K3 tile (block_m, block_f) with block_f <= ``ff``
    whose shared memory fits one block (it does not depend on d)."""
    from ..kernels.fused_mlp import TILES, smem_bytes

    tiles = [t for t in TILES if t[1] <= ff] or [min(TILES)]
    best = _largest_fitting(tiles, smem_bytes, spec.smem_per_block_optin)
    if best is None:
        raise ValueError(f"no fused_mlp tile fits {spec.smem_per_block_optin} "
                         "bytes of shared memory")
    return best


def plan_model(cfg, seq_len: int, spec: GPUSpec = H100) -> FusionPlan:
    """Plan kernel tilings for one config and score fused vs lbl traffic."""
    from ..kernels.fused_conv import BLOCK_C

    hd = cfg.resolved_head_dim
    has_attention = any(m in ATTENTION_MIXERS for m in cfg.layer_pattern)
    bq, bk, attn_b = _plan_attention(hd, seq_len, spec) if has_attention else (0, 0, 0)
    bm, bf, mlp_b = _plan_mlp(max(cfg.d_ff, cfg.d_model), spec)

    # Evaluator pass over one transformer block: fused vs layer-by-layer BW,
    # memoised per (cfg shape, seq_len).
    lbl, fused, engine = _block_bandwidths(
        cfg.name, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        max(cfg.d_ff, 1), seq_len, cfg.ffn_act, cfg.n_experts, cfg.top_k,
    )

    return FusionPlan(
        arch=cfg.name,
        seq_len=seq_len,
        use_flash=bq > 0,
        attn_block_q=bq,
        attn_block_k=bk,
        attn_vmem_bytes=attn_b,
        use_fused_mlp=cfg.d_ff > 0,
        mlp_block_m=bm,
        mlp_block_f=bf,
        mlp_vmem_bytes=mlp_b,
        mamba_chunk=64,
        mamba_block_d=min(512, cfg.d_inner),
        conv_block_c=BLOCK_C,
        bw_fused_words=fused,
        bw_lbl_words=lbl,
        search_engine=engine,
    )
