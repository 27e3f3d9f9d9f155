"""Evaluation metrics — Eq. (1)-(4) of the paper, in edge-cut semantics.

Two implementations, kept deliberately in lock-step (tests assert equality):

* ``*_ref``      — direct, readable transcriptions of the equations operating
  on a :class:`~repro_torch.core.ir.GraphIR` (or a chain
  :class:`~repro_torch.core.ir.NetworkIR`, embedded losslessly via
  :func:`~repro_torch.core.ir.as_graph`) + a cut vector.  These are the
  oracle.
* ``evaluate_batch_graph`` — the batched sweep over a batch of hardware
  configurations (H) x a batch of fusion groupings (C), run as float64
  torch tensor code on the device.  Optional ``node_mask``/``edge_mask``
  arguments admit zero-padded inputs (shape buckets,
  :func:`~repro_torch.core.ir.pad_graph`) with padded rows exactly inert.

Grouping representation: a boolean *cut vector* over the graph's **edges**
(canonically sorted by ``(src, dst)``).  ``cuts[k]`` True means edge ``k``
crosses a fusion-group boundary.  The cost model per Eq. (1)-(4):

* a **cut** edge costs DRAM on both ends — the producer writes its output
  frame once (however many cut consumers it feeds), and each cut consumer
  reads the edge's ``words`` back;
* an **internal** (uncut) edge costs only SRAM, but its *pre-pool* frame
  must fit on chip (Eq. (4) sizing);
* source nodes always read their input frame from DRAM; sink nodes always
  write their output frame.

Exactness: every quantity of the raw sweep rows is an integer-valued
float64 word count below 2^53 or a dyadic fraction of one (latency divides
only by the power-of-two bus width; every area constant is dyadic), so the
sweep is bit-identical to the oracles however its sums are ordered — on
the CPU and on the GPU, where ``index_add`` accumulates with atomics in no
fixed order.  Energy multiplies by non-dyadic constants, so it is composed
on the host in numpy (:func:`compose_metrics`), in the oracle's term order.
The sweep runs eagerly: no ``torch.compile``, which could contract a
multiply and an add into one fused multiply-add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .arch import DLAConfig
from .errors import ConfigValidationError, GraphValidationError
from .ir import GraphIR, NetworkIR, as_graph

# Staging buffer (words) for tiles streamed directly from/to DRAM at group
# edges — a group's first input and last output never need full-frame SRAM.
STAGING_WORDS = 4096.0


def edge_io_masks(g: GraphIR, cuts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(reads_input, writes_output) node masks of shape (L,) for a cut vector.

    ``reads_input[i]``  — node i streams its *external* input frame from DRAM
    (only source nodes; cut-edge reads are accounted per edge, not here).
    ``writes_output[i]`` — node i writes its output frame to DRAM (sink node,
    or at least one outgoing edge is cut).
    """
    cuts = np.asarray(cuts, dtype=bool)
    if cuts.shape != (g.n_edges,):
        raise ValueError(f"cut vector shape {cuts.shape} != (E={g.n_edges},)")
    reads = g.source_mask.copy()
    writes = g.sink_mask.copy()
    for k, e in enumerate(g.edges):
        if cuts[k]:
            writes[e.src] = True
    return reads, writes


# ---------------------------------------------------------------------------
# Reference implementations (the paper's equations in edge-cut form)
# ---------------------------------------------------------------------------


def bandwidth_ref(ir: NetworkIR | GraphIR, cuts: np.ndarray) -> float:
    """Eq. (1): BW = sum_p { sum_q {N Nkh Nkw M}_Lpq + N Nih Niw + Noh Now M }_Lp.

    Edge-cut form: every node's weights stream from DRAM; every source node
    reads its input frame (plus any node's ``ext_in_words``); every cut edge
    is read back by its consumer; every node with a cut outgoing edge (or no
    consumer) writes its output frame once.
    """
    g = as_graph(ir)
    cuts = np.asarray(cuts, dtype=bool)
    reads, writes = edge_io_masks(g, cuts)
    bw = 0.0
    for i, n in enumerate(g.nodes):
        bw += n.weight_words  # every layer's weights stream from DRAM
        bw += n.ext_in_words  # edge-less activation operands (always DRAM)
        if reads[i]:
            bw += n.in_words  # external input frame read
        if writes[i]:
            bw += n.out_words  # group output frame write
    for k, e in enumerate(g.edges):
        if cuts[k]:
            bw += e.words  # cut tensor read back by the consumer
    return bw


def latency_ref(ir: NetworkIR | GraphIR, cuts: np.ndarray, hw: DLAConfig) -> float:
    """Eq. (2): L = sum_p { sum_q {t_rd_W + t_PB + t_PL}_Lpq + t_rd_IF + t_wr_OF }_Lp."""
    g = as_graph(ir)
    cuts = np.asarray(cuts, dtype=bool)
    reads, writes = edge_io_masks(g, cuts)
    lat = 0.0
    for i, n in enumerate(g.nodes):
        lat += n.weight_words / hw.dram_words_per_cycle  # t_rd_W
        lat += hw.pe_busy_cycles(  # t_PB
            macs=n.macs,
            n_in=n.contracted_channels,
            n_out=n.n_out,
            kh=n.kh,
            kw=n.kw,
            pixels_out=(n.h_in // n.stride) * (n.w_in // n.stride),
        )
        lat += hw.pipeline_latency  # t_PL
        lat += n.ext_in_words / hw.dram_words_per_cycle
        if reads[i]:
            lat += n.in_words / hw.dram_words_per_cycle  # t_rd_IF
        if writes[i]:
            lat += n.out_words / hw.dram_words_per_cycle  # t_wr_OF
    for k, e in enumerate(g.edges):
        if cuts[k]:
            lat += e.words / hw.dram_words_per_cycle  # cut tensor read back
    return lat


def sram_accesses_ref(ir: NetworkIR | GraphIR) -> float:
    """C_SRAM: every layer operand passes on-chip SRAM exactly once,
    independent of grouping (fusion only changes what *also* touches DRAM).

    A node's input traffic is max(in_words, sum of incoming edge words +
    edge-less ``ext_in_words``): multi-input nodes stream every fused
    operand through SRAM even though ``in_words`` describes a single frame.
    """
    g = as_graph(ir)
    in_edge = np.zeros(len(g.nodes))
    for e in g.edges:
        in_edge[e.dst] += e.words
    return float(
        sum(
            n.weight_words
            + max(n.in_words, in_edge[i] + n.ext_in_words)
            + n.out_words
            for i, n in enumerate(g.nodes)
        )
    )


def pe_energy_count_ref(ir: NetworkIR | GraphIR, hw: DLAConfig) -> float:
    """C_PE: busy cycles x pe_units (per-PE-cycle or per-block-cycle)."""
    g = as_graph(ir)
    total = 0.0
    for n in g.nodes:
        total += hw.pe_busy_cycles(
            macs=n.macs,
            n_in=n.contracted_channels,
            n_out=n.n_out,
            kh=n.kh,
            kw=n.kw,
            pixels_out=(n.h_in // n.stride) * (n.w_in // n.stride),
        )
    return total * hw.pe_units


def energy_ref(ir: NetworkIR | GraphIR, cuts: np.ndarray, hw: DLAConfig) -> float:
    """Eq. (3): E = E_DRAM*C_DRAM + E_SRAM*C_SRAM + E_PB*C_PB   [nJ]."""
    c_dram = bandwidth_ref(ir, cuts)
    c_sram = sram_accesses_ref(ir)
    c_pb = pe_energy_count_ref(ir, hw)
    return hw.e_dram_nj * c_dram + hw.e_sram_nj * c_sram + hw.e_pb_nj * c_pb


def buffer_words_ref(
    ir: NetworkIR | GraphIR, cuts: np.ndarray
) -> tuple[float, float, float]:
    """SRAM sizing (IF, W, OF) in words for Eq. (4).

    A node's IF SRAM must hold *all* of its internal incoming tensors
    simultaneously (one per uncut edge) plus its recurrent ``state_words``;
    its OF SRAM must hold the **pre-pool** output frame whenever any
    consumer is fused with it (the inline pool unit reduces the frame only
    on the DRAM write-out path).  Weight SRAM holds the largest single
    layer's kernels; group-edge tensors stream through staging buffers.
    """
    g = as_graph(ir)
    cuts = np.asarray(cuts, dtype=bool)
    if_need, of_need = STAGING_WORDS, STAGING_WORDS
    internal_in = np.zeros(len(g.nodes))
    internal_out = np.zeros(len(g.nodes), dtype=bool)
    for k, e in enumerate(g.edges):
        if not cuts[k]:
            internal_in[e.dst] += e.words
            internal_out[e.src] = True
    for i, n in enumerate(g.nodes):
        src = internal_in[i] if internal_in[i] > 0 else STAGING_WORDS
        src += float(n.state_words)
        dst = float(n.out_words_prepool) if internal_out[i] else STAGING_WORDS
        if_need = max(if_need, src)
        of_need = max(of_need, dst)
    w_need = max(float(n.weight_words) for n in g.nodes)
    return float(if_need), float(w_need), float(of_need)


def area_ref(ir: NetworkIR | GraphIR, cuts: np.ndarray, hw: DLAConfig) -> float:
    """Eq. (4): A = A_PB + A_IFM + A_WB + A_OFM   [um^2]."""
    if_w, w_w, of_w = buffer_words_ref(ir, cuts)
    return hw.area_um2(if_sram_words=if_w, w_sram_words=w_w, of_sram_words=of_w)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """The paper's four scores for one (graph, grouping, hw) candidate."""

    bandwidth_words: float
    latency_cycles: float
    energy_nj: float
    area_um2: float

    def meets(self, c) -> bool:
        """All four metrics within the :class:`Constraints` bounds."""
        return (
            self.bandwidth_words <= c.max_bandwidth_words
            and self.latency_cycles <= c.max_latency_cycles
            and self.energy_nj <= c.max_energy_nj
            and self.area_um2 <= c.max_area_um2
        )


def evaluate_ref(ir: NetworkIR | GraphIR, cuts: np.ndarray, hw: DLAConfig) -> Metrics:
    """Scalar-oracle Eq. (1)-(4) for one candidate (the lock-step ref)."""
    return Metrics(
        bandwidth_words=bandwidth_ref(ir, cuts),
        latency_cycles=latency_ref(ir, cuts, hw),
        energy_nj=energy_ref(ir, cuts, hw),
        area_um2=area_ref(ir, cuts, hw),
    )


# ---------------------------------------------------------------------------
# Batched numpy kernels — the search engine's scoring path
# ---------------------------------------------------------------------------
#
# The grouping search scores (C, E) cut batches with plain numpy on the
# host.  All sums are of integer-valued float64 words (< 2^53), so these
# are exactly equal to the scalar oracles, not just approximately.


@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """Cached numpy views of a GraphIR consumed by the batched kernels."""

    feat: np.ndarray  # (L, F)
    esrc: np.ndarray  # (E,)
    edst: np.ndarray  # (E,)
    ewords: np.ndarray  # (E,)
    src_mask: np.ndarray  # (L,) bool
    sink_mask: np.ndarray  # (L,) bool
    inc_src: np.ndarray  # (E, L) 1.0 at [k, esrc[k]]
    win_dst: np.ndarray  # (E, L) ewords[k] at [k, edst[k]]
    base_bw: float  # weights + unconditional source-frame reads


def graph_arrays(g: GraphIR) -> GraphArrays:
    """Per-instance memo (GraphIR is immutable, so this can never go stale);
    an attribute lookup rather than an lru_cache so the search loops do not
    re-hash the whole graph on every scoring call."""
    ga = g.__dict__.get("_graph_arrays")
    if ga is not None:
        return ga
    feat = g.node_features()
    esrc, edst, ewords = g.edge_arrays()
    E, L = len(esrc), len(g.nodes)
    inc_src = np.zeros((E, L))
    inc_src[np.arange(E), esrc] = 1.0
    win_dst = np.zeros((E, L))
    win_dst[np.arange(E), edst] = ewords
    src_mask, sink_mask = g.source_mask, g.sink_mask
    base_bw = float(
        feat[:, F_W].sum() + feat[:, F_EXT].sum() + feat[src_mask, F_IN].sum()
    )
    ga = GraphArrays(
        feat=feat, esrc=esrc, edst=edst, ewords=ewords, src_mask=src_mask,
        sink_mask=sink_mask, inc_src=inc_src, win_dst=win_dst,
        base_bw=base_bw,
    )
    object.__setattr__(g, "_graph_arrays", ga)
    return ga


def bandwidth_batch_graph(
    ir: NetworkIR | GraphIR, cuts_batch: np.ndarray
) -> np.ndarray:
    """(C,) Eq. (1) bandwidth for a (C, E) cut batch — bit-identical to
    :func:`bandwidth_ref` per row, with no per-candidate Python."""
    g = as_graph(ir)
    ga = graph_arrays(g)
    cuts = np.atleast_2d(np.asarray(cuts_batch, dtype=bool))
    cutf = cuts.astype(np.float64)
    writes = (cutf @ ga.inc_src) > 0.0  # (C, L): >= 1 cut outgoing edge
    writes |= ga.sink_mask[None, :]
    return (
        ga.base_bw
        + cutf @ ga.ewords  # cut tensors read back by their consumers
        + writes.astype(np.float64) @ ga.feat[:, F_OUT]
    )


# Feature column indices (must match NetworkIR.FEATURES order).
(F_W, F_IN, F_OUT, F_OUT_PRE, F_MACS, F_ISPOOL, F_KH, F_KW, F_NIN, F_NOUT,
 F_PIX, F_EXT, F_STATE) = range(13)
# HW row indices (must match DLAConfig.ROW_FIELDS order).
(H_F1, H_F2, H_F3, H_F4, H_MPP, H_DWPC, H_TPL, H_EDRAM, H_ESRAM, H_EPB,
 H_PEU) = range(11)


# ---------------------------------------------------------------------------
# The batched sweep — float64 torch tensor code on the device
# ---------------------------------------------------------------------------
#
# The raw (H, C, 5) plane is never built per (cut, hw) pair: every term of
# Eq. (1)-(4) splits into a part that depends only on the cut vector (the
# DRAM traffic, the Eq. (4) buffer needs), a part that depends only on the
# hardware row (t_PB, C_PB, the PE area) and graph constants.  The sweep
# computes (C,)-tables and (H,)-tables once and combines them into the
# plane by broadcasting, a slab of hardware rows at a time so that the
# (rows, C) temporaries stay within SWEEP_SLAB_BYTES.

# Bytes of (rows, C) float64 temporaries one slab of the combine may hold.
SWEEP_SLAB_BYTES = 1 << 30


def _ceil_div(a, b):
    """``ceil(a / b)`` exactly as the oracles round it (not floor division)."""
    return torch.ceil(a / b)


def _pe_busy_cycles_vec(feat: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """t_PB per (hw row, layer): (H, L) — branch on PE style per row."""
    col = lambda j: feat[None, :, j]  # noqa: E731 - (1, L) feature column
    row = lambda j: hw[:, j, None]  # noqa: E731 - (H, 1) hardware field
    co = _ceil_div(col(F_NOUT), row(H_F1))
    ci = _ceil_div(col(F_NIN), row(H_F4))
    px_h = _ceil_div(col(F_PIX), row(H_F2) * row(H_F3))  # hsiao: F2*F3 pixels
    kc_h = _ceil_div(col(F_KH) * col(F_KW), 9.0)
    px_v = _ceil_div(col(F_PIX), row(H_F2))  # vwa: F2 rows
    kc_v = col(F_KH) * _ceil_div(col(F_KW), 3.0)
    is_hsiao = row(H_MPP) == 9
    cyc = torch.where(is_hsiao, co * ci * px_h * kc_h, co * ci * px_v * kc_v)
    return torch.where(col(F_MACS) > 0, cyc, 0.0)


def _cut_tables(feat, esrc, edst, ewords, src_mask, sink_mask, cuts,
                node_mask, edge_mask):
    """The cut-only terms: (C,) tensors plus graph scalars."""
    C, L = cuts.shape[0], feat.shape[0]
    zeros_cl = lambda: torch.zeros((C, L), dtype=feat.dtype, device=feat.device)  # noqa: E731
    idx_src = esrc[None, :].expand(C, -1)
    # A padded edge is inert on both sides of the cut/internal split.
    cut_real = cuts & edge_mask[None, :]
    internal_real = (~cuts) & edge_mask[None, :]
    cutf = cut_real.to(feat.dtype)

    # Node write mask: sink, or >= 1 cut outgoing edge (scatter-max over src).
    any_out_cut = zeros_cl().scatter_reduce(
        1, idx_src, cutf, "amax", include_self=True) > 0.5
    writes = any_out_cut | sink_mask[None, :]

    # Eq. (1) — ext_in_words are edge-less operands, read in every grouping
    read_src = torch.sum(torch.where(src_mask, feat[:, F_IN], 0.0)) + torch.sum(
        feat[:, F_EXT]
    )
    read_edges = torch.sum(torch.where(cut_real, ewords[None, :], 0.0), dim=1)
    write_out = torch.sum(torch.where(writes, feat[None, :, F_OUT], 0.0), dim=1)
    w_sum = torch.sum(feat[:, F_W])
    bw = w_sum + read_src + read_edges + write_out

    # Eq. (3) — per-node input SRAM traffic is max(in_words, incoming edges)
    # so multi-input nodes count every operand (see sram_accesses_ref).
    in_edge = torch.zeros(L, dtype=feat.dtype, device=feat.device).index_add(
        0, edst, torch.where(edge_mask, ewords, 0.0)
    )
    c_sram = torch.sum(
        feat[:, F_W]
        + torch.maximum(feat[:, F_IN], in_edge + feat[:, F_EXT])
        + feat[:, F_OUT]
    )

    # Eq. (4): internal incoming tensors coexist in IF SRAM; a node with any
    # fused consumer holds its *pre-pool* frame in OF SRAM.
    internal_in = zeros_cl().index_add(
        1, edst, torch.where(internal_real, ewords[None, :], 0.0)
    )
    any_out_internal = zeros_cl().scatter_reduce(
        1, idx_src, internal_real.to(feat.dtype), "amax", include_self=True
    ) > 0.5
    src_need = (
        torch.where(internal_in > 0, internal_in, STAGING_WORDS)
        + feat[None, :, F_STATE]
    )
    dst_need = torch.where(any_out_internal, feat[None, :, F_OUT_PRE],
                           STAGING_WORDS)
    if_need = torch.clamp(torch.amax(src_need, dim=1), min=STAGING_WORDS)
    of_need = torch.clamp(torch.amax(dst_need, dim=1), min=STAGING_WORDS)
    w_need = torch.amax(feat[:, F_W])
    n_real = torch.sum(node_mask.to(feat.dtype))
    return dict(
        w_sum=w_sum, read_src=read_src, read_edges=read_edges,
        write_out=write_out, bw=bw, c_sram=c_sram, if_need=if_need,
        w_need=w_need, of_need=of_need, n_real=n_real,
    )


def _evaluate_batch_graph(
    feat: torch.Tensor,  # (L, F) float64
    esrc: torch.Tensor,  # (E,) int64
    edst: torch.Tensor,  # (E,) int64
    ewords: torch.Tensor,  # (E,) float64
    src_mask: torch.Tensor,  # (L,) bool — in-degree 0
    sink_mask: torch.Tensor,  # (L,) bool — out-degree 0
    cuts_batch: torch.Tensor,  # (C, E) bool
    hw_rows: torch.Tensor,  # (H, 11) float64
    area_consts: torch.Tensor,  # (4,) float64
    node_mask: torch.Tensor | None = None,  # (L,) bool; None = no padding
    edge_mask: torch.Tensor | None = None,  # (E,) bool; None = no padding
) -> torch.Tensor:
    """RAW (H, C, 5) rows [bw, lat, c_sram, c_pb, area] on the inputs'
    device; :func:`compose_metrics` turns them into [bw, lat, energy, area].

    ``node_mask``/``edge_mask`` admit zero-padded inputs: a padded edge is
    neither cut nor internal regardless of its ``cuts`` bit, and a padded
    node contributes no pipeline latency.  Padded feature rows are all-zero,
    so every padded term is exactly 0.0 (or the STAGING_WORDS floor in the
    Eq. (4) maxes) and padded evaluation is bit-identical to unpadded.
    """
    if node_mask is None:
        node_mask = torch.ones(feat.shape[0], dtype=torch.bool, device=feat.device)
    if edge_mask is None:
        edge_mask = torch.ones(esrc.shape[0], dtype=torch.bool, device=feat.device)
    t = _cut_tables(feat, esrc, edst, ewords, src_mask, sink_mask,
                    cuts_batch, node_mask, edge_mask)
    H, C = hw_rows.shape[0], cuts_batch.shape[0]
    a_mult, a_pe_ovh, a_byte, a_ctrl = area_consts
    # (C,) and scalar terms as (1, C) rows against (rows, 1) hardware columns
    read_io = (t["read_src"] + t["read_edges"])[None, :]
    write_out = t["write_out"][None, :]
    bw = t["bw"][None, :]
    sram_words = (t["if_need"] + t["w_need"] + t["of_need"])[None, :]

    out = torch.empty((H, C, 5), dtype=feat.dtype, device=feat.device)
    rows = max(1, SWEEP_SLAB_BYTES // (8 * 8 * max(C, 1)))
    for h0 in range(0, H, rows):
        hw = hw_rows[h0:h0 + rows]
        t_pb = torch.sum(_pe_busy_cycles_vec(feat, hw), dim=1)[:, None]
        dwpc = hw[:, H_DWPC, None]
        # Eq. (2) — term order as the oracle's accumulation
        lat = (
            t["w_sum"] / dwpc
            + t_pb
            + t["n_real"] * hw[:, H_TPL, None]
            + read_io / dwpc
            + write_out / dwpc
        )
        n_pes = hw[:, H_F1] * hw[:, H_F4] * hw[:, H_F2] * hw[:, H_F3]
        area = (
            (n_pes * (hw[:, H_MPP] * a_mult + a_pe_ovh))[:, None]
            + sram_words * a_byte
            + a_ctrl
        )
        slab = out[h0:h0 + rows]
        slab[:, :, 0] = bw
        slab[:, :, 1] = lat
        slab[:, :, 2] = t["c_sram"]
        slab[:, :, 3] = t_pb * hw[:, H_PEU, None]
        slab[:, :, 4] = area
    return out


def compose_metrics(raw, hw_rows) -> np.ndarray:
    """(…, H, C, 5) raw sweep rows -> (…, H, C, 4) [bw, lat, energy, area].

    Eq. (3) is composed here, on the host in numpy: separate multiply and
    add passes cannot be fused into one multiply-add, so the energy is
    bit-identical to :func:`energy_ref`, whose term order it follows.
    """
    raw = np.asarray(raw)
    hw = np.asarray(hw_rows)
    bw, lat, c_sram, c_pb, area = np.moveaxis(raw, -1, 0)
    # (H, 1) factors broadcast against (…, H, C) metric planes.
    e_dram = hw[:, H_EDRAM, None]
    e_sram = hw[:, H_ESRAM, None]
    e_pb = hw[:, H_EPB, None]
    energy = e_dram * bw + e_sram * c_sram + e_pb * c_pb
    return np.stack([bw, lat, energy, area], axis=-1)


# ---------------------------------------------------------------------------
# Finite guard — poison detection on raw result planes
# ---------------------------------------------------------------------------

# The bit-identity discipline: every raw row is an exact integer-valued
# float64, so any count above 2^53 has silently lost ulps.
MAX_EXACT_WORDS = float(2 ** 53)


def poison_mask(raw) -> np.ndarray:
    """(…, 5) raw rows -> (…,) bool mask of *poisoned* cells.

    A cell is poisoned when any entry is NaN, +/-Inf, negative, or above
    ``2**53`` — any such row would silently corrupt the argmin, so
    :mod:`repro_torch.core.flow` excludes these cells *before* selection and
    reports them with (g, h, c) provenance instead.
    """
    raw = np.asarray(raw)
    bad = ~np.isfinite(raw) | (raw < 0.0) | (raw > MAX_EXACT_WORDS)
    return np.any(bad, axis=-1)


def assert_exact_f64(arr, *, what: str = "feature table") -> None:
    """Assert ``arr`` holds exactly-representable f64 word counts: finite,
    non-negative, integer-valued and at most ``2**53``.  Raises
    :class:`GraphValidationError` naming ``what`` and the first offending
    flat index."""
    a = np.asarray(arr, dtype=np.float64)
    bad = ~np.isfinite(a) | (a < 0.0) | (a > MAX_EXACT_WORDS) | (
        a != np.floor(a)
    )
    if bad.any():
        idx = int(np.flatnonzero(bad.ravel())[0])
        raise GraphValidationError(
            f"{what} is not exactly representable in f64: entry at flat "
            f"index {idx} is {a.ravel()[idx]!r} (must be a finite, "
            f"non-negative integer <= 2**53 for bit-exact evaluation)"
        )


def sweep_tensors(args, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The numpy sweep arguments (``feat, esrc, edst, ewords, src_mask,
    sink_mask, cuts_batch, hw_rows, area_consts[, node_mask, edge_mask]``)
    as tensors on ``device``; float arrays as float64, ``None`` kept."""
    out = []
    for a in args:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float64, copy=False)
        if not a.flags.writeable:  # e.g. the memoised exhaustive cut batch
            a = a.copy()
        out.append(torch.as_tensor(a, device=device))
    return tuple(out)


def evaluate_raw_graph(*args, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """RAW (H, C, 5) sweep rows for numpy arguments (the argument list of
    :func:`evaluate_batch_graph`), left on ``device``."""
    dev = resolve_device(device)
    return _evaluate_batch_graph(*sweep_tensors(args, dev))


def evaluate_batch_graph(
    feat,
    esrc,
    edst,
    ewords,
    src_mask,
    sink_mask,
    cuts_batch,
    hw_rows,
    area_consts,
    node_mask=None,
    edge_mask=None,
    *,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """All metrics for every (hw, grouping) pair -> (H, C, 4) numpy.

    The sweep runs in float64 on ``device``; the raw plane comes back to the
    host and :func:`compose_metrics` composes energy there.  The optional
    node/edge masks admit zero-padded (shape-bucketed) inputs; with masks of
    all-True (or None) this is exactly the unpadded evaluator.
    """
    raw = evaluate_raw_graph(
        feat, esrc, edst, ewords, src_mask, sink_mask, cuts_batch, hw_rows,
        area_consts, node_mask, edge_mask, device=device,
    ).cpu().numpy()
    return compose_metrics(raw, hw_rows)


def area_consts_of(hw: DLAConfig) -> np.ndarray:
    """The per-config area-calibration constants as a feature row."""
    return np.asarray(
        [
            hw.area_per_mult_um2,
            hw.area_per_pe_overhead_um2,
            hw.area_per_sram_byte_um2,
            hw.area_controller_um2,
        ],
        dtype=np.float64,
    )


def area_consts_of_space(config_space) -> np.ndarray:
    """Shared area constants of a config space, validating they ARE shared.

    The sweep takes one ``area_consts`` vector for the whole hardware batch
    (only row fields vary per config), so a space mixing area calibrations
    would silently evaluate every config under ``config_space[0]``'s
    constants — reject it instead."""
    consts = {
        (
            c.area_per_mult_um2,
            c.area_per_pe_overhead_um2,
            c.area_per_sram_byte_um2,
            c.area_controller_um2,
        )
        for c in config_space
    }
    if len(consts) != 1:
        raise ConfigValidationError(
            f"config space mixes {len(consts)} area-constant calibrations; "
            "the sweep shares one area_consts vector across the hardware "
            "batch — sweep each calibration separately"
        )
    return area_consts_of(config_space[0])


def pareto_front_mask(rows: np.ndarray) -> np.ndarray:
    """Boolean mask of the Pareto-optimal rows of an (N, M) metric matrix,
    minimising every column.

    A row is kept iff no other row is <= it in every column and < in at
    least one.  Exact-duplicate metric rows keep only their FIRST
    occurrence (lowest index) — the same convention as the flow's argmin
    tie-break.  Rows are scanned in lexicographic order, in which any
    dominator of a row precedes it, so each row is tested against the
    accumulated front only.
    """
    rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
    n = rows.shape[0]
    mask = np.zeros(n, dtype=bool)
    if n == 0:
        return mask
    uniq, first_idx = np.unique(rows, axis=0, return_index=True)
    front = np.empty_like(uniq)
    k = 0
    for i, r in enumerate(uniq):
        # uniq rows are distinct, so componentwise <= already implies
        # strict dominance somewhere.
        if k and np.all(front[:k] <= r, axis=1).any():
            continue
        front[k] = r
        k += 1
        mask[first_idx[i]] = True
    return mask
