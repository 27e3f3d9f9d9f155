"""Mixture-of-Experts FFN with GShard-style group-limited capacity routing
— the port of the JAX package's ``models/moe.py``.

Tokens are reshaped to ``(groups, group_size)`` and each group routes
independently to per-expert capacity slots, ``C = ceil(top_k * Sg / E *
capacity_factor)`` of them an expert; over-capacity claims are dropped
(combine weight 0), earlier tokens and lower k winning the slots.  The
experts then run on one of two paths, the same arithmetic on the same kept
claims:

* **Capacity.** The dispatch and combine one-hots are ``(G, Sg, E, C)``,
  built as ``idx[..., None] == arange(E)`` (what ``jax.nn.one_hot``
  computes); a one-hot product gathers each slot's token, the experts run
  batched over all ``G * C`` slots of each, empty or not, and a one-hot
  product weighs and sums them back.  It is the reference's program: the
  CPU tests compare it with the JAX package, and the tracing frontend
  (``core/frontend.py::moe_block_graph``) draws the evaluator's graph from
  it on ``meta`` tensors.  It needs no read to the host and launches a
  few batched products, so on the card it also serves where the padding
  costs little: while ``G * C`` stays under :data:`SORTED_MIN_ROWS` an
  expert's products are bound by reading its weights.  ``G * C`` grows
  with the tokens: that is a decode step of a few requests, and with 128
  experts (C 8 or 16 a group of 512) a prefill of up to ~18,000 or ~9,000
  tokens.  (A decode step of 16 or 128 experts reads the weights of
  experts that no claim reached, which the sorted path skips; no rule of
  the input has yet told those steps from mixtral's, PERF.md.)
* **Sorted** (:func:`_experts_sorted`). On the card, with every expert
  whole on this device, once ``G * C`` reaches :data:`SORTED_MIN_ROWS`:
  the kept claims are ordered by expert, their tokens' rows gathered into
  one contiguous buffer, each expert's three products run on exactly its
  rows (one read of the experts' row counts to the host a call), and each
  token gathers its claims' rows back and sums them, weighed, in float32.
  The padded rows, half of them at capacity factor 2, are never computed.

On a mesh (``parallel.sharding.use_mesh``), expert weights with fewer
experts than the config are this rank's experts on the ``model`` axis
(expert parallelism): the router runs replicated, each rank dispatches to,
computes and combines its own experts, and one all-reduce over ``model``
adds the ranks' outputs.  When the experts do not split over the axis
(mixtral's 8 on 16 ranks) each rank holds its columns of every expert's
d_ff instead, and computes those.  Either way the capacity path runs.  The
load-balance statistics are summed over the data axes before their
product, so the term is the whole microbatch's, as the reference's GSPMD
program computes it.  The groups are the reference's: the group size comes
from the whole microbatch's tokens.

With tracing on (:mod:`repro_torch.runtime.spans`) the router through the
dispatch product or gather, the expert products and the combine run in the
spans ``repro_torch.moe.dispatch``, ``.experts`` and ``.combine``, and each
layer counts its routed claims (``moe.claims``), those within capacity
(``moe.kept``), the capacity slots of every expert (``moe.slots``) and the
rows its expert products ran on (``moe.rows``: every slot of this rank's
experts on the capacity path, the kept claims on the sorted one).
"""
from __future__ import annotations

import math

import torch

from ..kernels import ref
from ..parallel import sharding as SH
from ..runtime import spans
from . import layers as L
from .layers import params_from_jax  # noqa: F401  (the reference tree as tensors)


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    """One MoE FFN's parameters drawn from ``gen`` with the reference's
    scales: the router ``(d, E)`` in float32, experts ``w1``/``w3`` ``(E, d,
    ff)`` and ``w2`` ``(E, ff, d)`` in ``dtype``, and arctic's parallel
    dense MLP when ``cfg.dense_residual_ff``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device
    scale = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    # scaled in place: an expert stack's float32 draw (17.8 GB for one of
    # arctic's) is then the only temporary beside the weights made so far
    p = {
        "router": normal(d, E).mul_(scale),  # fp32: routing is precision-sensitive
        "w1": normal(E, d, ff).mul_(scale).to(dtype),
        "w2": normal(E, ff, d).div_(math.sqrt(ff)).to(dtype),
    }
    if cfg.ffn_act in L.GATED_ACTS:
        p["w3"] = normal(E, d, ff).mul_(scale).to(dtype)
    if cfg.dense_residual_ff:
        p["dense_residual"] = L.init_mlp(gen, d, cfg.dense_residual_ff,
                                         cfg.ffn_act, dtype)
    return p


def moe_param_specs(cfg, *, dtype=torch.float32) -> dict:
    """:func:`init_moe`'s tree as ``device="meta"`` tensors (nothing
    materialised; the tracing frontend's hook)."""
    return L.param_specs_of(lambda gen: init_moe(gen, cfg, dtype))


# An expert's padded rows G * C from which its products are bound by their
# operations rather than by reading its weights, so that the sorted path
# saves time: an (n, d) x (d, ff) product in bfloat16 does n operations a
# byte of weight, against the H100's 989 TFLOP/s over 3.35 TB/s.  Measured
# on one layer of mixtral, jamba, llama4 and arctic, the sorted path loses
# by up to 3x below 256 rows (its host read, its launches an expert) and
# wins from 512, but at a decode step of 16 or 128 experts (PERF.md).
SORTED_MIN_ROWS = 295


def _capacity(cfg, group_size: int) -> int:
    c = math.ceil(cfg.top_k * group_size / cfg.n_experts * cfg.capacity_factor)
    return max(c, 1)


def route_topk(router_logits: torch.Tensor, top_k: int, *, renormalize: bool = True):
    """(..., E) logits -> (gates, indices, probs); gates and indices are
    (..., top_k).  With ``renormalize`` the gates are rescaled to sum to 1
    (mixtral); without, they are the top-k softmax probabilities as drawn
    (jamba)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx, probs


def moe_block(params: dict, x: torch.Tensor, cfg, *, mlp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN.  x: (B, S, d) -> (y (B, S, d), aux load-balance loss).

    ``mlp`` is the fusion group of arctic's dense residual, as
    ``layers.mlp_block``'s ``fused`` (default: the fused-MLP wrapper)."""
    B, S, d = x.shape
    ctx = SH.ambient()
    n_data = 1 if ctx is None else ctx.data_size
    if n_data > 1 and min(cfg.moe_group_size, B * S * n_data) > B * S:
        # The reference's groups span the data ranks' rows (a decode step's
        # few tokens): route the whole microbatch on every data rank.
        y, aux = _moe(params, SH.gather_data(x), cfg, mlp, 1)
        return y.narrow(0, ctx.data_rank * B, B), aux
    return _moe(params, x, cfg, mlp, n_data)


def _moe(params: dict, x: torch.Tensor, cfg, mlp, n_data: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_block` on ``x``, one of ``n_data`` data ranks' rows."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    Sg = min(cfg.moe_group_size, T * n_data)  # the whole microbatch's group size
    G = T // Sg
    if G * Sg != T:
        raise ValueError(f"tokens {T} not divisible by group size {Sg}")
    dev, dt = x.device, x.dtype
    xg = x.reshape(G, Sg, d)

    with spans.span(spans.MOE_DISPATCH):
        router = params["router"]  # float32 x float32, promoted as jnp does
        logits = xg.float().to(torch.promote_types(torch.float32, router.dtype)) @ router
        gates, idx, probs = route_topk(logits, K,  # (G, Sg, K)
                                       renormalize=cfg.moe_renormalize)

        # Load-balance aux loss (Switch): E * sum_e f_e * p_e, both statistics
        # over the whole microbatch (summed over the data axes).
        experts = torch.arange(E, device=dev)
        top1 = (idx[..., 0, None] == experts).float()
        if n_data == 1:
            me, fe = probs.mean(dim=(0, 1)), top1.mean(dim=(0, 1))
        else:
            n_tok = float(G * Sg * n_data)
            me = SH.sum_data(probs.sum(dim=(0, 1))) / n_tok
            fe = SH.sum_data(top1.sum(dim=(0, 1))) / n_tok
        aux = E * torch.sum(fe * me)

        C = _capacity(cfg, Sg)
        # Position of each (token, k) claim within its expert's capacity, the
        # (Sg, K) claims flattened token-major so earlier tokens win slots.
        claims = (idx[..., None] == experts).to(dt)  # (G, Sg, K, E)
        flat = claims.reshape(G, Sg * K, E)
        pos = torch.cumsum(flat.float(), dim=1).to(dt) - flat
        keep = torch.where(pos < C, flat, torch.zeros((), dtype=dt, device=dev))
        spans.count("moe.claims", G * Sg * K)
        spans.count("moe.kept", keep)  # summed in int64: keep is 0/1 in dt
        spans.count("moe.slots", G * E * C)  # every expert's, the ranks' together

    # This rank's experts (E off a mesh), or, when the experts do not split
    # over the model axis, its columns of every expert's d_ff.
    split = params["w1"].shape[0] < E or params["w1"].shape[-1] < cfg.d_ff
    if _sorted(x, split, G * C):
        y = _experts_sorted(params, xg.reshape(T, d), idx.reshape(T, K),
                            gates.reshape(T, K), keep.reshape(T * K, E), cfg)
    else:
        y = _experts_capacity(params, xg, gates, pos, keep, C, cfg, split)

    if "dense_residual" in params:  # arctic: parallel dense MLP
        y = y.reshape(G, Sg, d) + L.mlp_block(params["dense_residual"], xg, cfg.ffn_act,
                                              fused=mlp, width=cfg.dense_residual_ff)
    return y.reshape(B, S, d), aux


def _sorted(x: torch.Tensor, split: bool, rows: int) -> bool:
    """Whether the experts run on the kept claims sorted by expert: on the
    card, with every expert whole on this device, once the capacity path's
    ``rows`` (G * C) an expert would make its products compute-bound."""
    return x.is_cuda and not split and rows >= SORTED_MIN_ROWS


def _experts_capacity(params: dict, xg: torch.Tensor, gates: torch.Tensor,
                      pos: torch.Tensor, keep: torch.Tensor, C: int, cfg, split: bool
                      ) -> torch.Tensor:
    """The experts on every capacity slot.  xg (G, Sg, d); gates (G, Sg, K);
    pos, keep (G, Sg * K, E): each claim's slot and whether it is kept ->
    y (G, Sg, d), this rank's share on a mesh summed over ``model``."""
    G, Sg, d = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    El = params["w1"].shape[0]
    dev, dt = xg.device, xg.dtype
    spans.count("moe.rows", G * El * C)
    with spans.span(spans.MOE_DISPATCH):
        slots = torch.arange(C, device=dev)
        pos_oh = (pos.to(torch.int32)[..., None] == slots).to(dt) * keep[..., None]
        disp_flat = pos_oh.reshape(G, Sg, K, E, C)

        dispatch = disp_flat.sum(dim=2)  # (G, Sg, E, C): <= 1 slot per expert
        combine = torch.einsum("gskec,gsk->gsec", disp_flat, gates.to(dt))

        xe_in = xg
        if split:
            combine = SH.enter_model(combine)
            xe_in = SH.enter_model(xg)
        if El < E:
            mine = SH.head_slice(E, El)
            dispatch = dispatch[:, :, mine]
            combine = combine[:, :, mine]

        # The products are written out so that each takes its operands in the
        # order of the reference's dot_generals (the one-hots on the left): a
        # traced graph then gives the dispatch and combine actmuls the
        # reference's frames, whatever path torch.einsum would choose.
        xe = (dispatch.permute(0, 2, 3, 1).reshape(G, El * C, Sg) @ xe_in).reshape(G, El, C, d)

    with spans.span(spans.MOE_EXPERTS):
        def per_expert(a, w):  # (G, E, C, i) x (E, i, o) -> (G, E, C, o)
            o = a.transpose(0, 1).reshape(El, G * C, a.shape[-1]) @ w
            return o.reshape(El, G, C, w.shape[-1]).transpose(0, 1)

        h = per_expert(xe, params["w1"])
        if cfg.ffn_act in L.GATED_ACTS:
            h = ref.activation(h, cfg.ffn_act) * per_expert(xe, params["w3"])
        else:
            h = ref.activation(h, cfg.ffn_act)
        ye = per_expert(h, params["w2"])
    with spans.span(spans.MOE_COMBINE):
        y = combine.reshape(G, Sg, El * C) @ ye.reshape(G, El * C, d)
        if split:
            y = SH.leave_model(y)
    return y


def _experts_sorted(params: dict, x: torch.Tensor, idx: torch.Tensor,
                    gates: torch.Tensor, keep: torch.Tensor, cfg) -> torch.Tensor:
    """The experts on the kept claims alone, every expert whole here.  x
    (T, d); idx, gates (T, K): the routes; keep (T * K, E): the capacity
    path's kept claims, token-major -> y (T, d) in ``x.dtype``.

    The capacity path's arithmetic on its non-empty rows: a gather takes the
    rows its one-hot product selects (the same bits), each expert's products
    see exactly its kept claims, and each token sums its claims' ``ye *
    gate`` in float32 and rounds once, as the one-hot combine product
    accumulates.  Differentiable: the backward of each gather is a
    scatter-add, of the split and the unbound weights one concatenation."""
    T, d = x.shape
    K, E = idx.shape[-1], keep.shape[-1]
    with spans.span(spans.MOE_DISPATCH):
        # Each claim's expert, E for a dropped one: the stable sort orders the
        # claims by expert, an expert's in token order, and the dropped last.
        expert = torch.where(keep.any(dim=-1), idx.reshape(-1), E)
        claim = torch.argsort(expert, stable=True)
        xs = x.index_select(0, claim // K)
        place = torch.empty_like(claim).index_copy_(  # each claim's row in that order
            0, claim, torch.arange(T * K, device=x.device))
        # the call's one read to the host, once the gathers are queued
        rows = keep.sum(dim=0, dtype=torch.int64).tolist()
        n = sum(rows)
    spans.count("moe.rows", n)
    with spans.span(spans.MOE_EXPERTS):
        w3 = params["w3"].unbind(0) if cfg.ffn_act in L.GATED_ACTS else (None,) * E
        ye = torch.cat([ref.mlp(a, w1, w2, w3e, act=cfg.ffn_act) for a, w1, w2, w3e in
                        zip(xs[:n].split(rows), params["w1"].unbind(0), params["w2"].unbind(0), w3)
                        if a.shape[0]] + [x.new_zeros(1, d)])  # row n: a dropped claim's
    with spans.span(spans.MOE_COMBINE):
        ye = ye.index_select(0, place.clamp_max(n)).view(T, K, d)
        y = (ye * gates.to(x.dtype).float()[..., None]).sum(dim=1)  # float32 products
    return y.to(x.dtype)
