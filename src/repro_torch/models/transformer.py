"""Decoder-only transformer trunk — the port of the JAX package's
``models/transformer.py``.

A model is a sequence of **segments**; each segment is ``repeats`` copies
of a *superblock* (one period of the config's cyclic ``layer_pattern`` x
MoE placement).  The reference stacks a segment's parameters on a leading
``repeats`` axis and scans over it; here a segment is a Python list of
per-layer parameter dicts, looped over in Python.  The same trunk serves an
uncached forward, prefill (cache write) and decode (cache read-extend).
The cache's length is a Python int, so that no layer waits on the device
to read it.  Training (:func:`loss_fn`) runs the uncached forward with each
superblock under the run's activation checkpointing (:func:`_remat_wrap`).

Each sublayer is a mixer (full, sliding-window or chunked attention, or a
Mamba-1 SSM) followed by a dense FFN, an MoE FFN (with arctic's parallel
dense residual), or nothing when ``d_ff == 0`` (falcon-mamba's blocks are
mixer-only).  Local-attention sublayers may keep a window-sized ring cache
(``RunConfig.local_ring_cache`` with ``init_cache(ring=True)``).  The
encoder-decoder (seamless) runs through :mod:`repro_torch.models.encdec`;
:func:`check_supported` refuses it here.

On a mesh (``parallel.sharding.use_mesh``) each sublayer computes this
rank's share on the ``model`` axis (:mod:`repro_torch.models.layers`,
``moe``, ``ssm``); a superblock recomputed under the run's remat replays
its collectives in the same order on every rank.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..kernels import ops
from . import layers as L
from . import moe as MOE
from . import ssm as SSM


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    start_layer: int
    repeats: int
    kinds: tuple[tuple[str, bool], ...]  # (mixer, is_moe) per sublayer


def segments_of(cfg, n_layers: int | None = None) -> list[SegmentSpec]:
    """The config's layer stack as segments of repeated superblocks."""
    n = cfg.n_layers if n_layers is None else n_layers
    P = cfg.pattern_period
    segs: list[SegmentSpec] = []
    n_full, rem = divmod(n, P)
    if n_full:
        segs.append(SegmentSpec(0, n_full, cfg.sublayer_kinds(0, P)))
    if rem:
        segs.append(SegmentSpec(n_full * P, 1, cfg.sublayer_kinds(n_full * P, rem)))
    return segs


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config this trunk does not run:
    the encoder-decoder, which :mod:`repro_torch.models.model` dispatches to
    :mod:`repro_torch.models.encdec`."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder runs through models.encdec, not "
            "the decoder-only trunk")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_sublayer(gen: torch.Generator, cfg, mixer: str, is_moe: bool,
                   dtype) -> dict:
    sub: dict = {"norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
                 "norm2": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}
    if mixer == "mamba":
        sub["mamba"] = SSM.init_mamba(gen, cfg, dtype)
    else:
        sub["attn"] = L.init_attention(gen, cfg, dtype)
    if is_moe:
        sub["moe"] = MOE.init_moe(gen, cfg, dtype)
    elif cfg.d_ff > 0:
        sub["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype)
    else:
        del sub["norm2"]  # mamba-1 blocks: mixer only, no FFN sublayer
    return sub


def init_params(gen: torch.Generator, cfg) -> dict:
    """Parameters on ``gen``'s device, in ``cfg.dtype``, drawn from ``gen``
    with the reference's initialisation scales (not its random stream)."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    params: dict = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
        "segments": [
            [{f"sub{j}": _init_sublayer(gen, cfg, mixer, is_moe, dtype)
              for j, (mixer, is_moe) in enumerate(spec.kinds)}
             for _ in range(spec.repeats)]
            for spec in segments_of(cfg)
        ],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return params


def params_from_jax(tree: dict) -> dict:
    """The reference's parameter pytree (numpy arrays; each segment's
    leaves stacked on a leading ``repeats`` axis) as this module's
    parameters (one dict per layer), on the CPU.  Every leaf keeps its
    dtype, so a Mamba mixer's ``A_log``, ``D`` and ``dt_bias`` stay float32
    in a bfloat16 model."""

    def layer(node, r):
        if isinstance(node, dict):
            return {k: layer(v, r) for k, v in node.items()}
        return L.to_torch(np.asarray(node)[r])

    out = {k: L.to_torch(v) for k, v in tree.items() if k != "segments"}
    out["segments"] = []
    for seg in tree["segments"]:
        repeats = len(np.asarray(next(iter(_leaves(seg)))))
        out["segments"].append([layer(seg, r) for r in range(repeats)])
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, n_layers: int | None = None, *,
               ring: bool = False, device) -> dict:
    """Decode cache matching the segment structure, zeros: per attention
    sublayer ``{"k", "v": (batch, entries, KV, hd)}`` in ``cfg.dtype``, per
    Mamba sublayer ``{"conv": (batch, dc-1, di)}`` in ``cfg.dtype`` and
    ``{"h": (batch, di, ds)}`` in float32; and ``"len": 0``.  ``entries``
    is ``max_seq``, or with ``ring=True`` ``min(max_seq, window_size)`` for
    local-attention sublayers (the reference's decode lever: gemma3's local
    layers hold 1024 entries, not the whole context)."""
    dtype = getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim

    def sub_cache(mixer):
        if mixer == "mamba":
            return SSM.init_mamba_cache(cfg, batch, dtype, device)
        entries = max_seq
        if ring and mixer == "attn_local":
            entries = min(max_seq, cfg.window_size)
        shape = (batch, entries, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    segs = []
    for spec in segments_of(cfg, n_layers):
        segs.append([
            {f"sub{j}": sub_cache(mixer) for j, (mixer, _) in enumerate(spec.kinds)}
            for _ in range(spec.repeats)
        ])
    return {"segments": segs, "len": 0}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _sublayer(sub, x, cfg, rc, mixer, is_moe, positions, cache, cache_len,
              aux, kernels, attn_impl="chunked"):
    """One (mixer + FFN) sublayer.  Returns (x, new_cache, aux): an MoE
    sublayer adds its load-balance loss to ``aux``."""
    h = L.rmsnorm(sub["norm1"], x, cfg.rmsnorm_eps)
    if mixer == "mamba":
        out, new_cache = SSM.mamba_block(sub["mamba"], h, cfg, cache,
                                         scan=kernels.ssm_scan)
    else:
        attn_cache = None
        if cache is not None:
            attn_cache = {"k": cache["k"], "v": cache["v"], "len": cache_len}
        out, nc = L.attention_block(
            sub["attn"], h, cfg, mixer=mixer, positions=positions,
            cache=attn_cache, kv_block=rc.attn_chunk_kv,
            ring=(rc.local_ring_cache and mixer == "attn_local"),
            flash=kernels.attention, impl=attn_impl,
            flash_vjp=rc.flash_vjp, bf16_tiles=rc.attn_bf16_tiles,
        )
        new_cache = None if nc is None else {"k": nc["k"], "v": nc["v"]}
    x = x + out
    if "norm2" not in sub:
        return x, new_cache, aux
    h = L.rmsnorm(sub["norm2"], x, cfg.rmsnorm_eps)
    if is_moe:
        out, a = MOE.moe_block(sub["moe"], h, cfg, mlp=kernels.mlp)
        aux = aux + a
        return x + out, new_cache, aux
    return (x + L.mlp_block(sub["mlp"], h, cfg.ffn_act, fused=kernels.mlp, width=cfg.d_ff),
            new_cache, aux)


def block_forward(params, x, cfg, kinds, *, rc=None, attn_impl="reference",
                  kernels: ops.FusedKernels = ops.KERNELS) -> torch.Tensor:
    """A Python loop over ``kinds`` (as from ``cfg.sublayer_kinds``) of
    :func:`_sublayer` bodies, one parameter dict per sublayer, no cache,
    positions from 0 — the evaluator's tracing hook.  Every sublayer kind
    runs here, MoE included.  ``attn_impl="reference"`` computes each
    attention's scores whole, so only the SSM's scan (through ``kernels``'
    ``ssm_scan``) is a recurrence."""
    if rc is None:
        from ..configs.base import RunConfig

        rc = RunConfig()
    positions = range(x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sub, (mixer, is_moe) in zip(params, kinds):
        x, _, aux = _sublayer(sub, x, cfg, rc, mixer, is_moe, positions, None,
                              None, aux, kernels, attn_impl=attn_impl)
    return x


def sublayer_param_specs(cfg, kinds=None, *, dtype=torch.float32) -> list:
    """:func:`block_forward`'s parameters, one tree per sublayer, as
    ``device="meta"`` tensors shaped by the real initialiser (granite-34B
    costs nothing to spec)."""
    if kinds is None:
        kinds = cfg.sublayer_kinds(0, cfg.pattern_period)
    return L.param_specs_of(lambda gen: [
        _init_sublayer(gen, cfg, m, e, dtype) for m, e in kinds])


# The products whose outputs "dots" remat saves: what ``x @ w`` and the
# einsums dispatch to.
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, rc):
    """``fn`` under the run's activation checkpointing (``rc.remat``):
    ``"none"`` saves every activation; ``"dots"`` saves the matrix
    products' outputs and recomputes the rest in the backward (selective
    checkpointing, the reference's ``dots_saveable``); ``"full"`` saves only
    ``fn``'s inputs and recomputes it whole (``nothing_saveable``).  With
    grad mode off, ``fn`` itself.  A kernel launched inside ``fn`` (K2's
    forward) runs again in the backward under ``"dots"`` and ``"full"``."""
    if rc.remat == "none" or not torch.is_grad_enabled():
        return fn
    if rc.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
    elif rc.remat == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"remat {rc.remat!r}: none, dots or full")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def embed_inputs(params, cfg, batch: dict) -> torch.Tensor:
    """Token (+ frontend stub) embedding (B, S, d)."""
    tok_emb = L.embed_lookup(params["embed"], batch["tokens"], cfg.vocab_size)
    if cfg.frontend and "frontend" in batch:
        return torch.cat([batch["frontend"].to(tok_emb.dtype), tok_emb], dim=1)
    return tok_emb


def forward(params, cfg, rc, batch: dict, cache: dict | None = None, *,
            kernels: ops.FusedKernels = ops.KERNELS):
    """Trunk forward.  batch: {"tokens": (B, S), ["frontend": (B, Lf, d)]}.

    With ``cache``: incremental (prefill writes at [len, len+S), decode
    extends), positions offset by ``cache["len"]``; the KV buffers (full or
    ring) are written in place, a Mamba sublayer's conv inputs and state are
    replaced in the returned cache.  ``kernels`` names the attention, MLP
    and scan fusion groups (default: the kernels' wrappers; ``ops.PLAIN``
    for the plain versions).  Returns (hidden (B, S, d), new_cache | None,
    aux): ``aux`` is the float32 sum of the MoE sublayers' load-balance
    losses (0 without MoE), as the reference returns it.
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    start = cache["len"] if cache is not None else 0
    positions = range(start, start + x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_segs = []
    for i, spec in enumerate(segments_of(cfg)):
        new_seg = []
        for r in range(spec.repeats):
            layer_params = params["segments"][i][r]
            if cache is None:  # one superblock, under the run's remat
                def superblock(x, aux, layer_params=layer_params, kinds=spec.kinds):
                    for j, (mixer, is_moe) in enumerate(kinds):
                        x, _, aux = _sublayer(layer_params[f"sub{j}"], x, cfg, rc,
                                              mixer, is_moe, positions, None, start,
                                              aux, kernels)
                    return x, aux

                x, aux = _remat_wrap(superblock, rc)(x, aux)
                new_seg.append({})
                continue
            new_layer = {}
            for j, (mixer, is_moe) in enumerate(spec.kinds):
                sub_cache = cache["segments"][i][r][f"sub{j}"]
                x, nc, aux = _sublayer(layer_params[f"sub{j}"], x, cfg, rc, mixer,
                                       is_moe, positions, sub_cache, start, aux,
                                       kernels)
                if nc is not None:
                    new_layer[f"sub{j}"] = nc
            new_seg.append(new_layer)
        new_segs.append(new_seg)
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {"segments": new_segs, "len": start + x.shape[1]}
    return x, new_cache, aux


def lm_head_matrix(params, cfg) -> torch.Tensor:
    """(d, V): the tied embedding's transpose, or the separate head."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_last(params, cfg, rc, h: torch.Tensor) -> torch.Tensor:
    """Logits of the final position only (serving), float32."""
    return L.vocab_logits(h[:, -1:, :], lm_head_matrix(params, cfg), cfg.vocab_size)


def loss_fn(params, cfg, rc, batch: dict, *,
            kernels: ops.FusedKernels | None = None) -> tuple[torch.Tensor, dict]:
    """Next-token NLL (+ 0.01 x the MoE aux), float32.  Labels < 0 are
    ignored.  ``kernels`` defaults to ``ops.train_kernels(rc.mamba_chunk)``.
    Returns (loss, {"nll", "aux"})."""
    kernels = ops.train_kernels(rc.mamba_chunk) if kernels is None else kernels
    h, _, aux = forward(params, cfg, rc, batch, kernels=kernels)
    labels = batch["labels"]
    mask = labels >= 0
    nll = L.chunked_cross_entropy(h, lm_head_matrix(params, cfg),
                                  torch.clamp(labels, min=0).long(),
                                  chunk=rc.xent_chunk, mask=mask, vocab=cfg.vocab_size)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}
