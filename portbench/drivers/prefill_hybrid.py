"""The prefill driver of a hybrid model (Mamba-1 mixers beside attention,
``configs/jamba2-mini.json``): the closed loop of ``prefill.py`` (one
batch in flight, prompts of the traffic's lengths in seeded groups, the
first token brought to the host), through the port's ``make_prefill_step``
and its cache, with the configuration's Mamba leaves.

Set-up first lays the weights' shapes out as the port's parameter tree
and checks it against the port's ``abstract_params`` (a port without the
configuration's leaves fails there, before any kernel is built), then
builds the kernels, draws the weights and serves one batch of each length.
The window and the traced run are ``prefill.py``'s; the span window runs
with the port's spans on (``spans.enabled``), and the readers get its
prompt tokens (``span_tokens``) and the port's counters
(``port_counters``) beside the attention calls and the model FLOPs.

The check (:func:`check`) compares, for the sampled batches, against the
plain reference (``reference/<reference>.py``) run over the same prompts:
``logit_err``, the lower quartile of the sampled requests' relative logit
errors at the last position (the requests of every sampled batch taken
together: a batch here is one prompt, and a route that flips at a near
tie, as rounding alone can make it, moves one prompt's logits by up to
four times the others'); ``kv_err``, over the attention layers,
K and V and every request, the worst relative error of one block of
:data:`KV_BLOCK` positions (their keys, or values, of all heads as one
vector), so that a fault on a few hundred positions (a state not carried
across a chunk of time) shows, while one token whose route flips at a near
tie, as rounding alone can make it, does not decide it alone;
``state_err``, over the Mamba layers, the worst relative error of a
request's final state h or of its convolution inputs; ``mamba_f32_err``,
the port's Mamba mixer of layer 0 (``ssm.mamba_block`` with the timed
path's scan, chunked in time as served) run in float32 on the reference's
own float32 input of that layer (:func:`port_mixer`), the worst relative
error of a request's mixer output or final state against the reference's
mixer on the same input: the configuration states float32 for the
discretisation and the scan state, and the other numbers, read through
bfloat16 layers, cannot tell a bfloat16 state from a float32 one.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import compare, cost_hybrid, device as D, program as P, program_hybrid as PH
from .. import spans as S, spans_mamba as SM, traffic as TR, weights_hybrid as WH
from ..harness import Cell, Clock, Outcome
from ..trace import profiled, read

KV_BLOCK = 256  # positions of a block of the cache compared as one vector


def run(cell: Cell, seed: int, seconds: float, trace: bool, clock: Clock) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    B, V = tr["batch"], cfg["vocab_size"]
    mcfg = PH.model_config(cfg)
    drawn = WH.Weights(cfg, seed, dev)
    PH.param_tree(mcfg, drawn.specs())  # the port's leaves, before anything is built
    marks = {"imports": clock.setup_s()}
    P.build_kernels(tr["kernels"], dev)
    marks["kernels"] = clock.setup_s()
    params, _ = PH.param_tree(mcfg, drawn.all())
    calls = P.AttentionCalls()
    kernels = P.spanned_kernels(P.SERVE_KERNELS, calls) if trace else P.SERVE_KERNELS
    step, new_cache = P.prefill_step(mcfg, kernels)
    order = TR.prefill_lengths(tr, seed)
    sample = TR.prefill_sample(order, tr, seed)
    D.sync(dev)
    marks["weights"] = clock.setup_s()

    def serve(tokens):
        cache = new_cache(B, tokens.shape[1], dev)
        logits, cache = step(params, cache, {"tokens": tokens})
        last = logits[:, -1]
        return last.argmax(dim=-1).cpu(), last, cache

    kept, done, ttft = {}, [], []
    with torch.inference_mode():
        for length in sorted(set(tr["lengths"])):
            serve(TR.prefill_tokens(tr, V, length, seed, ("warm-up", length), dev))
        D.settle()
        D.sync(dev)
        setup_s = clock.setup_s()
        marks["warm-up"] = setup_s
        with profiled(trace, dev) as prof:
            t0 = time.perf_counter()
            for j, length in enumerate(order):
                tokens = TR.prefill_tokens(tr, V, length, seed, j, dev)
                t_sub = time.perf_counter()
                served, last, cache = serve(tokens)
                t_done = time.perf_counter()
                ttft.append(t_done - t_sub)
                done.append(length)
                if j in sample:
                    kept[j] = (tokens, served, last.float(), PH.states_by_layer(mcfg, cache))
                del cache
                window = t_done - t0
                if window >= seconds and len(kept) == len(sample):
                    break
            else:
                raise RuntimeError(f"the traffic's {len(order)} batches ran out before "
                                   f"{seconds} s: give it more groups")
        span_prof, span_tokens, counted = None, 0, {}
        if trace:
            # The next whole group of the mix, with the host recorded, the
            # attention in the benchmark's spans and the port's spans on.
            G = len(tr["lengths"])
            start = -(-(j + 1) // G) * G
            calls.on = True
            S.reset()
            with profiled(trace, dev, host=True) as span_prof, S.enabled():
                for n, length in enumerate(order[start:start + G]):
                    serve(TR.prefill_tokens(tr, V, length, seed, ("spans", n), dev))
                    span_tokens += B * length
            calls.on = False
            counted = S.counters()
    peak = D.peak_bytes(dev)
    t_read = time.perf_counter()
    summary = read(prof, span_prof, (P.FWD_SPAN,) + S.NAMES + SM.NAMES) if trace else None
    t_read = time.perf_counter() - t_read
    del params, step, prof, span_prof
    D.release(dev)

    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    picked = [kept[j] for j in sample]
    t_ref = time.perf_counter()
    prompts = [tokens for tokens, *_ in picked]
    mixer = port_mixer(cfg, mcfg, drawn, reference, prompts)
    numbers, notes = check(cfg, drawn, reference, *(list(x) for x in zip(*picked)), mixer)
    notes.update(batches=len(done), window_s=window, setup_marks_s=marks,
                 reference_s=time.perf_counter() - t_ref, trace_read_s=t_read,
                 port_counters=counted)

    per_request = np.repeat(np.array(ttft) * 1e3, B)
    tokens = B * sum(done)
    metrics = {"setup_s": setup_s, "ttft_ms_p95": float(np.percentile(per_request, 95)),
               "prefill_tokens_per_s": tokens / window, "peak_mem_gib": peak / 2**30}
    reader = {"device_name": D.name(dev), "calls": calls, "span_tokens": span_tokens,
              "port_counters": counted,
              "model_flops": sum(cost_hybrid.prefill_model_flops(cfg, B, L) for L in done)}
    return Outcome(metrics=metrics, numbers=numbers, notes=notes, attempted=B * len(done),
                   failed=0, memory_peak_bytes=peak, window_s=window, trace=summary,
                   reader=reader)


def block_error(test: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst relative error of one block of :data:`KV_BLOCK` positions
    of ``test`` against ``ref`` (B, S, heads, hd), a block of a row (all its
    heads) one vector; the last block of a row may be shorter."""
    B, S = ref.shape[:2]
    pad = -S % KV_BLOCK

    def blocks(t):
        return F.pad(t.float().flatten(2), (0, 0, 0, pad)).view(B, (S + pad) // KV_BLOCK, -1)

    ref = ref.float()
    diff = blocks(test.to(ref.device) - ref).norm(dim=-1)
    return float((diff / blocks(ref).norm(dim=-1).clamp_min(1e-30)).max())


def _rel(test: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's relative error of ``test`` against ``ref`` (B, ...),
    each row one vector."""
    diff = (test.float().to(ref.device) - ref.float()).flatten(1).norm(dim=-1)
    return float((diff / ref.float().flatten(1).norm(dim=-1).clamp_min(1e-30)).max())


def port_mixer(cfg: dict, mcfg, drawn, reference, prompts: list) -> list:
    """[(output (B, S, d), final state h) of each prompt batch]: the port's
    Mamba mixer of layer 0, its weights in float32, with the timed path's
    scan, on the reference's float32 input of that layer."""
    from repro_torch.models import ssm

    if not WH.is_mamba(cfg, 0):
        raise ValueError("the float32 mixer check takes layer 0, which is not a Mamba mixer")
    reference.no_tf32()
    w = {k: t.float() for k, t in drawn.layer(0).items() if k in PH.MAMBA_ORDER}
    out = []
    with torch.inference_mode():
        for tokens in prompts:
            hs = reference.mixer_input(cfg, drawn, tokens)
            cache = ssm.init_mamba_cache(mcfg, tokens.shape[0], torch.float32, hs.device)
            y, cache = ssm.mamba_block(w, hs, mcfg, cache, scan=P.SERVE_KERNELS.ssm_scan)
            out.append((y, cache["h"]))
            del hs, cache
    return out


def check(cfg: dict, drawn, reference, prompts: list, served: list, logits: list,
          states: list, mixer: list) -> tuple[dict, dict]:
    """(numbers compared, what else to print) of the first tokens ``served``,
    the last-position ``logits``, the per-layer ``states`` (``(k, v)`` of
    an attention layer, ``(conv inputs, h)`` of a Mamba layer) and layer
    0's float32 ``mixer`` outputs and final states (:func:`port_mixer`)
    produced for each prompt batch, against the plain reference run over
    the same prompts."""
    reference.no_tf32()
    kv, token, state = {}, {}, {}

    def on_layer(i, refs):
        for got, want in zip((s[i] for s in states), refs):
            if WH.is_mamba(cfg, i):
                state[i] = max(state.get(i, 0.0), *(_rel(g, w) for g, w in zip(got, want)))
            else:
                kv[i] = max(kv.get(i, 0.0), *(block_error(g, w) for g, w in zip(got, want)))
                token[i] = max(token.get(i, 0.0),
                               *(compare.kv_error(g, w)[1] for g, w in zip(got, want)))

    drops: list = []
    ref_logits = reference.prefill(cfg, drawn, prompts, reference.Arith("fp32"), on_layer,
                                   drops)
    gaps = torch.cat([compare.logit_gaps(lg, s) for lg, s in zip(ref_logits, served)])
    agree = float(torch.cat([(lg.argmax(-1).cpu() == s.cpu()).float()
                             for lg, s in zip(ref_logits, served)]).mean())
    rel = [compare.logit_errors(got, want) for got, want in zip(logits, ref_logits)]
    w0 = {k: t.float() for k, t in drawn.layer(0).items()}
    f32 = []
    with torch.no_grad():
        for tokens, (got_y, got_h) in zip(prompts, mixer):
            want_y, (_, want_h) = reference.mamba(reference.mixer_input(cfg, drawn, tokens), w0,
                                                  cfg, reference.Arith("fp32"))
            f32.append(max(_rel(got_y, want_y), _rel(got_h, want_h)))
            del want_y, want_h
    numbers = {"kv_err": max(kv.values()), "state_err": max(state.values()),
               "logit_err": float(torch.cat(rel).quantile(0.25)),
               "logit_gap": float(gaps.max()), "mamba_f32_err": max(f32)}
    dropped, claims = sum(d for d, _ in drops), sum(c for _, c in drops)
    notes = {"kv_err_by_layer": {i: round(e, 5) for i, e in sorted(kv.items())},
             "kv_err_token_by_layer": {i: round(e, 5) for i, e in sorted(token.items())},
             "state_err_by_layer": {i: round(e, 5) for i, e in sorted(state.items())},
             "mamba_f32_err_by_batch": [float(f"{e:.4g}") for e in f32],
             "logit_errs": [round(float(e), 5) for e in torch.cat(rel)],
             "logit_gaps": [round(float(g), 4) for g in gaps], "argmax_agree": agree,
             "capacity_drops": f"{dropped} of {claims} claims (reference's routes)",
             "sampled_lengths": [p.shape[1] for p in prompts]}
    return numbers, notes
