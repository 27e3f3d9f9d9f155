"""The prefill driver: a closed loop of one client with one batch in
flight, the load a prefill pool's scheduler hands its instance.

Each batch is ``batch`` prompts of one length (the traffic's groups of
lengths, shuffled by the seed); serving it allocates its KV cache, runs the
port's prefill step and brings the first token of each prompt (the argmax
of its last position) to the host.  A request's time to first token runs
from the batch's submission to that moment.  Set-up draws the weights and
serves one batch of each length the traffic sends (the warm-up); the window
serves batches back to back until one ends past ``--seconds`` and every
sampled batch (one of each length in the first group) is done.  The
sampled batches' first tokens, last-position logits and caches are kept;
once the window has closed and the weights are freed, the plain reference
runs the same prompts and the check compares the two.  A traced run
profiles the window for the device's activity alone, then serves the next
whole group of the mix with the host recorded too and the attention in its
spans.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import compare, cost, device as D, program as P, traffic as TR, weights as W
from ..harness import Cell, Clock, Outcome
from ..trace import profiled, read


def run(cell: Cell, seed: int, seconds: float, trace: bool, clock: Clock) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    B, V = tr["batch"], cfg["vocab_size"]
    mcfg = P.model_config(cfg)
    marks = {"imports": clock.setup_s()}
    P.build_kernels(tr["kernels"], dev)
    marks["kernels"] = clock.setup_s()
    drawn = W.Weights(cfg, seed, dev)
    params, _ = P.param_tree(mcfg, drawn.all())
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
                    kept[j] = (tokens, served, last.float(), P.cache_by_layer(mcfg, cache))
                del cache
                window = t_done - t0
                if window >= seconds and len(kept) == len(sample):
                    break
            else:
                raise RuntimeError(f"the traffic's {len(order)} batches ran out before "
                                   f"{seconds} s: give it more groups")
        span_prof = None
        if trace:
            # The next whole group of the mix, with the host recorded and the
            # attention in its spans.
            G = len(tr["lengths"])
            start = -(-(j + 1) // G) * G
            calls.on = True
            with profiled(trace, dev, host=True) as span_prof:
                for n, length in enumerate(order[start:start + G]):
                    serve(TR.prefill_tokens(tr, V, length, seed, ("spans", n), dev))
            calls.on = False
    peak = D.peak_bytes(dev)
    t_read = time.perf_counter()
    summary = read(prof, span_prof, (P.FWD_SPAN,)) if trace else None
    t_read = time.perf_counter() - t_read
    del params, step, prof, span_prof
    D.release(dev)

    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    picked = [kept[j] for j in sample]
    t_ref = time.perf_counter()
    numbers, notes = check(cfg, drawn, reference, *(list(x) for x in zip(*picked)))
    notes.update(batches=len(done), window_s=window, setup_marks_s=marks,
                 reference_s=time.perf_counter() - t_ref, trace_read_s=t_read)

    per_request = np.repeat(np.array(ttft) * 1e3, B)
    tokens = B * sum(done)
    metrics = {"setup_s": setup_s, "ttft_ms_p95": float(np.percentile(per_request, 95)),
               "prefill_tokens_per_s": tokens / window, "peak_mem_gib": peak / 2**30}
    reader = {"device_name": D.name(dev), "calls": calls,
              "model_flops": sum(cost.prefill_model_flops(cfg, B, L) for L in done)}
    return Outcome(metrics=metrics, numbers=numbers, notes=notes, attempted=B * len(done),
                   failed=0, memory_peak_bytes=peak, window_s=window, trace=summary,
                   reader=reader)


def check(cfg: dict, drawn: W.Weights, reference, prompts: list, served: list,
          logits: list, caches: list) -> tuple[dict, dict]:
    """(numbers compared, what else to print) of the first tokens
    ``served``, the last-position ``logits`` and the per-layer (k, v)
    ``caches`` that were produced for each prompt batch, against the plain
    reference run over the same prompts."""
    reference.no_tf32()
    by_layer = [[0.0, 0.0] for _ in range(cfg["n_layers"])]

    def on_layer(i, kvs):
        for cache, (k, v) in zip(caches, kvs):
            for got, want in zip(cache[i], (k, v)):
                by_layer[i] = [max(a, b) for a, b in zip(by_layer[i],
                                                         compare.kv_error(got, want))]

    drops: list = []
    ref_logits = reference.prefill(cfg, drawn, prompts, reference.Arith("fp32"), on_layer,
                                   drops)
    gaps = torch.cat([compare.logit_gaps(lg, s) for lg, s in zip(ref_logits, served)])
    agree = float(torch.cat([(lg.argmax(-1).cpu() == s.cpu()).float()
                             for lg, s in zip(ref_logits, served)]).mean())
    rel = [compare.logit_errors(got, want) for got, want in zip(logits, ref_logits)]
    numbers = {"kv_err": max(e[0] / (i + 1) for i, e in enumerate(by_layer)),
               "logit_err": max(float(e.quantile(0.25)) for e in rel),
               "logit_gap": float(gaps.max())}
    dropped, claims = sum(d for d, _ in drops), sum(c for _, c in drops)
    notes = {"kv_err_by_layer": [round(e[0], 5) for e in by_layer],
             "kv_err_token_by_layer": [round(e[1], 5) for e in by_layer],
             "logit_errs": [round(float(e), 5) for e in torch.cat(rel)],
             "logit_gaps": [round(float(g), 4) for g in gaps], "argmax_agree": agree,
             "capacity_drops": f"{dropped} of {claims} claims (reference's routes)",
             "sampled_lengths": [p.shape[1] for p in prompts]}
    return numbers, notes
