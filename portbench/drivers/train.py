"""The training driver: one training job, closed loop, one step at a time.

Set-up builds the donated training step that ``launch.train.run`` builds
(without the trainer's checkpoints), on weights drawn from the seed and
zero AdamW state, and drives it through its first ``checked_steps`` steps
on the pool's first batches: the warm-up of every shape the window uses,
and the steps the reference follows.  Their losses, the first step's
clipped gradient (read from the first moment after one step) and the
stored parameters' change after them are kept.  The window then drives the
same step object on; it ends on the synchronise after the step that
crosses ``--seconds``.  A traced run profiles the window for the device's
activity alone, then drives about two more steps with the host recorded
too and the attention in its spans.  Once the window has closed and the
program's state is freed, the plain reference trains the same weights
over the same batches and the check compares the two.
"""
from __future__ import annotations

import importlib
import math
import time

import torch

from .. import compare, cost, device as D, program as P, traffic as TR, weights as W
from ..harness import Cell, Clock, Outcome
from ..trace import profiled, read

# The span window after a traced run's window: about two of phi3's steps.
SPAN_SECONDS = 2.0


def run(cell: Cell, seed: int, seconds: float, trace: bool, clock: Clock) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    opt = tr["optimizer"]
    mcfg, rc = P.model_config(cfg), P.train_run_config(tr)
    marks = {"imports": clock.setup_s()}
    P.build_kernels(tr["kernels"], dev)
    marks["kernels"] = clock.setup_s()
    drawn = W.Weights(cfg, seed, dev)
    params, names = P.param_tree(mcfg, drawn.all())
    opt_cfg = P.adamw_config(opt)
    opt_state = P.init_opt_state(params, opt_cfg)
    calls = P.AttentionCalls()
    kernels = P.spanned_kernels(P.train_kernels(rc), calls) if trace else None
    step = P.train_step(mcfg, rc, opt_cfg, kernels)
    pool = TR.train_pool(tr, cfg["vocab_size"], seed, dev)
    checked = tr["checked_steps"]
    D.sync(dev)
    marks["weights"] = clock.setup_s()

    losses, grad = [], {}
    for i in range(checked):
        params, opt_state, met = step(params, opt_state, pool[i])
        losses.append(float(met["loss"]))
        if i == 0:
            grad = {k: float(m.float().norm()) / (1 - opt["b1"])
                    for k, m in P.leaves_by_name(opt_state["m"], names).items()}
    delta = drawn.delta_norms(P.leaves_by_name(params, names))

    D.settle()
    D.sync(dev)
    setup_s = clock.setup_s()
    marks["warm-up"] = setup_s
    done = 0

    def steps_until(stop: float) -> list:
        nonlocal params, opt_state, met, done
        ends, t0 = [], time.perf_counter()
        while True:
            params, opt_state, met = step(params, opt_state, pool[(checked + done) % len(pool)])
            D.sync(dev)
            done += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= stop:
                return ends

    with profiled(trace, dev) as prof:
        ends = steps_until(seconds)
    steps, window = len(ends), ends[-1]
    span_prof = None
    if trace:
        calls.on = True
        with profiled(trace, dev, host=True) as span_prof:
            steps_until(SPAN_SECONDS if dev == "cuda" else 0.0)
        calls.on = False
    last_loss = float(met["loss"])
    peak = D.peak_bytes(dev)
    t_read = time.perf_counter()
    summary = read(prof, span_prof, (P.FWD_SPAN, P.BWD_SPAN)) if trace else None
    t_read = time.perf_counter() - t_read
    del params, opt_state, met, step, prof, span_prof
    D.release(dev)

    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    reference.no_tf32()
    t_ref = time.perf_counter()
    ref = reference.train(cfg, drawn, pool[:checked], opt, tr["microbatches"],
                          reference.Arith("fp32"))
    numbers, notes = compare.train_numbers({"loss": losses, "grad": grad, "delta": delta}, ref)
    numbers["loss_finite"] = 0.0 if math.isfinite(last_loss) else 1.0
    tokens = steps * tr["batch"] * tr["seq"]
    metrics = {"setup_s": setup_s, "train_tokens_per_s": tokens / window,
               "peak_mem_gib": peak / 2**30}
    step_ms = [round(1e3 * (b - a), 1) for a, b in zip([0.0] + ends, ends)]
    notes.update(steps=steps, window_s=window, step_ms=step_ms, last_loss=last_loss,
                 setup_marks_s=marks, reference_s=time.perf_counter() - t_ref,
                 trace_read_s=t_read)
    reader = {"device_name": D.name(dev), "calls": calls,
              "model_flops": steps * cost.train_model_flops(cfg, tr["batch"], tr["seq"])}
    return Outcome(metrics=metrics, numbers=numbers, notes=notes, attempted=steps, failed=0,
                   memory_peak_bytes=peak, window_s=window, trace=summary, reader=reader)
