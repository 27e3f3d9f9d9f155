"""The readings the limits of ``limits/<cell>.json`` are set from, on the
chip at the cell's own size, several seeds in one process:

    python3 -m portbench.calibrate --workload <cell> --what <kind> --seeds 1 2 3

``--what program``: the numbers of sound runs of the program (a run with a
window of one step or one group of batches); ``control``: the plain
reference computed in float8 (``reference.Arith("fp8")``) put in the
program's place; ``half_batch`` (training): the program with half of each
batch left out, the mean taken over the rest (each step runs its first
microbatch in place of every other).  One JSON line per seed on standard
output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def half_batch():
    """The training step's microbatches cut to the first, repeated."""
    from repro_torch.runtime import steps

    real = steps._microbatches

    def first_only(batch, n):
        mbs = real(batch, n)
        return [mbs[0]] * n

    steps._microbatches = first_only
    try:
        yield
    finally:
        steps._microbatches = real


def control(cell, seed: int) -> tuple[dict, dict]:
    """The numbers of the float8 reference in the program's place."""
    import torch

    from portbench import compare, traffic as TR, weights as W
    from portbench.drivers import prefill as PD

    cfg, tr = cell.config, cell.traffic
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    reference.no_tf32()
    drawn = W.Weights(cfg, seed, cell.device)
    if tr["driver"] == "train":
        pool = TR.train_pool(tr, cfg["vocab_size"], seed, cell.device)[:tr["checked_steps"]]
        low = reference.train(cfg, drawn, pool, tr["optimizer"], tr["microbatches"],
                              reference.Arith("fp8"))
        ref = reference.train(cfg, drawn, pool, tr["optimizer"], tr["microbatches"],
                              reference.Arith("fp32"))
        return compare.train_numbers(low, ref)
    order = TR.prefill_lengths(tr, seed)
    prompts = [TR.prefill_tokens(tr, cfg["vocab_size"], order[j], seed, j, cell.device)
               for j in TR.prefill_sample(order, tr, seed)]
    caches = [[None] * cfg["n_layers"] for _ in prompts]

    def keep(i, kvs):
        for b, (k, v) in enumerate(kvs):
            caches[b][i] = (k.to(torch.bfloat16), v.to(torch.bfloat16))

    logits = reference.prefill(cfg, drawn, prompts, reference.Arith("fp8"), keep)
    served = [lg.argmax(-1) for lg in logits]
    return PD.check(cfg, drawn, reference, prompts, served, logits, caches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "control", "half_batch"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from portbench import harness

    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    for seed in args.seeds:
        if args.what == "control":
            numbers, notes = control(cell, seed)
        else:
            with half_batch() if args.what == "half_batch" else contextlib.nullcontext():
                out = driver.run(cell, seed, 0.0, False, harness.Clock())
            numbers, notes = out.numbers, out.notes
        print(json.dumps({"workload": cell.name, "what": args.what, "seed": seed,
                          "numbers": numbers, "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
