"""The readings the limits of a hybrid cell (``drivers/prefill_hybrid.py``)
are set from, on the chip at the cell's own size, several seeds in one
process, as ``calibrate.py`` reads them for the other cells:

    python3 -m portbench.calibrate_hybrid --workload <cell> --what <kind> --seeds 1 2 3

``--what program``: the numbers of sound runs of the program (a window of
one group of batches); ``control``: the plain reference computed in float8
(``reference.Arith("fp8")``) put in the program's place, its caches stored
as the program stores them (K, V and the convolution's inputs in the
served dtype, the state in float32); ``control_bf16_scan``: the plain
reference in float32 but for the Mamba recurrence, whose dA, dBx and state
are held in bfloat16 (:func:`scan_bf16`), the precision below the one the
configuration states for them, stored the same way.  A control's own
layer-0 Mamba mixer, in its arithmetic, stands for the port's float32 one
(``mamba_f32_err``).  One JSON line per seed on standard output.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


SEGMENT = 2048  # steps of scan_bf16 whose dA and dBx exist at once


def scan_bf16(dt, A, Bm, Cm, x, h):
    """The reference's recurrence (``reference.jamba.scan``'s arguments and
    results) with dA = exp(dt A), dBx = dt B x and the state in bfloat16:
    each step's h = dA h + dBx rounded to bfloat16 once, the readout y = h C
    in float32."""
    import torch

    Bsz, S, di = x.shape
    h = h.to(torch.bfloat16)
    ys = []
    for s0 in range(0, S, SEGMENT):
        s1 = min(S, s0 + SEGMENT)
        dA = torch.exp(dt[:, s0:s1, :, None] * A).to(torch.bfloat16)
        dBx = (dt[:, s0:s1, :, None] * Bm[:, s0:s1, None, :]
               * x[:, s0:s1, :, None]).to(torch.bfloat16)
        hs = torch.empty_like(dA)
        for t in range(s1 - s0):
            h = torch.addcmul(dBx[:, t], dA[:, t], h, out=hs[:, t])
        ys.append(torch.einsum("btds,bts->btd", hs.float(), Cm[:, s0:s1]))
        del dA, dBx, hs
    return torch.cat(ys, dim=1), h.float()


def control(cell, seed: int, scan=None) -> tuple[dict, dict]:
    """The numbers of the float8 reference in the program's place or, with
    ``scan``, of the float32 reference with ``scan`` as its recurrence."""
    import torch

    from portbench import traffic as TR, weights_hybrid as WH
    from portbench.drivers import prefill_hybrid as PD

    cfg, tr = cell.config, cell.traffic
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    reference.no_tf32()
    drawn = WH.Weights(cfg, seed, cell.device)
    order = TR.prefill_lengths(tr, seed)
    prompts = [TR.prefill_tokens(tr, cfg["vocab_size"], order[j], seed, j, cell.device)
               for j in TR.prefill_sample(order, tr, seed)]
    states = [[None] * cfg["n_layers"] for _ in prompts]
    served_dtype = getattr(torch, cfg["dtype"])

    def keep(i, refs):
        for b, (a, s) in enumerate(refs):
            states[b][i] = (a.to(served_dtype), s if WH.is_mamba(cfg, i) else s.to(served_dtype))

    arith = reference.Arith("fp8" if scan is None else "fp32")
    w0 = {k: t.float() for k, t in drawn.layer(0).items()}
    real = reference.scan
    reference.scan = scan or real
    try:
        logits = reference.prefill(cfg, drawn, prompts, arith, keep)
        with torch.no_grad():
            mixer = [(y, h) for y, (_, h) in (
                reference.mamba(reference.mixer_input(cfg, drawn, t), w0, cfg, arith)
                for t in prompts)]
    finally:
        reference.scan = real
    served = [lg.argmax(-1) for lg in logits]
    return PD.check(cfg, drawn, reference, prompts, served, logits, states, mixer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "control", "control_bf16_scan"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from portbench import harness

    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    for seed in args.seeds:
        if args.what.startswith("control"):
            numbers, notes = control(cell, seed,
                                     scan_bf16 if args.what == "control_bf16_scan" else None)
        else:
            out = driver.run(cell, seed, 0.0, False, harness.Clock())
            numbers, notes = out.numbers, out.notes
        print(json.dumps({"workload": cell.name, "what": args.what, "seed": seed,
                          "numbers": numbers, "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
