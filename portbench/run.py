"""Run one cell of the port's benchmark on one NVIDIA GPU:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the port's kernels into
``build/kernels/`` of the checkout (the first run of a cell there; later
runs load them), makes the weights and the inputs from ``--seed``, warms up
every shape the cell's traffic uses, measures for ``--seconds`` seconds,
checks what the window produced against the plain reference, and prints one
JSON line as the last line of standard output (``--trace 1``: the per-layer
metrics, from a window profiled for the device's activity alone and a short
window after it that records the host too; ``--trace 0``: the end-to-end
metrics).
The numbers compared are printed with their limits as the last lines of
standard error and under ``"checks"``, the line's last key.  It exits
non-zero, printing no result, without CUDA or with fewer GPUs than the
cell asks for, outside a checkout that holds the port, or when JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from portbench import harness

    clock = harness.Clock()
    args = parse_args(argv)
    # Every build and kernel cache of the program stays in the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[portbench] no port under {ROOT / 'src'}: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"CUDA available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), clock)
    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] loaded what the benchmark may not load: {found}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
