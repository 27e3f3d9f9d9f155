"""One run of one cell: find its files by name, drive the program through
the driver its traffic names, compare what the program produced with the
plain reference, read the per-layer metrics and build the result line."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    device: str = "cuda"
    base: Path = BENCH_DIR


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, *, base: Path = BENCH_DIR,
              device: str = "cuda") -> Cell:
    """The cell ``name`` of ``bench`` (the parsed ``BENCHMARK.json``), its
    configuration, traffic and limits read from ``base``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    return Cell(name=name, config=load_json(base / "configs" / f"{w['config']}.json"),
                traffic=load_json(base / "workloads" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"), chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                device=device, base=base)


class Clock:
    """Set-up time: from the process's start to the window's start."""

    def setup_s(self) -> float:
        """Seconds since the process started, from /proc."""
        return _process_age()


def _process_age() -> float:
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics, the numbers the
    check compares, the rest to print, the counts and what the per-layer
    readers read."""

    metrics: dict
    numbers: dict
    notes: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    window_s: float
    trace: dict | None = None
    reader: dict = dataclasses.field(default_factory=dict)


def _reader(base: Path, name: str):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and the JAX package (whole names: ``repro_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, clock: Clock) -> dict:
    """Run the cell once and return its result line (a dict)."""
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    out: Outcome = driver.run(cell, seed, seconds, trace, clock)

    checks = {}
    for name, value in out.numbers.items():
        if name in cell.limits:
            checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = (len(checks) == len(cell.limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    for k, v in {**out.numbers, **out.notes}.items():
        print(f"[portbench] {k}: {v}", file=sys.stderr)

    if trace:
        metrics = {}
        ctx = {"cell": cell, "outcome": out, "trace": out.trace, **out.reader}
        for m in cell.per_layer:
            value = _reader(BENCH_DIR, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": out.reader.get("device_name", cell.device), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in out.trace["device_ops"]],
                               "idle_gaps": [list(x) for x in out.trace["idle_gaps"]]}
    result["checks"] = checks
    return result
