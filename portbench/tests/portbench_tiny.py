"""Tiny cells for the harness's tests: a dense model trained and a mixture
of experts prefilled, on the CPU, found in ``data/``."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"


def tiny_bench() -> dict:
    """BENCHMARK.json with the two tiny cells in place of the real ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": "tiny-train", "config": "tiny-dense", "traffic": "tiny-train", "chips": 1},
        {"name": "tiny-prefill", "config": "tiny-moe", "traffic": "tiny-prefill", "chips": 1}]
    real = {"phi3-train-8k": "tiny-train", "mixtral-prefill-mix": "tiny-prefill"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    return bench


def tiny_cell(name: str):
    """The tiny cell ``name``, on the CPU."""
    from portbench import harness

    return harness.load_cell(tiny_bench(), name, base=DATA, device="cpu")
