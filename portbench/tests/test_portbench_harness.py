"""The harness on the CPU: files found by name, the manifest's contract, the
seeded traffic, the result line and what the benchmark may import."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench_tiny import DATA, ROOT
from portbench import harness, program, traffic, weights

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {"train": {"setup_s", "peak_mem_gib", "train_tokens_per_s"},
       "prefill": {"setup_s", "peak_mem_gib", "ttft_ms_p95", "prefill_tokens_per_s"}}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
    c = harness.load_cell(BENCH, cell, device="cpu")
    program.model_config(c.config)  # a ModelConfig the port accepts
    driver = c.traffic["driver"]
    assert (ROOT / "portbench" / "drivers" / f"{driver}.py").is_file()
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and reported <= E2E[driver]
    assert c.per_layer and c.limits
    for m in c.per_layer:
        assert m["moves"] in reported
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_the_length_order_is_seeded_and_keeps_the_mix():
    mix = json.loads((ROOT / "portbench" / "workloads" / "prefill-mix.json").read_text())
    big = 2**31 + 12345
    a, b = traffic.prefill_lengths(mix, big), traffic.prefill_lengths(mix, big)
    assert a == b and a != traffic.prefill_lengths(mix, big + 1)
    n = len(mix["lengths"])
    for g in range(mix["groups"]):
        assert sorted(a[g * n:(g + 1) * n]) == sorted(mix["lengths"])
    sample = traffic.prefill_sample(a, mix, big)
    assert sorted(a[j] for j in sample) == sorted(set(mix["lengths"]))
    assert all(j < n for j in sample)


def test_training_batches_are_seeded_and_their_rows_differ():
    tr = json.loads((DATA / "workloads" / "tiny-train.json").read_text())
    pool = traffic.train_pool(tr, 256, 2**33, "cpu")
    again = traffic.train_pool(tr, 256, 2**33, "cpu")
    assert all(torch.equal(p["tokens"], q["tokens"]) for p, q in zip(pool, again))
    rows = torch.cat([p["tokens"] for p in pool])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert torch.equal(pool[0]["tokens"][:, 1:], pool[0]["labels"][:, :-1])


def test_weights_draw_again_bit_for_bit(tiny_cell):
    cell = tiny_cell("tiny-prefill")
    drawn = weights.Weights(cell.config, 2**40 + 3, "cpu")
    every = drawn.all()
    for name, t in drawn.layer(1).items():
        assert torch.equal(t, every[f"layers.1.{name}"])
    assert every["layers.0.router"].dtype == torch.float32
    assert every["layers.0.w1"].dtype == torch.bfloat16
    assert set(drawn.delta_norms(every).values()) == {0.0}


def _check_line(result: dict, trace: bool, cell) -> None:
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(device) and "breakdown" in result
    json.dumps(result)


@pytest.mark.parametrize("name, trace", [("tiny-train", False), ("tiny-train", True),
                                         ("tiny-prefill", False), ("tiny-prefill", True)])
def test_a_run_prints_the_result_line(tiny_cell, name, trace):
    cell = tiny_cell(name)
    result = harness.run_cell(cell, 2**31 + 7, 0.2, trace, harness.Clock())
    _check_line(result, trace, cell)
    assert result["correct"]
    assert set(result["checks"]) == set(cell.limits)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")]:
        monkeypatch.delitem(sys.modules, name)
    for name in [m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def _python(code: str, cwd: Path = ROOT, **env) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(DATA.parent)!r}]
from portbench_tiny import DATA, tiny_bench
from portbench import harness
for name in ("tiny-train", "tiny-prefill"):
    cell = harness.load_cell(tiny_bench(), name, base=DATA, device="cpu")
    harness.run_cell(cell, 11, 0.1, True, harness.Clock())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_yardstick_imports_nothing_of_the_port():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import portbench.reference.transformer, portbench.cost, portbench.compare
import portbench.weights, portbench.traffic, portbench.seeds
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", "repro", "jax"}


def test_run_prints_no_result_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "phi3-train-8k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_prints_no_result_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "phi3-train-8k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
