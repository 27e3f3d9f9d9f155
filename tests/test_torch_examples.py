"""The evaluator examples' torch twins print their references' numbers.

``examples/{quickstart,evaluate_design,serve_lm}_torch.py --device cpu`` and
their references (``examples/*.py``, JAX on the CPU) each run in a fresh
interpreter; every evaluator number they print -- the best hardware point,
the reductions, group counts, bandwidth words, plan points and energies,
the service's counters -- must be equal, character for character.  Masked:
the host-timing fields (candidates a second, the set-up / compile ms, the
cancel's and each plan's ms) and, in quickstart, the tiles of section 3,
which plans the H100's kernels where the reference plans a TPU's (its
block-bandwidth savings are still compared).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "evaluate_design", "serve_lm"]
MASKS = [
    (re.compile(r"[\d,]+ cand/s, (compile|set-up) \d+ ms"), "<timing>"),
    (re.compile(r"RequestCancelled \(\d+ ms\)"), "RequestCancelled (<ms>)"),
    (re.compile(r"latency +[\d.]+ ms"), "latency <ms>"),
]
SECTION_3 = re.compile(r"^3\. The same flow on .*$", re.M)
PLAN_LINE = re.compile(r"^(\S+@\d+): flash\(.*\) mlp\(.*\) (block-BW saving [\d.]+%)$", re.M)


def _start(script: Path, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(script), *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _masked(text: str) -> str:
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text


@pytest.fixture(scope="module")
def runs() -> dict:
    """{name: (the reference's stdout, the twin's)}, the six runs at once."""
    procs = {(name, side): _start(ROOT / "examples" / f"{name}{suffix}", *args)
             for name in EXAMPLES
             for side, suffix, args in (("ref", ".py", ()),
                                        ("twin", "_torch.py", ("--device", "cpu")))}
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (key, stderr[-3000:])
        out[key] = stdout
    return {name: (out[name, "ref"], out[name, "twin"]) for name in EXAMPLES}


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_prints_the_reference_numbers(runs, name):
    ref, twin = (_masked(t) for t in runs[name])
    if name == "quickstart":
        ref, twin = ref[:SECTION_3.search(ref).start()], twin[:SECTION_3.search(twin).start()]
    assert twin.splitlines() == ref.splitlines()
    assert len(twin.splitlines()) >= 5


def test_quickstart_twin_plans_the_h100_for_the_same_archs(runs):
    ref, twin = runs["quickstart"]
    assert "3. The same flow on the H100" in twin
    want, got = PLAN_LINE.findall(ref), PLAN_LINE.findall(twin)
    assert len(want) == 4 and got == want  # arch@seq and block-BW saving
    # the H100 tiles fit a block's 227 KiB of opt-in shared memory
    for kib in re.findall(r"([\d.]+)KiB", twin):
        assert float(kib) <= 227.0
