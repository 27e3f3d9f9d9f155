"""The training examples' torch twins run on the CPU and keep their
references' asserts.

``examples/train_lm_torch.py --device cpu --small --steps 20`` survives its
injected failure (one failure, one restore) and ends below its first loss,
as ``examples/train_lm.py`` asserts; the train step's parity with the
reference is held by ``tests/test_torch_train.py``.
``examples/vgg_pipeline_torch.py --device cpu`` prints the evaluator's
-60.2 % line, the fused forward's difference (the kernel's plain version on
the CPU) and its ten losses, and keeps the reference's ``assert losses[-1]
< losses[0]``: it exits 0 exactly when its printed losses fall.  (Its
weights come from the port's own generator, so its losses are not the
reference's; ``tests/test_torch_vgg.py`` trains the reference's weights
through the twin's ``train`` and holds every loss to the reference's.)
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                           "--device", "cpu", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, check=False)


@pytest.fixture(scope="module")
def train_lm():
    return _run("train_lm", "--small", "--steps", "20")


@pytest.fixture(scope="module")
def vgg():
    return _run("vgg_pipeline")


def test_train_lm_twin_survives_its_failure_and_learns(train_lm):
    assert train_lm.returncode == 0, train_lm.stderr[-3000:]
    out = train_lm.stdout
    assert re.search(r"^\[train_lm\] \S+-family, [\d.]+M params, 20 steps, batch 8 x seq 64$",
                     out, re.M), out
    assert "failures=1 restores=1" in out
    curve = re.search(r"loss curve: (.*)$", out, re.M).group(1).split(" -> ")
    assert len(curve) >= 2 and float(curve[-1]) < float(curve[0])


def test_vgg_twin_prints_the_evaluator_and_the_fused_forward(vgg):
    out = vgg.stdout
    assert ("[vgg] evaluator: fused BW 17.9M vs layer-by-layer 45.0M words (-60.2%)"
            in out.splitlines())
    assert len(re.findall(r"^\[vgg\] conv\d+x\d+x\d+: fused working set .* -> fits$",
                          out, re.M)) == 3
    delta = re.search(r"^\[vgg\] fused-kernel forward max\|Δ\| vs torch ops: (\S+)  "
                      r"\(the kernel's plain version on the CPU\)$", out, re.M)
    assert delta is not None, out
    assert float(delta.group(1)) <= 1e-5


def test_vgg_twin_keeps_the_reference_loss_assert(vgg):
    found = re.search(r"^\[vgg\] 10 SGD\+momentum steps: loss (\S+) -> (\S+)$",
                      vgg.stdout, re.M)
    assert found is not None, vgg.stdout + vgg.stderr[-3000:]
    first, last = float(found.group(1)), float(found.group(2))
    if last < first:
        assert vgg.returncode == 0, vgg.stderr[-3000:]
    else:
        assert vgg.returncode != 0
        assert "assert losses[-1] < losses[0]" in vgg.stderr
