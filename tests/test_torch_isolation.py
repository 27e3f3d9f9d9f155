"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU run.

* an AST scan finds no import of ``jax`` or of ``repro`` in the port's
  package, in ``chip_smoke.py`` or in the examples' twins
  (``examples/*_torch.py``);
* importing the whole port in a fresh interpreter loads no JAX module;
* on a host without CUDA the entry points raise unless given
  ``device="cpu"``, the twins exit non-zero unless given ``--device cpu``,
  and ``chip_smoke.py`` exits non-zero with no result.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _imported_roots(path: Path) -> set[str]:
    """Top-level package of every import in a file (relative imports: '.')."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add("." if node.level else node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


def _run(code: str, *, cwd: Path = ROOT, script=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cmd = [sys.executable] + ([str(script)] if script else ["-c", code])
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, check=False)


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', len(sys.modules)); assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED" in proc.stdout


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA contract is not testable")


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    _no_cuda()
    from repro_torch.configs import resolve, scaled_down
    from repro_torch.core import arch, flow, ir, metrics, service
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh, single_device_mesh
    from repro_torch.models import model
    from repro_torch.models.vgg import VGG16

    vgg = ir.vgg16_ir()
    space = arch.paper_config_space()
    args = flow.sweep_args(ir.as_graph(vgg), np.ones((1, 17), bool), space)
    x = torch.zeros((1, 8, 8, 3))
    w, b = torch.zeros((3, 3, 3, 8)), torch.zeros(8)
    q, kv = torch.zeros((1, 8, 2, 32)), torch.zeros((1, 8, 1, 32))
    h, w1, w2 = torch.zeros((4, 8)), torch.zeros((8, 16)), torch.zeros((16, 8))
    cfg = scaled_down(resolve("qwen3"))
    serve_args = ["--arch", "qwen3", "--requests", "1", "--prompt-len", "4",
                  "--gen", "2"]
    for call in (lambda: flow.run_flow(vgg, config_space=space,
                                       groupings="pool"),
                 lambda: metrics.evaluate_batch_graph(*args),
                 lambda: VGG16(in_hw=32, n_classes=10),
                 lambda: ops.conv3x3(x, w, b),
                 lambda: ops.fused_conv_fn(),
                 lambda: ops.attention(q, kv, kv),
                 lambda: ops.mlp(h, w1, w2, act="relu"),
                 lambda: model.init_params(cfg),
                 lambda: model.init_cache(cfg, 1, 8),
                 lambda: serve.main(serve_args),
                 lambda: flow.run_fleet([vgg], config_space=space, groupings="pool"),
                 lambda: flow.run_fleet([vgg], config_space=space, groupings="pool",
                                        devices=("cuda:0", "cuda:0")),
                 lambda: service.PlanningService(),
                 lambda: service.AsyncPlanningService(),
                 lambda: single_device_mesh(),
                 lambda: make_mesh((2, 4), ("data", "model"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # ... and run when asked for the CPU
    assert flow.run_flow(vgg, config_space=space, groupings="pool",
                         device="cpu").best_hw == arch.PAPER_OPTIMAL_CONFIG
    assert metrics.evaluate_batch_graph(*args, device="cpu").shape == (8, 4, 4)
    assert ops.conv3x3(x, w, b, device="cpu").shape == (1, 8, 8, 8)
    assert ops.attention(q, kv, kv, device="cpu").shape == q.shape
    assert ops.mlp(h, w1, w2, act="relu", device="cpu").shape == h.shape
    assert model.init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    assert serve.main(serve_args + ["--device", "cpu"]).shape == (1, 2)
    fleet = flow.run_fleet([vgg], config_space=space, groupings="pool", device="cpu")
    assert fleet.results[0].best_hw == arch.PAPER_OPTIMAL_CONFIG
    assert flow.run_fleet([vgg], config_space=space, groupings="pool",
                          devices=("cpu", "cpu")).device_count == 2
    req = service.PlanRequest(graph=ir.residual_block_ir())
    assert service.PlanningService(config_space=space, device="cpu").plan(req).ok
    with service.AsyncPlanningService(config_space=space, device="cpu") as svc:
        assert svc.plan(req, timeout=120).ok
    with pytest.raises(ValueError, match="unsupported device"):
        flow.run_flow(vgg, groupings="pool", device="meta")


def test_there_are_five_example_twins():
    assert [p.name for p in TWINS] == [
        "evaluate_design_torch.py", "quickstart_torch.py", "serve_lm_torch.py",
        "train_lm_torch.py", "vgg_pipeline_torch.py"]


@pytest.mark.parametrize("twin", TWINS, ids=[p.name for p in TWINS])
def test_twin_without_a_device_fails_without_cuda(twin):
    _no_cuda()
    proc = _run("", script=twin)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""  # it raised before printing a result


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    _no_cuda()
    proc = _run("", script=ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "FAILED" in proc.stderr


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "FAILED" in proc.stderr
