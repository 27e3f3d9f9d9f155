"""Quickstart on the PyTorch/CUDA port: the paper's evaluator in five
minutes.

The twin of ``examples/quickstart.py``, through ``repro_torch``:

1. Reproduce the paper's VGG-16 experiment (Sec. III): find the optimal
   DLA configuration under the published constraints and report the
   fusion-vs-layer-by-layer reductions.
2. Run the same fusion machinery on a modern LM architecture and show the
   planner picking the H100 kernels' tile shapes.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the default device is cuda, which raises without CUDA).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import resolve
from repro_torch.core.arch import (PAPER_CONSTRAINTS, PAPER_OPTIMAL_CONFIG, gpu_spec,
                                   paper_config_space)
from repro_torch.core.flow import compare_fusion, run_flow
from repro_torch.core.ir import vgg16_ir
from repro_torch.core.planner import plan_model
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=" * 72)
    print("1. Paper reproduction: VGG-16 pre-RTL evaluation (Sec. III)")
    print("=" * 72)
    ir = vgg16_ir(pool_mode="separate")
    res = run_flow(ir, config_space=paper_config_space(),
                   constraints=PAPER_CONSTRAINTS, groupings="pool", device=dev)
    print(f"optimal hardware under constraints: {res.best_hw.describe()}")
    print(f"  (paper reports (F1,F2,F3,F4) = (4,4,4,4))")
    cmp = compare_fusion(ir, PAPER_OPTIMAL_CONFIG)
    print("\nfusion vs layer-by-layer on the optimal config:")
    print(cmp.describe())
    print("  (paper reports -55.6% BW, -36.7% latency, -49.2% energy)")
    print(f"\nlayer-by-layer meets constraints: {cmp.lbl.meets(PAPER_CONSTRAINTS)}"
          f"  |  fused meets constraints: {cmp.fused.meets(PAPER_CONSTRAINTS)}")

    print("\n" + "=" * 72)
    print("2. Beyond the paper: the evaluator finds better groupings")
    print("=" * 72)
    exh = run_flow(ir, config_space=[PAPER_OPTIMAL_CONFIG],
                   constraints=PAPER_CONSTRAINTS, groupings="exhaustive", device=dev)
    print(f"best exhaustive grouping: {exh.describe()}")

    print("\n" + "=" * 72)
    print("3. The same flow on the H100: fusion plans for assigned architectures")
    print("=" * 72)
    spec = gpu_spec()
    for arch in ("qwen3", "gemma3", "jamba", "falcon-mamba"):
        cfg = resolve(arch)
        plan = plan_model(cfg, 4096, spec)
        print(plan.describe())


if __name__ == "__main__":
    main()
