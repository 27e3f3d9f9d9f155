"""Design-space exploration on the PyTorch/CUDA port: use the pre-RTL
evaluator the way a hardware team would — sweep constraints, compare
accelerator styles, and read the trade-off frontier; then do the same for
a transformer's fusion plans.

The twin of ``examples/evaluate_design.py``, through ``repro_torch``.

Run:  PYTHONPATH=src python examples/evaluate_design_torch.py [--device cpu]
(the default device is cuda, which raises without CUDA).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.arch import Constraints
from repro_torch.core.flow import run_flow
from repro_torch.core.ir import lm_ir, vgg16_ir
from repro_torch.core import fusion, metrics as M
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ir = vgg16_ir(pool_mode="separate")

    print("=== constraint sweep: how the optimum moves ===")
    for lat_mcyc in (20, 12, 6, 3):
        c = Constraints(max_latency_cycles=lat_mcyc * 1e6)
        try:
            res = run_flow(ir, constraints=c, groupings="pool", device=dev)
            print(f"latency <= {lat_mcyc:3d} Mcyc: {res.best_hw.describe():42s}"
                  f" E={res.best_metrics.energy_nj/1e6:6.2f} mJ "
                  f"A={res.best_metrics.area_um2/1e6:5.1f} mm^2")
        except ValueError:
            print(f"latency <= {lat_mcyc:3d} Mcyc: infeasible with default space")

    print("\n=== SRAM budget vs achievable fusion (DP grouping) ===")
    for budget_kwords in (64, 256, 1024, 4096):
        try:
            dp = fusion.optimal_cuts_dp(ir, sram_budget_words=budget_kwords * 1024)
            bw = M.bandwidth_ref(ir, dp.cuts)
            print(f"SRAM {budget_kwords:5d} Kwords: {dp.n_groups:2d} groups, "
                  f"BW {bw/1e6:6.2f} M words")
        except ValueError:
            print(f"SRAM {budget_kwords:5d} Kwords: no feasible grouping")

    print("\n=== the evaluator on a transformer block chain ===")
    ir_lm = lm_ir(name="qwen3ish", n_layers=4, d_model=1024, n_heads=16,
                  n_kv_heads=8, d_ff=3072, seq_len=4096, repeat=2)
    lbl = M.bandwidth_ref(ir_lm, fusion.layer_by_layer_cuts(len(ir_lm)))
    dp = fusion.optimal_cuts_dp(ir_lm)
    print(f"2 transformer blocks, layer-by-layer BW: {lbl/1e6:8.1f} M words")
    print(f"optimal fusion grouping BW:             {dp.group_cost_words/1e6:8.1f}"
          f" M words in-group + weights (groups of "
          f"{[len(g) for g in M.groups_from_cuts(dp.cuts)]} layers)")


if __name__ == "__main__":
    main()
