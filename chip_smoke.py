#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path -- the paper's Sec. III VGG-16 experiment --
through the entry points a user calls, at full width, and holds the kernel
of that path against its plain PyTorch version.  Phases, one line each:

1. device      the card's name and power limit, as nvidia-smi gives them;
2. build       the fused_conv3x3 kernel, built with nvcc from the checkout;
3. paper flow  run_flow on the paper's configuration set and compare_fusion,
               held to the reference suite's locks (tests/test_flow.py);
4. exhaustive  run_flow over the 320-point default space x all 2^17 VGG-16
               groupings (41,943,040 candidates), held bit for bit to the
               scalar oracles (the best point and a seeded 4,096-cell sample);
5. forward     the 224x224 VGG-16 forward, batch 8, float32, through the
               kernel, against the plain forward;
   phases 3-5 are the main path: the launch counts are zeroed just before
   and read just after it;
6. layers      the kernel against its plain version at each of the 13 VGG-16
               conv shapes (batch 1 in float32 and bfloat16, and the forward's
               batch 8 in float32), with its time, the plain version's, a
               cuDNN yardstick's and the bound;
7. the kernels line, then the result line.

Usage: ``python3 chip_smoke.py [--seed N]`` from the root of a
checkout.  Exits non-zero, printing no result, without CUDA or outside a
checkout.  Writes the per-layer table to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"

# Kernel-vs-plain tolerances (atol = rtol), those of tests/test_kernels.py
# for conv (10x its TOLS): the kernel sums the 9*Cin products in another
# order than cuDNN, and a bfloat16 output may round to the neighbouring
# value from a float32 sum that differs in its last bits.
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# Fused-vs-plain logits, relative to the largest logit: the float32
# per-layer tolerance above (13 layers of reordered float32 sums).
LOGIT_TOL = 2e-4
BATCH = 8  # images per forward on the main path
REPS = 10  # timed runs per measurement
SAMPLE_CELLS = 4096  # raw-plane cells held to the scalar oracles
# The TPU kernel K1 replaces (the function that reaches pl.pallas_call).
REPLACES = "src/repro/kernels/fused_conv.py:46"


def fail(msg: str) -> None:
    """End the run: no result line, exit code 1."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    """Fail the run unless ``cond`` holds."""
    if not cond:
        fail(msg)


def time_ms(torch, fns: dict, reps: int) -> dict:
    """Median device time (ms) of each zero-argument callable in ``fns``,
    taken in turns (one of each per round) with CUDA events, after two
    warm-up calls of each."""
    for fn in fns.values():
        fn()
        fn()
    samples = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            samples[k].append(e0.elapsed_time(e1))
    return {k: statistics.median(v) for k, v in samples.items()}


def phase_device(torch) -> str:
    """The card's name and power limit, one line as nvidia-smi prints it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def phase_build(fused_conv) -> float:
    """Build the kernel library from the checkout's source; nvcc seconds."""
    built = fused_conv.build()
    print(f"phase build: {built.path.name} in {built.seconds:.3f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return built.seconds


def phase_paper_flow(vgg) -> dict:
    """The paper's flow on its configuration set, with the reference locks."""
    from repro_torch.core.arch import (
        PAPER_CONSTRAINTS, PAPER_OPTIMAL_CONFIG, paper_config_space)
    from repro_torch.core.flow import compare_fusion, run_flow

    t0 = time.perf_counter()
    res = run_flow(vgg, config_space=paper_config_space(),
                   constraints=PAPER_CONSTRAINTS, groupings="pool",
                   device="cuda")
    cmp = compare_fusion(vgg, PAPER_OPTIMAL_CONFIG)
    seconds = time.perf_counter() - t0
    check(res.best_hw == PAPER_OPTIMAL_CONFIG,
          f"paper flow picked {res.best_hw.describe()}, not hsiao (4,4,4,4)")
    check(res.best_metrics.meets(PAPER_CONSTRAINTS),
          "paper flow's best point breaks the paper's constraints")
    reductions = {"bandwidth": (cmp.bw_reduction, 0.602),
                  "latency": (cmp.latency_reduction, 0.377),
                  "energy": (cmp.energy_reduction, 0.406)}
    for name, (got, want) in reductions.items():
        check(abs(got - want) <= 0.005,
              f"fusion cuts {name} by {got:.4f}, expected {want} +- 0.005")
    check(not cmp.lbl.meets(PAPER_CONSTRAINTS),
          "layer-by-layer meets the paper's constraints")
    check(cmp.fused.meets(PAPER_CONSTRAINTS),
          "fusion breaks the paper's constraints")
    print(f"phase paper_flow: best {res.best_hw.describe()} groups "
          f"{list(res.group_sizes)}; fusion cuts bandwidth "
          f"{cmp.bw_reduction:.4f}, latency {cmp.latency_reduction:.4f}, "
          f"energy {cmp.energy_reduction:.4f}; layer-by-layer meets=False, "
          f"fused meets=True; {seconds:.3f} s")
    return {"seconds": seconds, "bw_reduction": cmp.bw_reduction,
            "latency_reduction": cmp.latency_reduction,
            "energy_reduction": cmp.energy_reduction}


def phase_exhaustive(torch, np, vgg, seed: int) -> dict:
    """The exhaustive sweep, held bit for bit to the scalar oracles."""
    from repro_torch.core import metrics as M
    from repro_torch.core.arch import default_config_space
    from repro_torch.core.flow import groupings_batch, run_flow, sweep_args
    from repro_torch.core.ir import as_graph

    space = default_config_space()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_flow(vgg, config_space=space, groupings="exhaustive",
                   device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = len(space) * 2 ** 17
    check(res.n_candidates == n,
          f"exhaustive sweep scored {res.n_candidates} candidates, not {n}")
    oracle = M.evaluate_ref(vgg, res.best_cuts, res.best_hw)
    check(oracle == res.best_metrics,
          f"best point {res.best_metrics} != scalar oracle {oracle}")

    # The raw plane again, on the device, timed with CUDA events, and a
    # seeded sample of its cells held to the oracles.
    g = as_graph(vgg)
    cuts = groupings_batch(g, "exhaustive")
    tensors = M.sweep_tensors(sweep_args(g, cuts, space),
                              torch.device("cuda"))
    holder = {}

    def sweep():
        holder["raw"] = M._evaluate_batch_graph(*tensors)

    device_ms = time_ms(torch, {"sweep": sweep}, reps=3)["sweep"]
    raw = holder["raw"]
    rng = np.random.default_rng(seed)
    hs = rng.integers(0, len(space), SAMPLE_CELLS)
    cs = rng.integers(0, cuts.shape[0], SAMPLE_CELLS)
    got = raw[torch.as_tensor(hs, device="cuda"),
              torch.as_tensor(cs, device="cuda")].cpu().numpy()
    c_sram = M.sram_accesses_ref(g)
    c_pb = {}
    for i, (h, c) in enumerate(zip(hs.tolist(), cs.tolist())):
        hw = space[h]
        if h not in c_pb:
            c_pb[h] = M.pe_energy_count_ref(g, hw)
        want = (M.bandwidth_ref(g, cuts[c]), M.latency_ref(g, cuts[c], hw),
                c_sram, c_pb[h], M.area_ref(g, cuts[c], hw))
        have = tuple(float(v) for v in got[i])
        check(have == want,
              f"raw cell (h={h}, c={c}) = {have} != oracles {want}")
    print(f"phase exhaustive: {n} candidates, {res.n_feasible} feasible, "
          f"best {res.best_hw.describe()} groups {list(res.group_sizes)} "
          f"(= scalar oracle; {SAMPLE_CELLS} sampled raw cells = oracles); "
          f"run_flow {wall:.3f} s = set-up {res.compile_seconds:.3f} s + "
          f"sweep {res.sweep_seconds:.3f} s ({res.candidates_per_second:.6g}"
          f" candidates/s) + host; device sweep {device_ms:.3f} ms "
          f"({n / device_ms * 1e3:.6g} candidates/s); device peak "
          f"{peak / 2 ** 30:.3f} GiB")
    return {"candidates": n, "n_feasible": res.n_feasible,
            "run_flow_s": wall, "setup_s": res.compile_seconds,
            "sweep_s": res.sweep_seconds,
            "candidates_per_s": res.candidates_per_second,
            "device_sweep_ms": device_ms, "device_peak_bytes": peak}


def phase_forward(torch, seed: int):
    """The 224x224 VGG-16 forward through the kernel vs the plain forward.
    Returns the model, its input and the phase's numbers."""
    from repro_torch.kernels import fused_conv, ops
    from repro_torch.models.vgg import VGG16

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = VGG16(in_hw=224, n_classes=1000, device="cuda", generator=gen)
    x = torch.randn((BATCH, 224, 224, 3), generator=gen, device="cuda")
    conv = ops.fused_conv_fn()
    before = fused_conv.fused_conv3x3.launches
    with torch.inference_mode():
        y = model(x, fused_conv_fn=conv)
        torch.cuda.synchronize()
        launched = fused_conv.fused_conv3x3.launches - before
        y_plain = model(x)
    check(launched == 13, f"the forward launched fused_conv3x3 {launched} "
          "times, not 13")
    check(tuple(y.shape) == (BATCH, 1000), f"logits shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite logits")
    err = float((y - y_plain).abs().max())
    scale = float(y_plain.abs().max())
    check(err <= LOGIT_TOL * scale,
          f"fused logits differ from plain by {err} > {LOGIT_TOL} x {scale}")
    print(f"phase forward: VGG-16 224x224 batch {BATCH} float32 through "
          f"fused_conv3x3 ({launched} launches); logits max |fused - plain| "
          f"= {err:.6g} (max |logit| {scale:.6g}, tolerance "
          f"{LOGIT_TOL} x max)")
    return model, x, {"launches": launched, "max_abs_err": err,
                      "max_abs_logit": scale}


def time_forward(torch, model, x) -> dict:
    """Median ms of the forward through the kernel and of the plain one."""
    from repro_torch.kernels import ops

    conv = ops.fused_conv_fn()
    with torch.inference_mode():
        ms = time_ms(torch, {"fused": lambda: model(x, fused_conv_fn=conv),
                             "plain": lambda: model(x)}, REPS)
    print(f"phase forward_time: batch {BATCH}: through fused_conv3x3 "
          f"{ms['fused']:.3f} ms ({BATCH / ms['fused'] * 1e3:.6g} images/s), "
          f"plain {ms['plain']:.3f} ms")
    return ms


def phase_layers(torch, spec, seed: int) -> list:
    """fused_conv3x3 vs its plain version at each VGG-16 conv shape; the
    bound is the larger of the bytes over ``spec``'s memory rate and the
    multiply-adds over its peak for the input type (float32: the CUDA-core
    rate, since the kernel and its plain version run with TF32 off)."""
    import torch.nn.functional as F

    from repro_torch.core.ir import VGG16_CONV_PLAN
    from repro_torch.kernels import fused_conv, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    print(f"phase layers: bounds at {spec.hbm_bw / 1e12:g} TB/s, "
          f"{spec.peak_fp32_flops / 1e12:g} TFLOP/s float32 (CUDA cores), "
          f"{spec.peak_bf16_flops / 1e12:g} TFLOP/s bfloat16 (data sheet, "
          f"H100 SXM at 700 W)")
    rows = []
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16),
                         (BATCH, torch.float32)):
        dname = str(dtype).removeprefix("torch.")
        for name, cin, cout, hw, pool in VGG16_CONV_PLAN:
            def randn(*shape, std=1.0):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * std).to(dtype)

            x = randn(batch, hw, hw, cin)
            w = randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5)
            b = randn(cout, std=0.1)
            # cuDNN yardstick, timed only: an NCHW view of the NHWC input
            # (channels-last memory, no copy) and OIHW weights.
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()

            def library():
                with ref.no_tf32():
                    y = torch.relu(F.conv2d(x_nchw, w_oihw, b, padding=1))
                    return F.max_pool2d(y, 2) if pool else y

            def kernel():
                return fused_conv.fused_conv3x3(x, w, b, pool=pool)

            def plain():
                return ref.fused_conv3x3_ref(x, w, b, pool=pool)

            want = plain().float()
            got = kernel().float()
            torch.cuda.synchronize()
            tol = TOL[dname]
            err = float((got - want).abs().max())
            check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
                  f"{name} batch {batch} {dname}: kernel differs from plain "
                  f"by up to {err} (tolerance {tol})")
            lib_err = float((library().permute(0, 2, 3, 1).float()
                             - want).abs().max())
            ms = time_ms(torch, {"plain": plain, "kernel": kernel,
                                 "library": library}, REPS)
            es = x.element_size()
            out_hw = hw // 2 if pool else hw
            n_bytes = es * (x.numel() + w.numel() + b.numel()
                            + batch * out_hw * out_hw * cout)
            flops = 2 * 9 * cin * cout * hw * hw * batch
            t_bytes = spec.memory_seconds(n_bytes) * 1e3
            t_ops = spec.compute_seconds(flops, es) * 1e3
            row = {"layer": name, "batch": batch, "dtype": dname, "hw": hw,
                   "cin": cin, "cout": cout, "pool": pool,
                   "max_abs_err": err, "library_max_abs_err": lib_err,
                   "ms": ms["kernel"], "plain_ms": ms["plain"],
                   "library_ms": ms["library"], "bytes": n_bytes,
                   "flops": flops, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            rows.append(row)
            print(f"layer {name} b{batch} {dname} {hw}x{hw} {cin}->{cout} "
                  f"pool={int(pool)}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f}"
                  f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{flops / row['ms'] / 1e9:.4g} TFLOP/s), max_abs_err "
                  f"{err:.3g}")
    return rows


def kernels_entry(rows: list, launches: int, spec) -> dict:
    """The fused_conv3x3 entry of the kernels line: times summed over the
    13 layers at the main path's shapes (batch 8, float32)."""
    main = [r for r in rows if r["batch"] == BATCH and r["dtype"] == "float32"]
    t_bytes = spec.memory_seconds(sum(r["bytes"] for r in main)) * 1e3
    t_ops = spec.compute_seconds(sum(r["flops"] for r in main), 4) * 1e3
    return {
        "name": "fused_conv3x3",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_conv3x3.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in main),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every generator (default 0)")
    args = parser.parse_args(argv)

    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"{e}: the port needs PyTorch and numpy")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the "
             "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.core.arch import gpu_spec
    from repro_torch.core.ir import vgg16_ir
    from repro_torch.kernels import fused_conv

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32 (TF32 is on)")

    t_start = time.perf_counter()
    card = phase_device(torch)
    build_s = phase_build(fused_conv)
    vgg = vgg16_ir(pool_mode="separate")

    # ---- the main path: counts zeroed just before, read just after ----
    fused_conv.fused_conv3x3.launches = 0
    paper = phase_paper_flow(vgg)
    exhaustive = phase_exhaustive(torch, np, vgg, args.seed)
    model, x, forward = phase_forward(torch, args.seed)
    launches = fused_conv.fused_conv3x3.launches
    check(launches > 0, "the main path never launched fused_conv3x3")
    print(f"phase main_path: fused_conv3x3 launched {launches} times")

    forward["ms"] = time_forward(torch, model, x)
    del model, x
    torch.cuda.empty_cache()
    spec = gpu_spec()
    rows = phase_layers(torch, spec, args.seed)
    entry = kernels_entry(rows, launches, spec)

    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "build_s": build_s, "paper_flow": paper,
        "exhaustive": exhaustive, "forward": forward, "layers": rows,
        "kernels": [entry], "seconds": time.perf_counter() - t_start,
    }, indent=1))
    print(f"phase done: {time.perf_counter() - t_start:.1f} s, "
          f"report {REPORT}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
