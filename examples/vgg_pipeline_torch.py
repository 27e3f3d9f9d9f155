"""The paper's workload end to end on the PyTorch/CUDA port: evaluate → plan
→ execute → train VGG.

The twin of ``examples/vgg_pipeline.py``, through ``repro_torch``:

1. The pre-RTL evaluator picks the fusion grouping for VGG-16 (Sec. III).
2. The fused conv kernel's shared memory a block, at the tile it picks,
   against the card's opt-in limit.
3. The fused conv (+ReLU+pool) forward -- the Hopper kernel on the card --
   is checked against the plain torch ops.
4. A scaled VGG trains for 10 SGD+momentum steps on synthetic 32x32 data
   (:func:`train`), float32 with cuDNN's TF32 off in forward and backward.

Run:  PYTHONPATH=src python examples/vgg_pipeline_torch.py [--device cpu]
(the default device is cuda, which raises without CUDA).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import fusion, metrics as M
from repro_torch.core.arch import PAPER_OPTIMAL_CONFIG, gpu_spec
from repro_torch.core.ir import VGG16_CONV_PLAN, vgg16_ir
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_conv
from repro_torch.kernels.ops import fused_conv_fn
from repro_torch.kernels.ref import no_tf32
from repro_torch.models import vgg as VGG

BATCH = 8  # images a training step (and the batch the tiles are chosen for)
LR, MOMENTUM = 1e-3, 0.9


def train(params: dict, *, steps: int = 10, seed: int = 0,
          device: "str | torch.device" = "cuda") -> list[float]:
    """``steps`` SGD+momentum steps (lr 1e-3, momentum 0.9) of ``params``
    (updated in place) on batches of BATCH 32x32 images with 10 labels
    drawn from ``np.random.default_rng(seed)``, as the reference example
    draws them; returns the losses."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    leaves = [t for group in params.values() for t in group]
    momentum = [torch.zeros_like(p) for p in leaves]
    grad_and_value = torch.func.grad_and_value(VGG.loss_fn)
    losses = []
    for _ in range(steps):
        batch = {
            "images": torch.from_numpy(rng.standard_normal((BATCH, 32, 32, 3)))
                      .to(device=dev, dtype=torch.float32),
            "labels": torch.from_numpy(rng.integers(0, 10, BATCH)).to(dev),
        }
        with no_tf32():  # the backward's convolutions too
            grads, loss = grad_and_value(params, batch)
        flat = [g for group in grads.values() for g in group]
        for p, m, g in zip(leaves, momentum, flat):
            m.mul_(MOMENTUM).add_(g)
            p.sub_(LR * m)
        losses.append(float(loss))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. evaluator: grouping + headline numbers
    ir = vgg16_ir(pool_mode="separate")
    cuts = ir.pool_boundary_cuts()
    lbl = M.evaluate_ref(ir, fusion.layer_by_layer_cuts(len(ir)), PAPER_OPTIMAL_CONFIG)
    fus = M.evaluate_ref(ir, cuts, PAPER_OPTIMAL_CONFIG)
    print(f"[vgg] evaluator: fused BW {fus.bandwidth_words/1e6:.1f}M vs "
          f"layer-by-layer {lbl.bandwidth_words/1e6:.1f}M words "
          f"(-{(1-fus.bandwidth_words/lbl.bandwidth_words)*100:.1f}%)")

    # 2. the fused conv kernel's shared memory a block against the card's limit
    spec = gpu_spec()
    cout = {(hw, n_in): n_out for _name, n_in, n_out, hw, _pooled in VGG16_CONV_PLAN}
    for hw, cin in ((224, 64), (56, 256), (14, 512)):
        tile = fused_conv.choose_tile(BATCH, hw, hw, cout[hw, cin])
        b = fused_conv.smem_bytes(tile)
        print(f"[vgg] conv{hw}x{hw}x{cin}: fused working set "
              f"{b/2**10:6.1f} KiB at tile {tile}  (shared memory a block "
              f"{spec.smem_per_block_optin/2**10:.0f} KiB)"
              f"  -> {'fits' if b <= spec.smem_per_block_optin else 'does not fit'}")

    # 3. fused forward (the Hopper kernel on the card) == plain torch ops
    params = VGG.init_params(torch.Generator(device=dev).manual_seed(0),
                             in_hw=32, n_classes=10)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    before = fused_conv.fused_conv3x3.launches
    with torch.no_grad():
        ref = VGG.forward(params, x)
        fused = VGG.forward(params, x, fused_conv_fn=fused_conv_fn(device=dev))
    err = float((ref - fused).abs().max())
    launched = fused_conv.fused_conv3x3.launches - before
    how = (f"{launched} fused_conv3x3 launches" if dev.type == "cuda"
           else "the kernel's plain version on the CPU")
    print(f"[vgg] fused-kernel forward max|Δ| vs torch ops: {err:.2e}  ({how})")

    # 4. a few training steps (synthetic data)
    losses = train(params, steps=10, seed=0, device=dev)
    print(f"[vgg] 10 SGD+momentum steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0]


if __name__ == "__main__":
    main()
