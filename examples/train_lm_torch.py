"""End-to-end training example on the PyTorch/CUDA port: a
qwen3-family LM for a few hundred steps, with checkpointing and an injected
failure mid-run to demonstrate the fault-tolerant restart path.

The twin of ``examples/train_lm.py``, through ``repro_torch``.  The default
is a ~15M-parameter model; ``--large`` selects the ~100M-parameter
configuration (the same code path).  On the card the attention trains
through the flash-attention kernel and its backward kernel.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
(Use --small for a quick smoke run; the default device is cuda, which
raises without CUDA.  Checkpoints go to a fresh temporary directory unless
--ckpt-dir names one.)
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import dataclasses
import tempfile

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import resolve, run_config, scaled_down
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import ResilientTrainer, flaky
from repro_torch.runtime.steps import make_init, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = resolve("qwen3")
    if args.small:
        cfg = scaled_down(base)
        batch, seq = 8, 64
    elif args.large:
        # ~100M params: qwen3 family at half width/depth.
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
            head_dim=64, d_ff=1536, vocab_size=32_768, dtype="float32",
        )
        batch, seq = 16, 128
    else:
        # ~15M params: the same family at a small size.
        cfg = dataclasses.replace(
            base, n_layers=6, d_model=384, n_heads=6, n_kv_heads=3,
            head_dim=64, d_ff=1024, vocab_size=8_192, dtype="float32",
        )
        batch, seq = 4, 64

    rc = run_config(cfg.name, "train_4k", microbatches=1, remat="none")
    rc = dataclasses.replace(
        rc, learning_rate=1e-3, warmup_steps=20, xent_chunk=64,
        attn_chunk_kv=64, flash_vjp=True,
    )
    init = make_init(cfg, rc, device=dev)
    params, opt = init(torch.Generator(device=dev).manual_seed(0))
    n = sum(p.numel() for p in pytree.tree_leaves(params))
    print(f"[train_lm] {cfg.name}-family, {n/1e6:.1f}M params, "
          f"{args.steps} steps, batch {batch} x seq {seq}")

    stream = TokenStream(cfg, batch, seq, seed=0)
    # donated, as train_lm.py jits its step with donate_argnums=(0, 1)
    step = make_train_step(cfg, rc, donate=True)
    with tempfile.TemporaryDirectory(prefix="train_lm_torch_") as tmp:
        trainer = ResilientTrainer(
            train_step=step, stream=stream, ckpt_dir=args.ckpt_dir or tmp,
            ckpt_every=50,
            failure_hook=flaky({args.steps // 2}),  # mid-run node failure
        )
        try:
            params, opt = trainer.run(params, opt, args.steps)
        finally:
            stream.close()
    r = trainer.report
    k = max(len(r.losses) // 6, 1)
    print(f"[train_lm] loss curve: "
          + " -> ".join(f"{l:.3f}" for l in r.losses[::k]))
    print(f"[train_lm] failures={r.failures} restores={r.restores} "
          f"stragglers={r.stragglers} (run survived the injected failure)")
    assert r.last_loss < r.losses[0]


if __name__ == "__main__":
    main()
