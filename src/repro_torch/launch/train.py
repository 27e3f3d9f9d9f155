"""Training entry point: ``python -m repro_torch.launch.train --arch qwen3 ...``.

The port of the JAX package's ``launch/train.py`` on one device: config
registry -> model -> data pipeline -> fault-tolerant trainer ->
checkpoints.  It takes the reference's flags plus ``--device`` (default
``cuda``; without CUDA it raises unless given ``--device cpu``).
``--reduced`` (the default) trains ``scaled_down(cfg)``; ``--full`` the
config at full width and depth.  Weights come from a ``torch.Generator``
seeded with ``--seed``, at the reference's initialisation scales; the
batches from ``TokenStream`` (the reference's synthetic data, bit for bit).
On the card the attention runs through the flash-attention kernel and its
backward kernel; the MLP and the scan train through the model's own torch
ops (``ops.train_kernels``), as the reference trains them through ``jnp``.
There is no device mesh: the sharded training path is a later slice.
:func:`run` trains a config object with a run config, as ``main`` builds
them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.utils import _pytree as pytree

from ..configs import resolve, run_config, scaled_down
from ..data import TokenStream
from ..device import resolve_device
from ..optim import AdamWConfig
from ..runtime.fault_tolerance import ResilientTrainer, flaky
from ..runtime.steps import make_init, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="scaled-down config (CPU-sized); --full trains the "
                         "config at full width and depth")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps to fail at (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(cfg, rc, *, steps: int, batch: int, seq: int, ckpt_dir,
        ckpt_every: int, inject_failures=(), seed: int = 0,
        device: "str | torch.device" = "cuda") -> dict:
    """Train ``cfg`` under ``rc`` for ``steps`` steps of ``batch`` sequences
    of ``seq`` tokens (plus the frontend's frames for a decoder with a
    frontend stub), checkpointing into ``ckpt_dir`` every ``ckpt_every``
    steps and failing once at each step of ``inject_failures``.  Returns
    {"report": the trainer's report, "seconds": the trainer's wall time,
    "params", "opt_state", "n_params"}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt_cfg = AdamWConfig(state_dtype=rc.opt_state_dtype,
                          weight_decay=rc.weight_decay, grad_clip=rc.grad_clip)
    params, opt_state = make_init(cfg, rc, opt_cfg, device=dev)(gen)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    if cfg.frontend and not cfg.is_encoder_decoder:
        seq = seq + cfg.frontend_len
    stream = TokenStream(cfg, batch, seq, seed=seed)
    try:
        hook = flaky(set(inject_failures)) if inject_failures else None
        trainer = ResilientTrainer(
            train_step=make_train_step(cfg, rc, opt_cfg), stream=stream,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, failure_hook=hook)
        t0 = time.perf_counter()
        params, opt_state = trainer.run(params, opt_state, steps)
        seconds = time.perf_counter() - t0
    finally:
        stream.close()
    return {"report": trainer.report, "seconds": seconds, "params": params,
            "opt_state": opt_state, "n_params": n_params}


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    cfg = resolve(args.arch)
    if args.reduced:
        cfg = scaled_down(cfg)
    rc = run_config(cfg.name, "train_4k", microbatches=1, remat="none")
    rc = dataclasses.replace(
        rc, learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
        xent_chunk=min(64, args.seq), attn_chunk_kv=min(64, args.seq),
        mamba_chunk=16,
    )
    fails = tuple(int(s) for s in args.inject_failures.split(",") if s)
    out = run(cfg, rc, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              inject_failures=fails, seed=args.seed, device=args.device)
    print(f"[train] {cfg.name} reduced={args.reduced} params={out['n_params']:,}")
    r, dt = out["report"], out["seconds"]
    print(
        f"[train] {r.steps_run} steps in {dt:.1f}s "
        f"({dt / max(r.steps_run, 1) * 1e3:.0f} ms/step)  "
        f"loss {r.losses[0]:.4f} -> {r.last_loss:.4f}  "
        f"failures={r.failures} restores={r.restores} "
        f"stragglers={r.stragglers}"
    )
    return r


if __name__ == "__main__":
    main()
