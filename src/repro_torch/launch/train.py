"""Training entry point: ``python -m repro_torch.launch.train --arch qwen3 ...``.

The port of the JAX package's ``launch/train.py``: config registry ->
model -> sharding rules -> data pipeline -> fault-tolerant trainer ->
checkpoints.  It takes the reference's flags plus ``--device`` (default
``cuda``; without CUDA it raises unless given ``--device cpu``) and
``--mesh``.  Under ``torchrun`` with more than one process (or with
``--mesh``), it builds the reference's (1, world) ``("data", "model")``
mesh (NCCL on CUDA, gloo on the CPU) and trains through the sharded step
(:func:`repro_torch.runtime.steps.make_train_step` with the parameters'
shardings); each rank then checkpoints its own pieces under
``<ckpt-dir>/rank<r>``.  Otherwise it trains on one device.
``--reduced`` (the default) trains ``scaled_down(cfg)``; ``--full`` the
config at full width and depth.  Weights come from a ``torch.Generator``
seeded with ``--seed``, at the reference's initialisation scales; the
batches from ``TokenStream`` (the reference's synthetic data, bit for bit).
On the card the attention runs through the flash-attention kernel and its
backward kernel; the MLP and the scan train through the model's own torch
ops (``ops.train_kernels``), as the reference trains them through ``jnp``.
:func:`run` trains a config object with a run config, as ``main`` builds
them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time

import torch
from torch.utils import _pytree as pytree

from ..configs import resolve, run_config, scaled_down
from ..data import TokenStream
from ..device import resolve_device
from ..optim import AdamWConfig
from ..parallel import sharding as SH
from ..runtime.elastic import shardings_for
from ..runtime.fault_tolerance import ResilientTrainer, flaky
from ..runtime.steps import make_init, make_train_step
from .mesh import make_mesh


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
    ap.add_argument("--mesh", action="store_true",
                    help="train through the sharded step on a (1, world) "
                         "('data', 'model') mesh (implied under torchrun with "
                         "more than one process)")
    return ap.parse_args(argv)


def launch_mesh(device: "str | torch.device" = "cuda"):
    """The reference launcher's mesh, (1, world) ``("data", "model")``,
    over the process group ``torchrun`` describes in the environment
    (started here if need be; one process without ``torchrun``)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return make_mesh((1, world), ("data", "model"), device_type=dev.type)


def run(cfg, rc, *, steps: int, batch: int, seq: int, ckpt_dir,
        ckpt_every: int, inject_failures=(), seed: int = 0,
        device: "str | torch.device" = "cuda", mesh=None) -> dict:
    """Train ``cfg`` under ``rc`` for ``steps`` steps of ``batch`` sequences
    of ``seq`` tokens (plus the frontend's frames for a decoder with a
    frontend stub), checkpointing into ``ckpt_dir`` every ``ckpt_every``
    steps and failing once at each step of ``inject_failures``.  With a
    ``mesh`` (a ``DeviceMesh`` of this process group), the parameters and
    the optimizer state are this rank's pieces under the sharding rules and
    the step is the sharded one; checkpoints go to ``ckpt_dir/rank<r>``.
    Returns {"report": the trainer's report, "seconds": the trainer's wall
    time, "params", "opt_state", "n_params"}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt_cfg = AdamWConfig(state_dtype=rc.opt_state_dtype,
                          weight_decay=rc.weight_decay, grad_clip=rc.grad_clip)
    params, opt_state = make_init(cfg, rc, opt_cfg, device=dev)(gen)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    pshard = None
    if mesh is not None:
        import torch.distributed as dist

        pshard, oshard = shardings_for(cfg, mesh, opt_cfg)
        params, opt_state = SH.place(params, pshard), SH.place(opt_state, oshard)
        ckpt_dir = pathlib.Path(ckpt_dir) / f"rank{dist.get_rank()}"
    if cfg.frontend and not cfg.is_encoder_decoder:
        seq = seq + cfg.frontend_len
    stream = TokenStream(cfg, batch, seq, seed=seed)
    try:
        hook = flaky(set(inject_failures)) if inject_failures else None
        trainer = ResilientTrainer(
            train_step=make_train_step(cfg, rc, opt_cfg, pshard), stream=stream,
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
    mesh = None
    if args.mesh or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = launch_mesh(args.device)
    out = run(cfg, rc, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              inject_failures=fails, seed=args.seed, device=args.device, mesh=mesh)
    r, dt = out["report"], out["seconds"]
    if mesh is not None:
        import torch.distributed as dist

        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return r
        print(f"[train] mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
    print(f"[train] {cfg.name} reduced={args.reduced} params={out['n_params']:,}")
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
