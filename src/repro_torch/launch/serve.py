"""Serving entry point: batched prefill + greedy decode with a KV / SSM-state cache.

``python -m repro_torch.launch.serve --arch qwen3 --full --requests 8 --prompt-len 512 --gen 32``
``python -m repro_torch.launch.serve --arch falcon-mamba --full --requests 8 --prompt-len 512 --gen 32``

The port of the JAX package's ``launch/serve.py``: builds a cache (KV
buffers for attention layers, the conv inputs and the SSM state for Mamba
layers), prefills a batch of synthetic prompts, then decodes tokens
greedily.  It
takes the reference's flags plus ``--device`` (default ``cuda``; without
CUDA it raises unless given ``--device cpu``).  ``--reduced`` (the
default) runs ``scaled_down(cfg)``; ``--full`` the config at full width
and depth.  Weights come from a ``torch.Generator`` seeded with ``--seed``,
at the reference's initialisation scales.  On the card the prompt's
attention runs through the flash-attention kernel, every MLP through the
fused-MLP kernel and every selective scan (the prompt's, and each decode
step's) through the selective-scan kernel; ``main(kernels=ops.PLAIN)`` runs
their plain versions instead, for comparison.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import resolve, run_config, scaled_down
from ..device import resolve_device
from ..kernels import ops
from ..models import model as M
from ..runtime.steps import make_decode_step, make_prefill_step


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, kernels: ops.FusedKernels = ops.KERNELS) -> np.ndarray:
    """Serve ``--requests`` synthetic prompts; print the reference's three
    lines and return the generated ids (requests, gen)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = resolve(args.arch)
    if args.reduced:
        cfg = scaled_down(cfg, max_seq_len=args.prompt_len + args.gen + 8)
    rc = run_config(cfg.name, "decode_32k")
    rc = dataclasses.replace(
        rc, attn_chunk_kv=min(64, args.prompt_len), mamba_chunk=16,
        xent_chunk=64,
    )

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen, device=dev)
    B = args.requests
    max_seq = args.prompt_len + args.gen + 8
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.frontend:
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_len, cfg.d_model), generator=gen, device=dev,
        ).to(getattr(torch, cfg.dtype))

    prefill = make_prefill_step(cfg, rc, kernels=kernels)
    decode = make_decode_step(cfg, rc, kernels=kernels)

    with torch.inference_mode():
        cache = M.init_cache(cfg, B, max_seq, device=dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, batch)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        generated = [tok.cpu().numpy()]  # waits for the prefill
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = decode(params, cache, tok)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(tok.cpu().numpy())
        t_decode = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())

    if not finite:
        raise RuntimeError("non-finite logits")
    out = np.concatenate(generated, axis=1)
    print(f"[serve] {cfg.name}: {B} requests, prompt {args.prompt_len}, "
          f"generated {out.shape[1]} tokens/req")
    print(f"[serve] prefill {t_prefill*1e3:.0f} ms; decode "
          f"{t_decode / max(args.gen - 1, 1) * 1e3:.1f} ms/token")
    print(f"[serve] sample token ids: {out[0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
