"""Serving entry point: batched prefill + greedy decode with a KV / SSM-state cache.

``python -m repro_torch.launch.serve --arch qwen3 --full --requests 8 --prompt-len 512 --gen 32``
``python -m repro_torch.launch.serve --arch seamless --full --requests 8 --prompt-len 512 --gen 32``
``python -m repro_torch.launch.serve --arch arctic --full --layers 2 --requests 8 --prompt-len 512 --gen 32``

The port of the JAX package's ``launch/serve.py``, for every registry
config: builds a cache (KV buffers for attention layers, the conv inputs
and the SSM state for Mamba layers; for the encoder-decoder, the decoder's
KV buffers and the cross-attention buffers for the encoder's
``frontend_len`` frames), prefills a batch of synthetic prompts, then
decodes tokens greedily.  It takes the reference's flags plus ``--device``
(default ``cuda``; without CUDA it raises unless given ``--device cpu``)
and ``--layers``.  ``--reduced`` (the default) runs ``scaled_down(cfg)``;
``--full`` the config at full width and depth, or its first ``--layers N``
layers (``--full`` mixtral holds 92.9 GB of bfloat16 weights, more than
one 80 GB card; :func:`run` serves any config object).  Weights come from
a ``torch.Generator`` seeded with ``--seed``, at the reference's
initialisation scales.  On the card every
attention over more than one query runs through the flash-attention
kernel, every dense MLP through the fused-MLP kernel and every selective
scan (the prompt's, and each decode step's) through the selective-scan
kernel; ``main(kernels=ops.PLAIN)`` runs their plain versions instead, for
comparison.  MoE experts are PyTorch batched products, as the reference
leaves them to XLA.
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
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first N layers (default: all); "
                         "the depth cut that fits a model's weights on one card")
    return ap.parse_args(argv)


def cache_entries(cfg, prompt_len: int, gen: int) -> int:
    """The positions a serve's cache holds: the prompt, the generated
    tokens and 8 spare, after the ``cfg.frontend_len`` frontend frames that
    a decoder-only model with a frontend (internvl2's vision prefix) puts
    before the prompt.  The encoder-decoder's frames go to its encoder,
    whose cross-attention buffers :func:`repro_torch.models.model.init_cache`
    sizes itself."""
    prefix = cfg.frontend_len if cfg.frontend and not cfg.is_encoder_decoder else 0
    return prefix + prompt_len + gen + 8


def run(cfg, rc, *, requests: int, prompt_len: int, gen: int, seed: int = 0,
        device: "str | torch.device" = "cuda",
        kernels: ops.FusedKernels = ops.KERNELS) -> dict:
    """Serve ``requests`` synthetic prompts of ``prompt_len`` tokens (and
    ``cfg.frontend_len`` frontend frames) and decode ``gen`` tokens each,
    greedily, through ``runtime.steps``' prefill and decode steps.  The
    cache is a ring for local-attention layers when ``rc.local_ring_cache``.
    Returns ``{"ids": (requests, gen), "prefill_s", "decode_s_per_token"}``
    (host clock; the prefill's ends when its first ids reach the host)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, generator=generator, device=dev)
    B = requests
    max_seq = cache_entries(cfg, prompt_len, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, prompt_len),
                                     generator=generator, device=dev)}
    if cfg.frontend:
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_len, cfg.d_model), generator=generator, device=dev,
        ).to(getattr(torch, cfg.dtype))

    prefill = make_prefill_step(cfg, rc, kernels=kernels)
    decode = make_decode_step(cfg, rc, kernels=kernels)

    with torch.inference_mode():
        cache = M.init_cache(cfg, B, max_seq, ring=rc.local_ring_cache, device=dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, batch)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        generated = [tok.cpu().numpy()]  # waits for the prefill
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = decode(params, cache, tok)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(tok.cpu().numpy())
        t_decode = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())

    if not finite:
        raise RuntimeError("non-finite logits")
    return {"ids": np.concatenate(generated, axis=1), "prefill_s": t_prefill,
            "decode_s_per_token": t_decode / max(gen - 1, 1)}


def main(argv=None, *, kernels: ops.FusedKernels = ops.KERNELS) -> np.ndarray:
    """Serve ``--requests`` synthetic prompts; print the reference's three
    lines and return the generated ids (requests, gen)."""
    args = parse_args(argv)
    cfg = resolve(args.arch)
    if args.layers is not None:  # the registry's depth, cut before any reduction
        if not 0 < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.reduced:
        cfg = scaled_down(cfg, max_seq_len=args.prompt_len + args.gen + 8)
    rc = run_config(cfg.name, "decode_32k")
    rc = dataclasses.replace(
        rc, attn_chunk_kv=min(64, args.prompt_len), mamba_chunk=16,
        xent_chunk=64,
    )
    res = run(cfg, rc, requests=args.requests, prompt_len=args.prompt_len,
              gen=args.gen, seed=args.seed, device=args.device, kernels=kernels)
    out = res["ids"]
    print(f"[serve] {cfg.name}: {args.requests} requests, prompt {args.prompt_len}, "
          f"generated {out.shape[1]} tokens/req")
    print(f"[serve] prefill {res['prefill_s']*1e3:.0f} ms; decode "
          f"{res['decode_s_per_token'] * 1e3:.1f} ms/token")
    print(f"[serve] sample token ids: {out[0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
