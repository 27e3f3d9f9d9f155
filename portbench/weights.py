"""Seeded weights of a transformer configuration, made on the device.

The benchmark makes the weights and hands the same tensors to the program
and, once the program's state is freed, draws them again for the plain
reference.  Each block (the embedding with the head and the final norm, and
each layer) is drawn by its own generator, seeded from the run's seed and
the block, in one ``randn`` call per dtype, in the dtype the model is
served in; the leaves are views of that draw, scaled in place.  So a block
can be drawn again alone and comes out bit for bit the same.

Leaves have canonical names: ``embed`` (V, d), ``lm_head`` (d, V),
``final_norm`` (d,) and, for layer ``l``, ``layers.<l>.<leaf>``: ``norm1``,
``wq`` (d, H hd), ``wk``, ``wv`` (d, KV hd), ``wo`` (H hd, d), ``norm2``,
then ``w1``, ``w3`` (d, ff) and ``w2`` (ff, d) of the MLP, or ``router``
(d, E) in float32 and ``w1``, ``w3`` (E, d, ff) and ``w2`` (E, ff, d) of the
experts.  Matrices are normal times 1/sqrt(fan in), the embedding normal
times the configuration's ``embed_scale`` (0.02 where it names none), norm
scales ones.
"""
from __future__ import annotations

import math

import torch

from . import cost
from .seeds import derive

ONES = "ones"


def layer_specs(cfg: dict, i: int) -> list[tuple[str, tuple, str, object]]:
    """(leaf, shape, dtype name, scale or ``ONES``) of layer ``i``'s leaves."""
    d, hd, dt = cfg["d_model"], cost.head_dim(cfg), cfg["dtype"]
    q_dim, kv_dim, ff = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]
    specs = [("norm1", (d,), dt, ONES),
             ("wq", (d, q_dim), dt, 1 / math.sqrt(d)),
             ("wk", (d, kv_dim), dt, 1 / math.sqrt(d)),
             ("wv", (d, kv_dim), dt, 1 / math.sqrt(d)),
             ("wo", (q_dim, d), dt, 1 / math.sqrt(q_dim)),
             ("norm2", (d,), dt, ONES)]
    if cost.is_moe_layer(cfg, i):
        E = cfg["n_experts"]
        specs += [("router", (d, E), "float32", 1 / math.sqrt(d)),
                  ("w1", (E, d, ff), dt, 1 / math.sqrt(d)),
                  ("w3", (E, d, ff), dt, 1 / math.sqrt(d)),
                  ("w2", (E, ff, d), dt, 1 / math.sqrt(ff))]
    else:
        specs += [("w1", (d, ff), dt, 1 / math.sqrt(d)),
                  ("w3", (d, ff), dt, 1 / math.sqrt(d)),
                  ("w2", (ff, d), dt, 1 / math.sqrt(ff))]
    return specs


def top_specs(cfg: dict) -> list[tuple[str, tuple, str, object]]:
    """The embedding, the final norm and the (untied) head."""
    d, V, dt = cfg["d_model"], cfg["vocab_size"], cfg["dtype"]
    specs = [("embed", (V, d), dt, cfg.get("embed_scale", 0.02)),
             ("final_norm", (d,), dt, ONES)]
    if not cfg.get("tie_embeddings", False):
        specs.append(("lm_head", (d, V), dt, 1 / math.sqrt(d)))
    return specs


def draw(specs, seed: int, tag, device) -> dict[str, torch.Tensor]:
    """The leaves of ``specs``: one ``randn`` per dtype from a generator
    seeded with ``derive(seed, "weights", tag)``, viewed and scaled in
    place; ``ONES`` leaves are filled with ones and draw nothing."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", tag))
    out = {}
    for dtype_name in sorted({s[2] for s in specs}):
        dtype = getattr(torch, dtype_name)
        mine = [s for s in specs if s[2] == dtype_name]
        drawn = [s for s in mine if s[3] is not ONES]
        n = sum(math.prod(s[1]) for s in drawn)
        flat = (torch.randn(n, generator=gen, dtype=dtype, device=device) if n
                else None)
        at = 0
        for name, shape, _, scale in mine:
            if scale is ONES:
                out[name] = torch.ones(shape, dtype=dtype, device=device)
                continue
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(scale)
            at += size
    return out


def top(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``embed``, ``final_norm`` and ``lm_head``."""
    return draw(top_specs(cfg), seed, "top", device)


def layer(cfg: dict, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    """Layer ``i``'s leaves, by their short names."""
    return draw(layer_specs(cfg, i), seed, ("layer", i), device)


def all_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf by its canonical name."""
    out = dict(top(cfg, seed, device))
    for i in range(cfg["n_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer(cfg, seed, i, device).items()})
    return out


class Weights:
    """The drawn weights of one run, to be drawn again block by block:
    what the reference is handed in place of the program's parameters."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device

    def top(self) -> dict[str, torch.Tensor]:
        return top(self.cfg, self.seed, self.device)

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return layer(self.cfg, self.seed, i, self.device)

    def all(self) -> dict[str, torch.Tensor]:
        return all_weights(self.cfg, self.seed, self.device)

    def delta_norms(self, params: dict[str, torch.Tensor]) -> dict[str, float]:
        """{leaf: norm of ``params[leaf]`` minus the drawn leaf}, over the
        leaves of ``params`` (canonical names), drawing one block at a time."""
        out = {}
        with torch.no_grad():
            for name, t in self.top().items():
                if name in params:
                    out[name] = float((params[name].float() - t.float()).norm())
            for i in range(self.cfg["n_layers"]):
                for name, t in self.layer(i).items():
                    key = f"layers.{i}.{name}"
                    if key in params:
                        out[key] = float((params[key].float() - t.float()).norm())
        return out
