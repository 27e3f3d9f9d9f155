"""Seeded weights of a hybrid configuration (Mamba-1 mixers beside
attention, ``configs/jamba2-mini.json``), made on the device.

The leaves of ``weights.py`` (same names, scales and dtypes) with, for a
layer whose mixer is ``mamba``, the mixer's leaves in place of the
attention's: ``in_proj`` (d, 2 di), ``conv_w`` (dc, di), ``conv_b`` (di,),
``x_proj`` (di, dt_rank + 2 ds), ``dt_proj`` (dt_rank, di), ``out_proj``
(di, d) in the served dtype, normal times 1/sqrt(fan in) (the conv's fan
in is dc, its bias drawn at the same scale); the inner norms' scales
``dt_norm`` (dt_rank,), ``b_norm``, ``c_norm`` (ds,), ones; and in
float32 ``A_log`` (di, ds) = log [1..ds] on every channel (S4D-real),
``D`` (di,) ones and ``dt_bias`` (di,) the inverse softplus of a dt drawn
uniform in [1e-3, 0.1] (Mamba's own initialisation).  Each layer is drawn
by its own generators (the normal leaves as ``weights.draw`` draws them,
``dt_bias`` from a second stream), so a layer drawn again alone comes out
bit for bit the same.
"""
from __future__ import annotations

import math

import torch

from . import weights as W
from .seeds import derive


def is_mamba(cfg: dict, i: int) -> bool:
    pattern = cfg.get("layer_pattern", ["attn"])
    return pattern[i % len(pattern)] == "mamba"


def d_inner(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"]


def dt_rank(cfg: dict) -> int:
    return cfg.get("ssm_dt_rank") or math.ceil(cfg["d_model"] / 16)


def mamba_specs(cfg: dict) -> list[tuple[str, tuple, str, object]]:
    """(leaf, shape, dtype name, scale or ``weights.ONES``) of a Mamba
    mixer's drawn and unit leaves, in the port's order."""
    d, di, ds, dc, dr, dt = (cfg["d_model"], d_inner(cfg), cfg["ssm_state"],
                             cfg["ssm_conv"], dt_rank(cfg), cfg["dtype"])
    return [("in_proj", (d, 2 * di), dt, 1 / math.sqrt(d)),
            ("conv_w", (dc, di), dt, 1 / math.sqrt(dc)),
            ("conv_b", (di,), dt, 1 / math.sqrt(dc)),
            ("x_proj", (di, dr + 2 * ds), dt, 1 / math.sqrt(di)),
            ("dt_proj", (dr, di), dt, 1 / math.sqrt(dr)),
            ("out_proj", (di, d), dt, 1 / math.sqrt(di)),
            ("dt_norm", (dr,), dt, W.ONES),
            ("b_norm", (ds,), dt, W.ONES),
            ("c_norm", (ds,), dt, W.ONES)]


def layer_specs(cfg: dict, i: int) -> list[tuple[str, tuple, str, object]]:
    """The drawn and unit leaves of layer ``i``: ``weights.layer_specs``'
    for an attention layer; for a Mamba layer the mixer's in place of the
    attention's."""
    specs = W.layer_specs(cfg, i)
    if not is_mamba(cfg, i):
        return specs
    attn = ("wq", "wk", "wv", "wo")
    return [s for s in specs if s[0] not in attn] + mamba_specs(cfg)


def _mamba_float32(cfg: dict, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    """``dt_bias``, ``A_log`` and ``D`` of Mamba layer ``i``."""
    di, ds = d_inner(cfg), cfg["ssm_state"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", ("dt", i)))
    u = torch.rand((di,), generator=gen, device=device, dtype=torch.float32)
    dt = torch.clamp(u * (0.1 - 1e-3) + 1e-3, min=1e-4)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device).repeat(di, 1)
    return {"dt_bias": torch.log(torch.expm1(dt)), "A_log": torch.log(a),
            "D": torch.ones((di,), dtype=torch.float32, device=device)}


def layer(cfg: dict, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    """Layer ``i``'s leaves, by their short names."""
    out = W.draw(layer_specs(cfg, i), seed, ("layer", i), device)
    if is_mamba(cfg, i):
        out.update(_mamba_float32(cfg, seed, i, device))
    return out


def all_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf by its canonical name (``layers.<i>.<leaf>``)."""
    out = dict(W.top(cfg, seed, device))
    for i in range(cfg["n_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer(cfg, seed, i, device).items()})
    return out


def specs(cfg: dict) -> dict[str, torch.Tensor]:
    """Every leaf by its canonical name as a ``"meta"`` tensor of its shape
    and dtype: nothing is drawn or allocated."""
    def meta(shape, dtype_name):
        return torch.empty(shape, dtype=getattr(torch, dtype_name), device="meta")

    out = {name: meta(shape, dt) for name, shape, dt, _ in W.top_specs(cfg)}
    for i in range(cfg["n_layers"]):
        for name, shape, dt, _ in layer_specs(cfg, i):
            out[f"layers.{i}.{name}"] = meta(shape, dt)
        if is_mamba(cfg, i):
            di, ds = d_inner(cfg), cfg["ssm_state"]
            for name, shape in (("dt_bias", (di,)), ("A_log", (di, ds)), ("D", (di,))):
                out[f"layers.{i}.{name}"] = meta(shape, "float32")
    return out


class Weights(W.Weights):
    """The drawn weights of one run of a hybrid configuration, to be drawn
    again layer by layer (``weights.Weights`` with the Mamba leaves)."""

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return layer(self.cfg, self.seed, i, self.device)

    def all(self) -> dict[str, torch.Tensor]:
        return all_weights(self.cfg, self.seed, self.device)

    def specs(self) -> dict[str, torch.Tensor]:
        return specs(self.cfg)
