"""Abstract input specs ("meta" tensors) for every (arch x shape) cell.

The port of the JAX package's ``launch/input_specs.py``: nothing is
allocated here.  The sharding rules (:func:`repro_torch.parallel.sharding.
batch_shardings` / ``cache_shardings``) are computed on these stand-ins, and
the same shapes are what ``repro_torch.data`` feeds the train and serve
drivers.
"""
from __future__ import annotations

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models import model as M


def _sds(shape, dtype) -> torch.Tensor:
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {
            "frontend": _sds((B, cfg.frontend_len, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
    if cfg.frontend:
        return {
            "frontend": _sds((B, cfg.frontend_len, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, S - cfg.frontend_len), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
    return {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {
            "frontend": _sds((B, cfg.frontend_len, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, S), torch.int32),
        }
    if cfg.frontend:
        return {
            "frontend": _sds((B, cfg.frontend_len, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, S - cfg.frontend_len), torch.int32),
        }
    return {"tokens": _sds((B, S), torch.int32)}


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return _sds((shape.global_batch, 1), torch.int32)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *, ring: bool = False) -> dict:
    """KV / SSM cache sized for the cell's context (decode: prefilled)."""
    return M.abstract_cache(cfg, shape.global_batch, shape.seq_len, ring=ring)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, ring: bool = False) -> dict:
    """All abstract inputs of the cell's step function.

    train  -> {"batch": ...}
    prefill-> {"batch": ..., "cache": ...}
    decode -> {"tokens": ..., "cache": ...}
    """
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape),
                "cache": cache_specs(cfg, shape, ring=ring)}
    return {"tokens": decode_token_specs(shape),
            "cache": cache_specs(cfg, shape, ring=ring)}
