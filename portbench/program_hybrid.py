"""How the benchmark drives the port on a hybrid configuration (Mamba-1
mixers beside attention): ``program.py``'s work for the leaves and the
cache entries that configuration adds.  Like ``program.py`` it imports the
port, and only the driver and the tests import it.

The configuration's file states Jamba's three switches (``rope``,
``moe_renormalize``, ``ssm_inner_norms``), which the port's
``configs.base.JambaConfig`` holds as fields; :func:`param_tree` checks the
tree it builds against the port's ``abstract_params`` leaf for leaf, so a
port that lacks the mixer's inner norms fails there, before any kernel is
built or weight drawn.
"""
from __future__ import annotations

import dataclasses

from torch.utils import _pytree as pytree

from repro_torch.configs import base as CB
from repro_torch.models import model as M

from . import program as P


def model_config(cfg: dict):
    """The port's config of a hybrid benchmark configuration: its keys that
    are fields of the port's ``JambaConfig`` (lists become tuples)."""
    fields = {f.name for f in dataclasses.fields(CB.JambaConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    return CB.JambaConfig(**kw)


# A Mamba mixer's leaves in the port's order (``models/ssm.py::init_mamba``).
MAMBA_ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
               "out_proj", "dt_norm", "b_norm", "c_norm")


def param_tree(mcfg, weights: dict) -> tuple[dict, dict]:
    """(the port's parameter tree made of the drawn tensors, a tree of the
    same structure holding each leaf's canonical name); ``weights`` may be
    ``"meta"`` tensors (``weights_hybrid.specs``).  Raises if the tree does
    not match ``models.model.abstract_params`` leaf for leaf."""
    def sub(i: int, names: bool) -> dict:
        def get(leaf):
            key = f"layers.{i}.{leaf}"
            return key if names else weights[key]
        out = {"norm1": get("norm1"), "norm2": get("norm2")}
        if mcfg.mixer_of(i) == "mamba":
            out["mamba"] = {k: get(k) for k in MAMBA_ORDER}
        else:
            out["attn"] = {k: get(k) for k in ("wq", "wk", "wv", "wo")}
        if f"layers.{i}.router" in weights:
            out["moe"] = {k: get(k) for k in ("router", "w1", "w2", "w3")}
        else:
            out["mlp"] = {k: get(k) for k in ("w1", "w2", "w3")}
        return out

    def build(names: bool) -> dict:
        segs = [[{} for _ in range(spec.repeats)] for spec in P.T.segments_of(mcfg)]
        for s, r, key, i in P.layer_indices(mcfg):
            segs[s][r][key] = sub(i, names)
        tree = {"embed": "embed" if names else weights["embed"],
                "final_norm": "final_norm" if names else weights["final_norm"],
                "segments": segs}
        if not mcfg.tie_embeddings:
            tree["lm_head"] = "lm_head" if names else weights["lm_head"]
        return tree

    params, names = build(False), build(True)
    want, want_spec = pytree.tree_flatten(M.abstract_params(mcfg))
    got, spec = pytree.tree_flatten(params)
    if spec != want_spec or any(a.shape != b.shape or a.dtype != b.dtype
                                for a, b in zip(got, want)):
        raise RuntimeError("the port's parameter tree does not match the hybrid "
                           "configuration's leaves (portbench/program_hybrid.py::param_tree): "
                           "a port without Jamba's Mamba inner norms cannot run it")
    return params, names


def states_by_layer(mcfg, cache: dict) -> list:
    """[(k, v) of an attention layer, or (conv inputs, h) of a Mamba layer,
    for each layer i] of a cache the port's prefill wrote."""
    out = [None] * mcfg.n_layers
    for s, r, key, i in P.layer_indices(mcfg):
        entry = cache["segments"][s][r][key]
        out[i] = (entry["conv"], entry["h"]) if "h" in entry else (entry["k"], entry["v"])
    return out

