"""The system under test: how the benchmark drives the port (``repro_torch``).

The only module of the benchmark that imports the port.  It builds the
port's configuration objects from the benchmark's files, lays the drawn
weights out as the port's parameter tree (the same tensors, so the program
updates them in place), reads the port's cache back by layer, and wraps the
port's kernels in ``torch.profiler.record_function`` ranges for the traced
run (:func:`spanned_kernels`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import transformer as T

_MODEL_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def model_config(cfg: dict) -> ModelConfig:
    """The port's ModelConfig of a benchmark configuration (its keys that
    are ModelConfig fields; lists become tuples)."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
          if k in _MODEL_FIELDS}
    return ModelConfig(**kw)


def train_run_config(traffic: dict) -> RunConfig:
    opt = traffic["optimizer"]
    return RunConfig(microbatches=traffic["microbatches"], remat=traffic["remat"],
                     flash_vjp=traffic["flash_vjp"], learning_rate=opt["lr"],
                     warmup_steps=opt["warmup_steps"], weight_decay=opt["weight_decay"],
                     grad_clip=opt["grad_clip"], opt_state_dtype=opt["state_dtype"])


def layer_indices(mcfg: ModelConfig) -> list:
    """[(segment, repeat, sublayer key, layer index)] in the port's layout."""
    out = []
    for s, spec in enumerate(T.segments_of(mcfg)):
        P = len(spec.kinds)
        for r in range(spec.repeats):
            for j in range(P):
                out.append((s, r, f"sub{j}", spec.start_layer + r * P + j))
    return out


def param_tree(mcfg: ModelConfig, weights: dict) -> tuple[dict, dict]:
    """(the port's parameter tree made of the drawn tensors, a tree of the
    same structure holding each leaf's canonical name).  Raises if the tree
    does not match ``models.model.abstract_params`` leaf for leaf."""
    def sub(i: int, names: bool) -> dict:
        def get(leaf):
            key = f"layers.{i}.{leaf}"
            return key if names else weights[key]
        out = {"norm1": get("norm1"), "norm2": get("norm2"),
               "attn": {k: get(k) for k in ("wq", "wk", "wv", "wo")}}
        if f"layers.{i}.router" in weights:
            out["moe"] = {k: get(k) for k in ("router", "w1", "w2", "w3")}
        else:
            out["mlp"] = {k: get(k) for k in ("w1", "w2", "w3")}
        return out

    def build(names: bool) -> dict:
        segs = [[{} for _ in range(spec.repeats)] for spec in T.segments_of(mcfg)]
        for s, r, key, i in layer_indices(mcfg):
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
        raise RuntimeError("the port's parameter tree no longer matches the benchmark's "
                           "layout (portbench/program.py::param_tree)")
    return params, names


def leaves_by_name(tree: dict, names: dict) -> dict:
    """{canonical name: leaf} of a tree shaped like the parameters (the
    parameters themselves, or an optimizer moment)."""
    return dict(zip(pytree.tree_leaves(names), pytree.tree_leaves(tree)))


def cache_by_layer(mcfg: ModelConfig, cache: dict) -> list:
    """[(k, v) of layer i] of a cache the port's prefill wrote."""
    out = [None] * mcfg.n_layers
    for s, r, key, i in layer_indices(mcfg):
        entry = cache["segments"][s][r][key]
        out[i] = (entry["k"], entry["v"])
    return out


# ---------------------------------------------------------------------------
# Spans for the traced run
# ---------------------------------------------------------------------------

FWD_SPAN = "portbench.attention"
BWD_SPAN = "portbench.attention.backward"


class AttentionCalls:
    """The attention launches a traced run made while ``on``: (shape, mask)
    of each forward call and of each backward call, in order."""

    def __init__(self):
        self.on = False
        self.forward: list = []
        self.backward: list = []


class _OpenBackward(torch.autograd.Function):
    """Identity on the attention's output; its backward, which runs just
    before the attention's own, opens the backward span."""

    @staticmethod
    def forward(ctx, out, holder, calls, call):
        ctx.holder, ctx.calls, ctx.call = holder, calls, call
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        rf = torch.profiler.record_function(BWD_SPAN)
        rf.__enter__()
        ctx.holder.append(rf)
        ctx.calls.backward.append(ctx.call)
        return g, None, None, None


class _CloseBackward(torch.autograd.Function):
    """Identity on the attention's inputs; its backward, which runs once the
    attention's backward has given all three gradients, closes the span."""

    @staticmethod
    def forward(ctx, q, k, v, holder):
        ctx.holder = holder
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.holder:
            ctx.holder.pop().__exit__(None, None, None)
        return gq, gk, gv, None


def spanned_kernels(kernels: ops.FusedKernels, calls: AttentionCalls) -> ops.FusedKernels:
    """``kernels`` with its attention, while ``calls.on``, inside a
    ``record_function`` range (``FWD_SPAN``), and, where it is
    differentiated, its backward inside another (``BWD_SPAN``); each such
    call's shapes and mask go to ``calls``."""
    inner = kernels.attention

    def attention(q, k, v, *, causal=True, window=0, chunk=0, **kw):
        if not calls.on:
            return inner(q, k, v, causal=causal, window=window, chunk=chunk, **kw)
        call = (tuple(q.shape), tuple(k.shape), bool(causal), int(window), int(chunk),
                q.element_size())
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
        holder: list = []
        if grad:
            q, k, v = _CloseBackward.apply(q, k, v, holder)
        with torch.profiler.record_function(FWD_SPAN):
            calls.forward.append(call)
            out = inner(q, k, v, causal=causal, window=window, chunk=chunk, **kw)
        if grad:
            out = _OpenBackward.apply(out, holder, calls, call)
        return out

    return dataclasses.replace(kernels, attention=attention)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def build_kernels(names: list, device: str) -> None:
    """Build (or find already built in ``build/kernels/``) the kernel
    libraries of ``repro_torch.kernels.<name>`` for each name, all at once;
    nothing on the CPU, where the kernels' plain versions run."""
    if device != "cuda" or not names:
        return
    import importlib

    from repro_torch.kernels import builder

    builder.build_many([importlib.import_module(f"repro_torch.kernels.{n}").KERNEL
                        for n in names])


def adamw_config(opt: dict):
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                       weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                       state_dtype=opt["state_dtype"])


def init_opt_state(params: dict, opt_cfg):
    from repro_torch.optim import init_opt_state as init

    return init(params, opt_cfg)


def train_step(mcfg: ModelConfig, rc: RunConfig, opt_cfg, kernels=None):
    """The donated training step ``launch.train.run`` builds."""
    from repro_torch.runtime.steps import make_train_step

    return make_train_step(mcfg, rc, opt_cfg, None, kernels=kernels, donate=True)


def train_kernels(rc: RunConfig) -> ops.FusedKernels:
    return ops.train_kernels(rc.mamba_chunk)


def prefill_step(mcfg: ModelConfig, kernels: ops.FusedKernels = ops.KERNELS):
    """The port's prefill step and the cache it fills:
    ``(step(params, cache, batch), new_cache(batch, length))``."""
    from repro_torch.runtime.steps import make_prefill_step

    rc = RunConfig(remat="none")

    def new_cache(batch: int, length: int, device):
        return M.init_cache(mcfg, batch, length, ring=rc.local_ring_cache, device=device)

    return make_prefill_step(mcfg, rc, kernels=kernels), new_cache



SERVE_KERNELS = ops.KERNELS
