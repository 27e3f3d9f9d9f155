"""Plain PyTorch reference of Jamba (AI21-Jamba2-Mini, the Jamba 1.5 Mini
architecture; arXiv:2403.19887, 2408.12570): its prefill, in float32 with
TF32 off.

It follows the layer equations of transformers' ``JambaForCausalLM``
(``models/jamba/modeling_jamba.py``) as the configuration states them.
Each layer is ``x + mixer(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``; the
mixer of layer ``i`` is the configuration's ``layer_pattern[i % period]``:

* **attention**: causal grouped-query attention with no positional
  encoding at all (Jamba applies no RoPE), computed over blocks of queries;
* **Mamba-1**: ``in_proj`` to x and the gate z; a causal depthwise
  convolution of ``ssm_conv`` taps with its bias, then SiLU; ``x_proj`` to
  (dt, B, C), each RMS-normalised with its own scale (``dt_layernorm``,
  ``b_layernorm``, ``c_layernorm``); dt = softplus(``dt_proj`` dt +
  ``dt_bias``); A = -exp(``A_log``); the recurrence h_t = exp(dt_t A) h +
  dt_t B_t x_t, y_t = h_t C_t (float32); then (y + D x) SiLU(z) and
  ``out_proj``.  Its cache is the last ``ssm_conv - 1`` inputs of the
  convolution and the final h;

the feed-forward is a SwiGLU MLP or, on the layers ``i % moe_every ==
moe_offset``, a float32 softmax router whose top-k probabilities are the
gates as they are (Jamba does not renormalise them), over SwiGLU experts.

Departures from the published model: the routing runs under GShard's
capacity, as the port runs it (the tokens cut into groups of
``moe_group_size``, each expert taking at most ``ceil(top_k x group / E x
capacity_factor)`` claims of a group, counted token by token; a claim over
capacity adds nothing and is counted in ``drops``), where Jamba routes
without one; and random weights.

The recurrence is its own: each segment of ``SEGMENT`` steps is cut into
blocks of ``BLOCK`` steps, every block scanned from a zero state at once
(its running state and its running product of decays), then the blocks'
starting states carried from block to block, then every step's state
formed as its block's running state plus its running decay times the
block's starting state.  It imports nothing of the port and takes nothing
the program made: the weights are drawn again from the seed, one layer at
a time, and computed on in float32.  ``Arith("fp8")`` is the control, as
in ``transformer.py``: every product of bfloat16 weights takes float8
operands; the router, the convolution and the recurrence stay float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .transformer import Arith, attention, head, head_dim, is_moe, mlp, no_tf32, rmsnorm  # noqa: F401

SEGMENT = 2048  # steps of the recurrence whose decays exist at once
BLOCK = 64  # steps a block scans from a zero state


def is_mamba(cfg: dict, i: int) -> bool:
    pattern = cfg["layer_pattern"]
    return pattern[i % len(pattern)] == "mamba"


def scan(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
         x: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over dt, x (B, S, di), B, C (B, S, ds) from the state
    h (B, di, ds): (y (B, S, di), the last state)."""
    Bsz, S, di = x.shape
    ys = []
    for s0 in range(0, S, SEGMENT):
        s1 = min(S, s0 + SEGMENT)
        L = s1 - s0
        n = -(-L // BLOCK)
        pad = n * BLOCK - L
        dts = F.pad(dt[:, s0:s1], (0, 0, 0, pad))  # padded steps: decay 1, input 0
        a = torch.exp(dts[..., None] * A)  # (B, n BLOCK, di, ds)
        b = dts[..., None] * F.pad(Bm[:, s0:s1], (0, 0, 0, pad))[:, :, None, :] \
            * F.pad(x[:, s0:s1], (0, 0, 0, pad))[..., None]
        a = a.view(Bsz, n, BLOCK, di, -1)
        b = b.view(Bsz, n, BLOCK, di, -1)
        run = torch.zeros_like(b[:, :, 0])
        decay = torch.ones_like(a[:, :, 0])
        for t in range(BLOCK):  # every block at once, from a zero state
            run = a[:, :, t] * run + b[:, :, t]
            decay = decay * a[:, :, t]
            b[:, :, t] = run
            a[:, :, t] = decay
        starts = torch.empty_like(run)
        for k in range(n):  # each block's starting state
            starts[:, k] = h
            h = a[:, k, -1] * h + b[:, k, -1]
        b.addcmul_(a, starts[:, :, None])  # every step's state
        c = F.pad(Cm[:, s0:s1], (0, 0, 0, pad)).view(Bsz, n, BLOCK, -1)
        ys.append(torch.einsum("bntds,bnts->bntd", b, c).reshape(Bsz, n * BLOCK, di)[:, :L])
        del a, b
    return torch.cat(ys, dim=1), h


def mamba(hs: torch.Tensor, w: dict, cfg: dict, arith: Arith):
    """(the mixer's output (B, S, d), its cache (the convolution's last
    inputs (B, dc - 1, di), the final state (B, di, ds)))."""
    Bsz, S, d = hs.shape
    di, ds, dc = cfg["ssm_expand"] * d, cfg["ssm_state"], cfg["ssm_conv"]
    dr = cfg.get("ssm_dt_rank") or math.ceil(d / 16)
    eps = cfg["rmsnorm_eps"]
    xz = arith.mm(hs, w["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    xc = F.silu(sum(xp[:, j:j + S] * w["conv_w"][j] for j in range(dc)) + w["conv_b"])
    dt, Bm, Cm = arith.mm(xc, w["x_proj"]).split([dr, ds, ds], dim=-1)
    dt = F.softplus(arith.mm(rmsnorm(dt, w["dt_norm"], eps), w["dt_proj"]) + w["dt_bias"])
    y, h = scan(dt, -torch.exp(w["A_log"]), rmsnorm(Bm, w["b_norm"], eps),
                rmsnorm(Cm, w["c_norm"], eps), xc, hs.new_zeros(Bsz, di, ds))
    y = (y + xc * w["D"]) * F.silu(z)
    return arith.mm(y, w["out_proj"]), (xp[:, S:].clone(), h)


def mixer_input(cfg: dict, weights, tokens: torch.Tensor) -> torch.Tensor:
    """The input of layer 0's mixer for the prompts ``tokens`` (B, S): the
    embedding under the layer's first norm, float32 (B, S, d)."""
    embed = weights.top()["embed"].float()[tokens]
    return rmsnorm(embed, weights.layer(0)["norm1"].float(), cfg["rmsnorm_eps"])


def moe(h: torch.Tensor, w: dict, cfg: dict, arith: Arith, drops: list | None = None):
    """The experts' sum (B, S, d), the top-k probabilities as the gates,
    under GShard's capacity (module docstring); appends (claims dropped
    over capacity, claims) to ``drops`` where it is given."""
    B, S, d = h.shape
    E, K = cfg["n_experts"], cfg["top_k"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    gates, idx = torch.topk(torch.softmax(x @ w["router"], dim=-1), K, dim=-1)
    group = min(cfg["moe_group_size"], T)
    if T % group:
        raise ValueError(f"{T} tokens do not split into groups of {group}")
    cap = max(math.ceil(K * group / E * cfg["capacity_factor"]), 1)
    claims = F.one_hot(idx.reshape(T // group, group * K), E)  # token-major
    rank = (claims.cumsum(1) - claims).gather(-1, idx.reshape(T // group, group * K, 1))
    keep = (rank[..., 0] < cap).reshape(T, K)
    if drops is not None:
        drops.append((int((~keep).sum()), keep.numel()))
    y = torch.zeros_like(x)
    for e in range(E):
        sel = (idx == e) & keep
        tok = sel.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        gate = (gates * sel).sum(-1)[tok]
        y = y.index_add(0, tok, mlp(x[tok], w["w1"][e], w["w3"][e], w["w2"][e], arith)
                        * gate[:, None])
    return y.reshape(B, S, d)


def layer_forward(x: torch.Tensor, w: dict, cfg: dict, i: int, arith: Arith,
                  drops: list | None = None):
    """(x after layer ``i``, its cache: (k, v) of an attention layer, (the
    convolution's inputs, h) of a Mamba layer)."""
    B, S, _ = x.shape
    eps = cfg["rmsnorm_eps"]
    h = rmsnorm(x, w["norm1"], eps)
    if is_mamba(cfg, i):
        out, state = mamba(h, w, cfg, arith)
    else:
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
        q = arith.mm(h, w["wq"]).reshape(B, S, H, hd)
        k = arith.mm(h, w["wk"]).reshape(B, S, KV, hd)
        v = arith.mm(h, w["wv"]).reshape(B, S, KV, hd)
        out = arith.mm(attention(q, k, v, window=0, arith=arith).reshape(B, S, H * hd),
                       w["wo"])
        state = (k, v)
    x = x + out
    h = rmsnorm(x, w["norm2"], eps)
    y = moe(h, w, cfg, arith, drops) if is_moe(cfg, i) else mlp(h, w["w1"], w["w3"],
                                                                  w["w2"], arith)
    return x + y, state


def prefill(cfg: dict, weights, batches: list, arith: Arith, on_layer=None,
            drops: list | None = None) -> list:
    """Run each prompt batch (B, S) of ``batches`` through the model, layer
    by layer, calling ``on_layer(i, [cache of layer i for each batch])`` and
    appending each mixture of experts' (claims dropped, claims) to
    ``drops``; returns each batch's last-position logits (B, V), float32.
    ``weights`` draws the weights again: ``weights.top()`` and
    ``weights.layer(i)``."""
    top = {k: t.float() for k, t in weights.top().items()}
    xs = [top["embed"][t] for t in batches]
    with torch.no_grad():
        for i in range(cfg["n_layers"]):
            w = {k: t.float() for k, t in weights.layer(i).items()}
            states = []
            for b, x in enumerate(xs):
                xs[b], state = layer_forward(x, w, cfg, i, arith, drops)
                states.append(state)
            if on_layer is not None:
                on_layer(i, states)
            del w, states
        return [arith.mm(rmsnorm(x[:, -1], top["final_norm"], cfg["rmsnorm_eps"]),
                         head(top, cfg)) for x in xs]
