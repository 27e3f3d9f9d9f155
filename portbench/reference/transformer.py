"""Plain PyTorch reference of a decoder-only transformer (phi3, mixtral):
its prefill and its training steps with AdamW, in float32 with TF32 off.

It follows the published architecture as the configuration states it:
RMSNorm (``x * rsqrt(mean(x^2) + eps) * scale``), rotate-half RoPE over
positions 0.., causal grouped-query attention (a sliding window where the
layer is a local one), SwiGLU MLPs, and for a mixture of experts a float32
softmax router whose top-k gates are renormalised, with GShard's capacity:
the tokens are cut into groups of ``moe_group_size``, each expert takes at
most ``ceil(top_k x group / E x capacity_factor)`` claims of a group, the
claims counted token by token, and a claim over capacity adds nothing.
The training loss is the mean next-token cross-entropy plus 0.01 x the
load-balance term of each MoE layer; AdamW clips by the global gradient
norm, corrects the moments' bias, decays what the configuration decays and
stores each parameter in the configuration's dtype after each step.

Departures from the published model: the capacity routing above, which the
port runs (Mixtral routes without a capacity), and random weights.

It imports nothing of the port and takes nothing the program made: the
weights are drawn again from the seed (``portbench.weights.Weights``),
one block at a time, and computed on in float32.  Attention is computed over blocks of
queries and the training backward layer by layer from the saved inputs of
each layer, so that the reference fits on one card beside nothing else.

``Arith("fp8")`` is the control: every product of bfloat16 tensors takes
its operands rounded to float8 e4m3 with one scale per tensor (the gradient
that flows back through each rounding is rounded to e5m2), the router stays
in float32: the step down in precision that a later change could be
tempted to take.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_FORWARD = (torch.float8_e4m3fn, 448.0)
FP8_BACKWARD = (torch.float8_e5m2, 57344.0)


def no_tf32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _qdq(x: torch.Tensor, fmt) -> torch.Tensor:
    dtype, top = fmt
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _qdq(x, FP8_FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, FP8_BACKWARD)


class Arith:
    """How the reference multiplies: ``"fp32"`` or the control ``"fp8"``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.precision == "fp32" else _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def is_moe(cfg: dict, i: int) -> bool:
    return cfg.get("n_experts", 0) > 1 and i % cfg.get("moe_every", 1) == cfg.get("moe_offset", 0)


def window_of(cfg: dict, i: int) -> int:
    pattern = cfg.get("layer_pattern", ["attn"])
    return cfg.get("window_size", 0) if pattern[i % len(pattern)] == "attn_local" else 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (B, S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, *, window: int, arith: Arith, block: int = 256) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v (B, S, KV, hd), each
    KV head shared by H / KV query heads, over blocks of ``block``
    queries; ``window`` > 0 masks keys ``window`` or more positions back."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    outs = []
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        j0 = max(0, i0 - window + 1) if window else 0
        s = arith.mm(qh[:, :, i0:i1], kh[:, :, j0:i1].transpose(-1, -2)) / math.sqrt(hd)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(j0, i1, device=q.device)[None, :]
        ok = kp <= qp
        if window:
            ok = ok & (qp - kp < window)
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        outs.append(arith.mm(p, vh[:, :, j0:i1]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def mlp(h, w1, w3, w2, arith: Arith) -> torch.Tensor:
    return arith.mm(F.silu(arith.mm(h, w1)) * arith.mm(h, w3), w2)


def moe(h: torch.Tensor, w: dict, cfg: dict, arith: Arith, drops: list | None = None):
    """(the experts' sum (B, S, d), the load-balance term) under GShard's
    capacity, as the module docstring states it; appends (claims dropped
    over capacity, claims) to ``drops`` where it is given."""
    B, S, d = h.shape
    E, K = cfg["n_experts"], cfg["top_k"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    probs = torch.softmax(x @ w["router"], dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    top1 = F.one_hot(idx[:, 0], E).float()
    aux = E * torch.sum(top1.mean(0) * probs.mean(0))

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
        ye = mlp(x[tok], w["w1"][e], w["w3"][e], w["w2"][e], arith)
        y = y.index_add(0, tok, ye * gate[:, None])
    return y.reshape(B, S, d), aux


def layer_forward(x: torch.Tensor, w: dict, cfg: dict, i: int, arith: Arith,
                  drops: list | None = None):
    """(x after layer ``i``, its (k, v) after RoPE, its load-balance term);
    a mixture of experts appends its capacity drops to ``drops``."""
    B, S, _ = x.shape
    H, KV, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg), cfg["rmsnorm_eps"]
    h = rmsnorm(x, w["norm1"], eps)
    q = rope(arith.mm(h, w["wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rope(arith.mm(h, w["wk"]).reshape(B, S, KV, hd), cfg["rope_theta"])
    v = arith.mm(h, w["wv"]).reshape(B, S, KV, hd)
    o = attention(q, k, v, window=window_of(cfg, i), arith=arith)
    x = x + arith.mm(o.reshape(B, S, H * hd), w["wo"])
    h = rmsnorm(x, w["norm2"], eps)
    if is_moe(cfg, i):
        y, aux = moe(h, w, cfg, arith, drops)
    else:
        y, aux = mlp(h, w["w1"], w["w3"], w["w2"], arith), x.new_zeros(())
    return x + y, (k, v), aux


def head(top: dict, cfg: dict) -> torch.Tensor:
    return top["embed"].T if cfg.get("tie_embeddings", False) else top["lm_head"]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: dict, weights, batches: list, arith: Arith, on_layer=None,
            drops: list | None = None) -> list:
    """Run each prompt batch (B, S) of ``batches`` through the model, layer
    by layer, calling ``on_layer(i, [(k, v) of each batch])`` and appending
    each mixture of experts' (claims dropped, claims) to ``drops``; returns
    each batch's last-position logits (B, V), float32.  ``weights`` draws
    the weights again: ``weights.top()`` and ``weights.layer(i)``."""
    top = {k: t.float() for k, t in weights.top().items()}
    xs = [top["embed"][t] for t in batches]
    with torch.no_grad():
        for i in range(cfg["n_layers"]):
            w = {k: t.float() for k, t in weights.layer(i).items()}
            kvs = []
            for b, x in enumerate(xs):
                xs[b], kv, _ = layer_forward(x, w, cfg, i, arith, drops)
                kvs.append(kv)
            if on_layer is not None:
                on_layer(i, kvs)
            del w, kvs
        return [arith.mm(rmsnorm(x[:, -1], top["final_norm"], cfg["rmsnorm_eps"]),
                         head(top, cfg)) for x in xs]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def warmup_cosine(step: int, opt: dict) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_ratio`` x ``lr`` at ``total_steps``; ``step`` counts from 0."""
    peak, warm = opt["lr"], max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return peak * step / warm
    frac = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    return peak * (opt["min_ratio"] + (1 - opt["min_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def _nll(x, top32, cfg, labels, arith):
    h = rmsnorm(x, top32["final_norm"], cfg["rmsnorm_eps"])
    logits = arith.mm(h, head(top32, cfg))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _grads_into(grads: dict, params: dict, cfg: dict, mb: dict, arith: Arith) -> float:
    """Add the gradients of one microbatch's loss to ``grads`` (float32, by
    canonical name) and return the loss: the forward with no graph, keeping
    each layer's input, then each layer again under autograd, last first."""
    L = cfg["n_layers"]
    tokens, labels = mb["tokens"], mb["labels"]

    def layer_leaves(i):
        return {k[len(f"layers.{i}."):]: p.detach().float().requires_grad_()
                for k, p in params.items() if k.startswith(f"layers.{i}.")}

    xs = [params["embed"].float()[tokens]]
    with torch.no_grad():
        for i in range(L):
            w = {k: t.detach() for k, t in layer_leaves(i).items()}
            xs.append(layer_forward(xs[-1], w, cfg, i, arith)[0])
    top = {k: params[k].detach().float().requires_grad_() for k in ("final_norm", "lm_head", "embed")
           if k in params}
    x = xs.pop().requires_grad_()
    nll = _nll(x, top, cfg, labels, arith)
    aux_weight = 0.01
    nll.backward()
    for k, t in top.items():
        if t.grad is not None:
            grads[k] += t.grad
    g, loss = x.grad, float(nll.detach())
    for i in reversed(range(L)):
        x = xs.pop().requires_grad_()
        w = layer_leaves(i)
        y, _, aux = layer_forward(x, w, cfg, i, arith)
        if aux.requires_grad:
            loss += aux_weight * float(aux.detach())
            torch.autograd.backward([y, aux], [g, torch.tensor(aux_weight, device=g.device)])
        else:
            y.backward(g)
        for k, t in w.items():
            grads[f"layers.{i}.{k}"] += t.grad
        g = x.grad
        del w, y, x
    grads["embed"].index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    return loss


def train(cfg: dict, weights, batches: list, opt: dict, microbatches: int,
          arith: Arith) -> dict:
    """Train from the drawn weights over ``batches`` (one per step) as the
    configuration states; returns {"loss": [each step's loss], "grad":
    {leaf: norm of the first step's clipped gradient}, "delta": {leaf: norm
    of the stored parameter's change over all the steps}}."""
    params = weights.all()
    state_dtype = getattr(torch, opt["state_dtype"])
    m = {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device) for k, p in params.items()}
    v = {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device) for k, p in params.items()}
    out = {"loss": []}
    for step, batch in enumerate(batches):
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"{B} rows do not split into {microbatches} microbatches")
        n = B // microbatches
        loss = sum(_grads_into(grads, params, cfg,
                               {k: t[j * n:(j + 1) * n] for k, t in batch.items()}, arith)
                   for j in range(microbatches)) / microbatches
        with torch.no_grad():
            for g in grads.values():
                g /= microbatches
            gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            lr = warmup_cosine(step, opt)
            bc1 = 1 - opt["b1"] ** (step + 1)
            bc2 = 1 - opt["b2"] ** (step + 1)
            if step == 0:
                out["grad"] = {k: float(g.norm()) * scale for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k] * scale
                m32 = opt["b1"] * m[k].float() + (1 - opt["b1"]) * g
                v32 = opt["b2"] * v[k].float() + (1 - opt["b2"]) * g * g
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + opt["eps"])
                if k not in opt["no_decay"]:
                    delta = delta + opt["weight_decay"] * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
                m[k].copy_(m32)
                v[k].copy_(v32)
            del grads
        out["loss"].append(loss)
    del m, v
    out["delta"] = weights.delta_norms(params)
    return out
