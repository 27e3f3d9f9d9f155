"""The MoE layer's sorted path (``moe._experts_sorted``) against its
capacity path, on the CPU in float32.

The sorted path runs on the card alone (``moe._sorted``); here the choice
is patched so that ``moe_block`` calls it on CPU tensors.  Each case runs
the layer on both paths from the same parameters and input and compares
the outputs, the load-balance loss, which tokens lost claims to the
capacity, the rows the expert products ran on (``moe.rows``), and the
gradients of the input, the router and every expert weight under
``backward()``.  The capacities drop claims in most cases: a router rigged
to send every token to experts 0 and 1 (as tests/test_torch_spans.py's)
keeps each one's first C claims of a group, and a drawn router at a low
capacity factor overflows some experts.  In float32 the two paths sum the
same products in other orders, so they agree to float32 rounding, not bit
for bit (the bfloat16 combine's bits: tests/test_torch_on_card.py): each
number of the sorted path is held to within twice the capacity path's own
distance from the capacity path in float64, plus 1e-6 of its magnitude.
The distance matters where a true value is zero and both paths return
rounding: a top-1 router's gradient through its gates, which are 1.
"""
import dataclasses

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.models import moe
from repro_torch.runtime import spans

TOL = 1e-6  # relative to the largest magnitude, beyond the rounding both paths show

CASES = [  # (arch, capacity_factor, rigged router, ffn_act)
    ("mixtral", 0.25, True, None),  # experts 0 and 1 keep their first 2 claims of 16
    ("mixtral", 1.0, True, None),  # ... their first 8
    ("mixtral", 2.0, True, None),  # no claim dropped
    ("mixtral", 0.5, False, None),  # a drawn router overflows some experts
    ("mixtral", 2.0, False, None),
    ("mixtral", 0.5, False, "gelu"),  # no w3
    ("llama4", 1.0, False, None),  # top-1
    ("arctic", 1.0, False, None),  # the parallel dense residual
    ("jamba", 0.5, False, None),
]


def _run(cfg, params, x, r, sorted_path, monkeypatch, dtype=torch.float32):
    """(y, aux, the grads of x and of every parameter, counters) of one
    forward and backward of ``moe_block`` on the chosen path in ``dtype``."""
    monkeypatch.setattr(moe, "_sorted", lambda *a: sorted_path)
    params = pytree.tree_map(lambda t: t.detach().to(dtype).requires_grad_(), params)
    x, r = x.detach().to(dtype).requires_grad_(), r.to(dtype)
    spans.reset()
    with spans.enabled():
        y, aux = moe.moe_block(params, x, cfg)
    ((y * r).sum() + aux).backward()
    grads = {"x": x.grad, **{k: v.grad for k, v in _flat(params).items()}}
    counted = spans.counters()
    spans.reset()
    return y.detach(), aux.detach(), grads, counted


def _flat(params: dict) -> dict:
    leaves, _ = pytree.tree_flatten_with_path(params)
    return {pytree.keystr(path): leaf for path, leaf in leaves}


def _close(got: torch.Tensor, capacity: torch.Tensor, exact: torch.Tensor) -> bool:
    """``got`` as close to ``exact`` as the capacity path's ``capacity``."""
    exact = exact.float()
    return float((got - exact).abs().max()) <= (2 * float((capacity - exact).abs().max())
                                                + TOL * float(exact.abs().max()))


@pytest.mark.parametrize("arch, cf, rigged, act", CASES,
                         ids=[f"{a}-{cf}-{'rigged' if r else 'drawn'}-{act or 'swiglu'}"
                              for a, cf, r, act in CASES])
def test_sorted_path_matches_the_capacity_path(arch, cf, rigged, act, monkeypatch):
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve(arch)), capacity_factor=cf)
    if act:
        cfg = dataclasses.replace(cfg, ffn_act=act)
    gen = torch.Generator().manual_seed(3)
    params = moe.init_moe(gen, cfg, torch.float32)
    assert ("w3" in params) == (act is None)
    Sg, d = cfg.moe_group_size, cfg.d_model
    if rigged:  # every token's logits are (3, 2, 0, 0): experts 0 and 1, in that order
        params["router"] = torch.zeros(d, cfg.n_experts)
        params["router"][:, 0] = 3.0 / d
        params["router"][:, 1] = 2.0 / d
        x = torch.rand(2, 32, d, generator=gen) + 0.5  # positive rows: the rig holds
    else:
        x = torch.randn(2, 32, d, generator=gen)
    r = torch.randn(2, 32, d, generator=gen)

    y_c, aux_c, g_c, n_c = _run(cfg, params, x, r, False, monkeypatch)
    y_s, aux_s, g_s, n_s = _run(cfg, params, x, r, True, monkeypatch)
    y_64, _, g_64, _ = _run(cfg, params, x, r, False, monkeypatch, torch.float64)

    assert _close(y_s, y_c, y_64)
    assert torch.equal(aux_s, aux_c)  # the same routing, untouched
    # the tokens whose every claim was dropped come out zero on both paths
    zero_c, zero_s = (y.abs().amax(-1) == 0 for y in (y_c, y_s))
    if "dense_residual" not in params:
        assert torch.equal(zero_s, zero_c)
    if rigged:
        C = moe._capacity(cfg, Sg)
        pos = torch.arange(64).reshape(2, 32) % Sg  # a token's place in its group
        assert torch.equal(zero_c, pos >= C)
    assert g_s.keys() == g_c.keys()
    for name in g_c:
        assert _close(g_s[name], g_c[name], g_64[name]), name
    G = 64 // Sg
    assert n_c == {**n_s, "moe.rows": G * cfg.n_experts * moe._capacity(cfg, Sg)}
    assert n_s["moe.rows"] == n_s["moe.kept"] <= n_s["moe.claims"]
    if rigged or cf == 2.0:
        assert (n_s["moe.kept"] < n_s["moe.claims"]) == (cf < 2.0)
    elif cf < 1.0:
        assert n_s["moe.kept"] < n_s["moe.claims"]  # the low capacity drops claims
