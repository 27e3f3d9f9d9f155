"""The port's ResNet-18, MobileNet, MoE FFN and ``block_forward`` against
the JAX forwards, on the CPU.

One parameter tree is drawn with numpy from a seed, in the reference's
layout, and goes to the JAX model as it is and to the port through each
module's ``params_from_jax``:

* ResNet-18 at 64x64 and MobileNet at 32x32 (both hit the asymmetric SAME
  padding of the stride-2 convs and the 3x3/2 max-pool): float64 within
  1e-10 relative, float32 within 1e-4;
* ``route_topk`` on the same logits gives the same top-k indices;
* ``moe_block`` at a reduced mixtral, arctic (the dense residual) and a
  geglu config.  The reference routes in float32 by design, and XLA's and
  PyTorch's float32 ``exp`` differ in the last bit on about one input in
  ten, so the float64 comparison within 1e-10 holds the routing equal (the
  reference's ``route_topk`` replaced, for the test, by the port's applied
  to the reference's logits); each package routing itself agrees within
  the float32 bound, 1e-6, and gives the same load-balance loss within 1e-6;
* ``block_forward`` for an attention, a Mamba and an MoE sublayer, float32
  within 1e-4 (the tolerance of tests/test_models.py).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import enable_x64  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.configs.base import RunConfig as r_RunConfig  # noqa: E402
from repro.models import mobilenet as r_mobilenet  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.models import transformer as r_T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mobilenet, moe, resnet  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = {np.float64: 1e-10, np.float32: 1e-4}
ROUTING_TOL = 1e-6  # float32 routing: a few ulp of float32


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _numpy_tree(specs, rng, dtype, *, fan_in=lambda s: s[-2]):
    """Normal weights scaled by 1/sqrt(fan-in) (rank >= 2), small normal
    vectors, and the Mamba mixer's constrained leaves (``A_log``, ``D``,
    ``dt_bias``) and RMS-norm scales as the reference initialises them."""
    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        shape = tuple(s.shape)
        if name == "A_log":
            return np.log(np.tile(np.arange(1, shape[1] + 1), (shape[0], 1))).astype(np.float32)
        if name == "D" or "norm" in name:
            return np.ones(shape, dtype if "norm" in name else np.float32)
        if name == "dt_bias":
            return np.log(np.expm1(rng.uniform(1e-3, 0.1, shape))).astype(np.float32)
        if len(shape) >= 2:
            return (rng.standard_normal(shape) / np.sqrt(fan_in(shape))).astype(dtype)
        return (0.1 * rng.standard_normal(shape)).astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, specs)


# ---------------------------------------------------------------------------
# Convolutional models
# ---------------------------------------------------------------------------

CNNS = {"resnet18-64": (r_resnet, resnet, 64), "mobilenet-32": (r_mobilenet, mobilenet, 32)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("model", sorted(CNNS))
def test_cnn_forward_matches_the_jax_model(model, dtype):
    r_mod, mod, hw = CNNS[model]
    rng = np.random.default_rng(0)
    tree = _numpy_tree(r_mod.param_specs(), rng,
                       dtype, fan_in=lambda s: np.prod(s[:-1]) / 2.0)
    x = rng.standard_normal((2, hw, hw, 3)).astype(dtype)
    with enable_x64():
        want = np.asarray(r_mod.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                        jnp.asarray(x)))
    got = mod.forward(mod.params_from_jax(tree), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    assert _rel(got, want) < TOL[dtype]


def test_same_pads_are_xlas():
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 3, 1) == (1, 1)
    assert resnet.same_pads(56, 1, 2) == (0, 0)
    assert resnet.same_pads(7, 3, 2) == (1, 1)


def test_cnn_initialisers_match_their_specs():
    gen = torch.Generator().manual_seed(0)
    for mod in (resnet, mobilenet):
        params, specs = mod.init_params(gen), mod.param_specs()
        flat_p = pytree.tree_leaves(params)
        flat_s = pytree.tree_leaves(specs)
        assert [p.shape for p in flat_p] == [s.shape for s in flat_s]
        assert all(s.device.type == "meta" for s in flat_s)
        assert all(p.abs().sum() == 0 for p in flat_p if p.dim() == 1)  # zero biases


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    "mixtral": ("mixtral-8x7b", {}),
    "arctic-dense-residual": ("arctic-480b", {}),
    "mixtral-geglu": ("mixtral-8x7b", {"ffn_act": "geglu"}),
}


def _moe_case(case, dtype, seed=0):
    name, over = MOE_CASES[case]
    r_cfg = dataclasses.replace(r_configs.scaled_down(r_configs.REGISTRY[name]), **over)
    cfg = dataclasses.replace(configs.scaled_down(configs.REGISTRY[name]), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(r_cfg)
    rng = np.random.default_rng(seed)
    with enable_x64():
        specs = r_moe.moe_param_specs(r_cfg)
    tree = _numpy_tree(specs, rng, dtype)  # the router too, in ``dtype``
    x = rng.standard_normal((1, 64, cfg.d_model)).astype(dtype)
    return r_cfg, cfg, tree, x


def _port_route(logits, top_k):
    """The port's routing applied to the reference's logits, as jnp."""
    gates, idx, probs = moe.route_topk(torch.from_numpy(np.array(logits)), top_k)
    return jnp.asarray(gates.numpy()), jnp.asarray(idx.numpy()), jnp.asarray(probs.numpy())


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_route_topk_matches_the_reference(case):
    _r_cfg, cfg, tree, x = _moe_case(case, np.float32)
    logits = x.reshape(-1, 4, cfg.d_model) @ tree["router"]
    r_gates, r_idx, r_probs = r_moe.route_topk(jnp.asarray(logits), cfg.top_k)
    gates, idx, probs = moe.route_topk(torch.from_numpy(logits), cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    assert _rel(gates.numpy(), r_gates) < ROUTING_TOL
    assert _rel(probs.numpy(), r_probs) < ROUTING_TOL


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_the_jax_block_in_float64(case, monkeypatch):
    r_cfg, cfg, tree, x = _moe_case(case, np.float64)
    monkeypatch.setattr(r_moe, "route_topk", _port_route)
    with enable_x64():
        want, r_aux = r_moe.moe_block(jax.tree_util.tree_map(jnp.asarray, tree),
                                      jnp.asarray(x), r_cfg)
        want = np.asarray(want)
    got, aux = moe.moe_block(moe.params_from_jax(tree), torch.from_numpy(x), cfg)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL[np.float64]
    assert abs(float(aux) - float(r_aux)) < ROUTING_TOL * abs(float(r_aux))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_routing_itself_stays_within_the_float32_bound(case):
    r_cfg, cfg, tree, x = _moe_case(case, np.float64, seed=1)
    with enable_x64():
        want, r_aux = r_moe.moe_block(jax.tree_util.tree_map(jnp.asarray, tree),
                                      jnp.asarray(x), r_cfg)
        want = np.asarray(want)
    got, aux = moe.moe_block(moe.params_from_jax(tree), torch.from_numpy(x), cfg)
    assert _rel(got.numpy(), want) < ROUTING_TOL
    assert abs(float(aux) - float(r_aux)) < ROUTING_TOL * abs(float(r_aux))


# ---------------------------------------------------------------------------
# block_forward
# ---------------------------------------------------------------------------

def _shapes(tree) -> dict:
    """{key path: shape} of a parameter tree (key order aside)."""
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(path): tuple(leaf.shape) for path, leaf in leaves}


BLOCKS = {"attention": "qwen3-0.6b", "mamba": "falcon-mamba-7b", "moe": "mixtral-8x7b"}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_forward_matches_the_reference(kind):
    name = BLOCKS[kind]
    r_cfg = r_configs.scaled_down(r_configs.REGISTRY[name])
    cfg = configs.scaled_down(configs.REGISTRY[name])
    kinds = cfg.sublayer_kinds(0, 1)
    assert (kinds[0][0] == "mamba") == (kind == "mamba")
    assert kinds[0][1] == (kind == "moe")
    rng = np.random.default_rng(0)
    with enable_x64():
        specs = r_T.sublayer_param_specs(r_cfg, kinds)
    tree = _numpy_tree(specs, rng, np.float32)
    x = rng.standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    want = np.asarray(r_T.block_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), r_cfg, kinds,
        rc=r_RunConfig(), attn_impl="reference"))
    params = moe.params_from_jax(tree)
    port_specs = T.sublayer_param_specs(cfg, kinds)  # the port's own layout
    assert _shapes(params) == _shapes(port_specs)
    got = T.block_forward(params, torch.from_numpy(x), cfg, kinds)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) < TOL[np.float32]


def test_check_supported_still_refuses_moe_on_the_serving_path():
    # MoE sublayers are served now (tests/test_torch_moe_serve.py): the
    # trunk's check passes every MoE config and refuses only the
    # encoder-decoder, which models.model dispatches to models.encdec.
    for name in ("mixtral-8x7b", "llama4-maverick-400b-a17b", "arctic-480b",
                 "jamba-1.5-large-398b"):
        T.check_supported(configs.REGISTRY[name])
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        T.check_supported(configs.REGISTRY["seamless-m4t-large-v2"])
