"""The port's MoE serving path against the JAX package, on the CPU.

One parameter tree from ``repro.models.model.init_params`` goes, via
``params_from_jax``, into the port; the same inputs, made with numpy from a
seed, go through both models (float32):

* the uncached forward's hidden states (1e-4, the tolerance of
  tests/test_models.py) and its summed load-balance loss (1e-6);
* prefill logits and four greedy decode steps (logits 1e-4, the same ids);
* ``moe_block`` alone over several groups at a capacity low enough to drop
  tokens: the same output, the same dropped tokens.

For mixtral, llama4, arctic and jamba at ``scaled_down``, and the ``moe``
family config of tests/test_models.py.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-4  # float32 hidden states and logits: tests/test_models.py
AUX_TOL = 1e-6  # the summed load-balance loss, float32

# tests/test_models.py::test_prefill_decode_consistency's "moe" family
MOE_FAMILY = configs.ModelConfig(
    name="moe", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, dtype="float32", n_experts=4, top_k=2, moe_every=2,
    moe_offset=1, moe_group_size=16, dense_residual_ff=32)
CASES = ["mixtral", "llama4", "arctic", "jamba", "moe-family"]


def _cfg(case):
    if case == "moe-family":
        return MOE_FAMILY
    return configs.scaled_down(configs.resolve(case))


def _ref_cfg(cfg):
    return r_configs.ModelConfig(**dataclasses.asdict(cfg))


def _rc(cfg):
    rc = r_configs.RunConfig(attn_chunk_kv=16)
    return rc, configs.RunConfig(attn_chunk_kv=16)


def _pair(cfg, seed):
    """The reference's parameters for ``cfg`` and the port's copy of them."""
    r_params = r_model.init_params(jax.random.key(seed), _ref_cfg(cfg))
    return r_params, M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))


def test_the_router_stays_float32_in_a_bfloat16_model():
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve("mixtral")),
                              dtype="bfloat16")
    params = M.init_params(cfg, device="cpu")
    sub = params["segments"][0][0]["sub0"]["moe"]
    assert sub["router"].dtype == torch.float32
    assert sub["w1"].dtype == sub["w2"].dtype == sub["w3"].dtype == torch.bfloat16
    r_params = r_model.init_params(jax.random.key(0), _ref_cfg(cfg))
    ported = M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))
    assert ported["segments"][0][0]["sub0"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("case", CASES)
def test_uncached_forward_and_aux_match_the_jax_model(case):
    cfg = _cfg(case)
    r_rc, rc = _rc(cfg)
    r_params, params = _pair(cfg, 1)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    want, _, r_aux = r_model.forward(r_params, _ref_cfg(cfg), r_rc,
                                     {"tokens": jnp.asarray(tokens)})
    got, cache, aux = M.forward(params, cfg, rc, {"tokens": torch.from_numpy(tokens)})
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the summed load-balance loss of every MoE sublayer (>= 1 each: Switch)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert aux.dtype == torch.float32 and float(aux) >= n_moe * (1 - 1e-3)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL * max(1.0, abs(float(r_aux)))


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_greedy_decode_match_the_jax_model(case):
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    r_rc, rc = _rc(cfg)
    r_params, params = _pair(cfg, 2)
    B, S, steps, max_seq = 2, 16, 4, 32
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    r_logits, r_cache = r_model.prefill(r_params, rcfg, r_rc, {"tokens": jnp.asarray(tokens)},
                                        r_model.init_cache(rcfg, B, max_seq))
    logits, cache = M.prefill(params, cfg, rc, {"tokens": torch.from_numpy(tokens)},
                              M.init_cache(cfg, B, max_seq, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    for _ in range(steps):
        r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        r_logits, r_cache = r_model.decode(r_params, rcfg, r_rc, r_tok, r_cache)
        logits, cache = M.decode(params, cfg, rc, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    assert cache["len"] == int(r_cache["len"]) == S + steps


@pytest.mark.parametrize("case", ["mixtral", "arctic"])
def test_moe_block_over_groups_drops_the_same_tokens(case):
    # 4 groups of 16 tokens, 4 experts, top-2, capacity ceil(2 * 16 / 4 *
    # 0.25) = 2 slots an expert: 8 slots for 32 claims a group
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve(case)),
                              capacity_factor=0.25)
    rcfg = _ref_cfg(cfg)
    tree = jax.tree.map(np.asarray, r_moe.init_moe(jax.random.key(3), rcfg, jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, r_aux = r_moe.moe_block(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg)
    got, aux = moe.moe_block(moe.params_from_jax(tree), torch.from_numpy(x), cfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL * max(1.0, abs(float(r_aux)))
    if "dense_residual" not in tree:  # a token that lost both claims outputs 0
        dropped = ~np.any(want != 0, axis=-1)
        assert dropped.sum() > 0
        assert np.array_equal(~np.any(got.numpy() != 0, axis=-1), dropped)


def test_moe_block_refuses_a_token_count_its_group_does_not_divide():
    cfg = configs.scaled_down(configs.resolve("mixtral"))  # moe_group_size 16
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="not divisible by group size 16"):
        moe.moe_block(params, torch.zeros(3, 7, cfg.d_model), cfg)
