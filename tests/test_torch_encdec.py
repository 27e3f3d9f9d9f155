"""The port's encoder-decoder (``models/encdec.py``) against the JAX
package's, on the CPU.

One parameter tree from ``repro.models.model.init_params`` (``enc_stack``
and ``dec_stack`` stacked on a leading layer axis) goes, via
``params_from_jax``, into the port (one dict per layer); the same frames
and tokens, made with numpy from a seed, go through both (float32, 1e-4 as
in tests/test_models.py): ``encode``, ``cross_kv``, ``decode_stack``, the
forward with and without a cache, prefill and greedy decode logits and
``cache["len"]`` (decoder tokens only), and ``init_cache``'s shapes.  For
seamless at ``scaled_down`` and the ``aud`` family config of
tests/test_models.py (gelu).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import encdec as r_ed  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4  # float32: tests/test_models.py

# tests/test_models.py::test_prefill_decode_consistency's "aud" family
AUD_FAMILY = configs.ModelConfig(
    name="aud", family="audio", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, dtype="float32", is_encoder_decoder=True,
    n_enc_layers=2, frontend="audio", frontend_len=8, ffn_act="gelu")
CASES = ["seamless", "aud-family"]


def _cfg(case):
    if case == "aud-family":
        return AUD_FAMILY
    return configs.scaled_down(configs.resolve(case))


def _setup(case, seed, B=2, S=12):
    """(cfg, reference cfg, run configs, both parameter trees, frames and
    tokens as numpy)."""
    cfg = _cfg(case)
    rcfg = r_configs.ModelConfig(**dataclasses.asdict(cfg))
    r_rc, rc = r_configs.RunConfig(attn_chunk_kv=16), configs.RunConfig(attn_chunk_kv=16)
    r_params = r_model.init_params(jax.random.key(seed), rcfg)
    params = M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.frontend_len, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    return cfg, rcfg, (r_rc, rc), (r_params, params), frames, tokens


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_params_from_jax_unstacks_every_layer():
    cfg, _rcfg, _rcs, (r_params, params), _f, _t = _setup("seamless", 0)
    assert len(params["enc_stack"]) == cfg.n_enc_layers
    assert len(params["dec_stack"]) == cfg.n_layers
    for name in ("enc_stack", "dec_stack"):
        for i, layer in enumerate(params[name]):
            want = jax.tree.map(lambda a, i=i: np.asarray(a)[i], r_params[name])
            flat = jax.tree_util.tree_leaves_with_path(want)
            for path, leaf in flat:
                node = layer
                for key in path:
                    node = node[key.key]
                assert np.array_equal(node.numpy(), leaf)
    # and a fresh port tree has the same layout
    fresh = M.init_params(cfg, device="cpu")
    assert fresh.keys() == params.keys()
    assert fresh["dec_stack"][0].keys() == params["dec_stack"][0].keys()


@pytest.mark.parametrize("case", CASES)
def test_encode_cross_kv_and_decode_stack_match(case):
    cfg, rcfg, (r_rc, rc), (r_params, params), frames, tokens = _setup(case, 1)
    r_enc = r_ed.encode(r_params, rcfg, r_rc, jnp.asarray(frames))
    enc = ED.encode(params, cfg, rc, torch.from_numpy(frames))
    _close(enc, r_enc)
    r_xkv = r_ed.cross_kv(r_params, rcfg, r_enc)
    xkv = ED.cross_kv(params, cfg, torch.from_numpy(np.array(r_enc)))
    assert len(xkv) == cfg.n_layers
    for i, layer in enumerate(xkv):
        for name in ("k", "v"):
            _close(layer[name], np.asarray(r_xkv[name])[i])
    r_h, _ = r_ed.decode_stack(r_params, rcfg, r_rc, jnp.asarray(tokens), r_xkv)
    h, cache = ED.decode_stack(params, cfg, rc, torch.from_numpy(tokens), xkv)
    assert cache is None
    _close(h, r_h)


@pytest.mark.parametrize("case", CASES)
def test_forward_with_and_without_a_cache_matches(case):
    cfg, rcfg, (r_rc, rc), (r_params, params), frames, tokens = _setup(case, 2)
    r_batch = {"frontend": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    batch = {"frontend": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    r_h, _, _ = r_model.forward(r_params, rcfg, r_rc, r_batch)
    h, cache, aux = M.forward(params, cfg, rc, batch)
    assert cache is None and float(aux) == 0.0
    _close(h, r_h)
    B, S = tokens.shape
    r_h2, r_cache, _ = r_model.forward(r_params, rcfg, r_rc, r_batch,
                                       r_model.init_cache(rcfg, B, 32))
    h2, cache, _ = M.forward(params, cfg, rc, batch, M.init_cache(cfg, B, 32, device="cpu"))
    _close(h2, r_h2)
    assert cache["len"] == int(r_cache["len"]) == S
    for i in range(cfg.n_layers):
        for part in ("self", "xkv"):
            for name in ("k", "v"):
                _close(cache[part][i][name], np.asarray(r_cache[part][name])[i])


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_greedy_decode_match(case):
    cfg, rcfg, (r_rc, rc), (r_params, params), frames, tokens = _setup(case, 3)
    B, S, steps, max_seq = *tokens.shape, 4, 32
    r_batch = {"frontend": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    batch = {"frontend": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    r_logits, r_cache = r_model.prefill(r_params, rcfg, r_rc, r_batch,
                                        r_model.init_cache(rcfg, B, max_seq))
    logits, cache = M.prefill(params, cfg, rc, batch,
                              M.init_cache(cfg, B, max_seq, device="cpu"))
    assert logits.shape == (B, 1, cfg.vocab_size) and logits.dtype == torch.float32
    _close(logits, r_logits)
    for _ in range(steps):
        r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        r_logits, r_cache = r_model.decode(r_params, rcfg, r_rc, r_tok, r_cache)
        logits, cache = M.decode(params, cfg, rc, tok, cache)
        _close(logits, r_logits)
    # the cache counts decoder tokens only (tests/test_models.py)
    assert cache["len"] == int(r_cache["len"]) == S + steps


@pytest.mark.parametrize("case", CASES)
def test_init_cache_has_the_reference_shapes(case):
    cfg = _cfg(case)
    rcfg = r_configs.ModelConfig(**dataclasses.asdict(cfg))
    want = r_model.init_cache(rcfg, 3, 20)
    got = M.init_cache(cfg, 3, 20, device="cpu")
    assert got["len"] == 0 and got.keys() == want.keys()
    for part in ("self", "xkv"):
        assert len(got[part]) == cfg.n_layers
        for name in ("k", "v"):
            shape = tuple(want[part][name].shape[1:])
            assert all(tuple(layer[name].shape) == shape for layer in got[part])
            assert all(layer[name].dtype == torch.float32 and not layer[name].any()
                       for layer in got[part])
    assert got["xkv"][0]["k"].shape[1] == cfg.frontend_len


def test_cross_kv_writes_into_the_cache_or_refuses_its_shape():
    cfg, _rcfg, (_r_rc, rc), (_r, params), frames, _tokens = _setup("seamless", 4)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    enc = ED.encode(params, cfg, rc, torch.from_numpy(frames))
    xkv = ED.cross_kv(params, cfg, enc, cache["xkv"])
    assert all(xkv[i][n] is cache["xkv"][i][n] for i in range(cfg.n_layers) for n in "kv")
    fresh = ED.cross_kv(params, cfg, enc)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            assert torch.equal(xkv[i][name], fresh[i][name])
    with pytest.raises(ValueError, match="cross-attention buffers"):
        ED.cross_kv(params, cfg, enc[:, :2], cache["xkv"])
