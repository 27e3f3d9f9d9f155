"""The port's window-sized ring cache against the JAX package, on the CPU.

* ``layers.ring_insert`` / ``ring_positions`` bit-equal to the reference's
  over a grid of (W, S, start): prefills shorter than, equal to and longer
  than the window, and decode steps before and past a wrap;
* tests/test_flash_vjp.py::test_ring_cache_decode_matches_full_cache, on
  the port: local-attention decode through a W-entry ring equals decode
  through the full cache (float32, 1e-4), and the ring really is W long;
* the port's model with ``local_ring_cache=True`` and ``init_cache(ring=
  True)`` against the reference's, prefill and decode logits (1e-4) and
  ids, on gemma3 and mixtral at ``scaled_down`` with a prompt longer than
  the window (the ring wraps in the prefill and again in decode).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import layers as r_L  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4  # float32 logits: tests/test_models.py, tests/test_flash_vjp.py

GRID = [  # (W, S, start)
    (8, 3, 0), (8, 7, 0),            # S < W: slots 0..S-1, the rest kept
    (8, 8, 0),                       # S = W: no roll
    (8, 9, 0), (8, 13, 0), (8, 16, 0), (8, 21, 0), (5, 12, 0),  # S > W: rolled
    (8, 1, 0), (8, 1, 5), (8, 1, 7),  # decode before a wrap
    (8, 1, 8), (8, 1, 13), (8, 1, 30), (1, 1, 4), (5, 1, 1003),  # past a wrap
]


@pytest.mark.parametrize("W,S,start", GRID)
def test_ring_insert_is_bit_equal_to_the_reference(W, S, start):
    rng = np.random.default_rng(W * 1000 + S * 10 + start)
    buf = rng.standard_normal((2, W, 3, 4), dtype=np.float32)
    new = rng.standard_normal((2, S, 3, 4), dtype=np.float32)
    want = np.asarray(r_L.ring_insert(jnp.asarray(buf), jnp.asarray(new), start))
    port_buf = torch.from_numpy(buf.copy())
    got = L.ring_insert(port_buf, torch.from_numpy(new), start)
    assert got is port_buf  # written in place
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("W,p_last", [(1, 0), (8, 0), (8, 3), (8, 7), (8, 8),
                                      (8, 13), (8, 31), (16, 1023), (1024, 1279)])
def test_ring_positions_are_bit_equal_to_the_reference(W, p_last):
    want = np.asarray(r_L.ring_positions(W, p_last))
    got = L.ring_positions(W, p_last)
    assert np.array_equal(got.numpy(), want)
    written = got[got >= 0]
    assert written.numel() == min(W, p_last + 1)
    assert bool(((written % W) == torch.nonzero(got >= 0)[:, 0]).all())


def test_a_prefill_longer_than_the_window_keeps_key_p_in_slot_p_mod_w():
    W, S = 8, 21
    new = torch.arange(S, dtype=torch.float32).reshape(1, S, 1, 1)
    buf = L.ring_insert(torch.full((1, W, 1, 1), -1.0), new, 0)
    pos = L.ring_positions(W, S - 1)
    assert torch.equal(buf[0, :, 0, 0], pos.float())


def test_ring_cache_decode_matches_full_cache():
    """Local-attention decode with a W-entry ring == full-context cache."""
    W = 8
    cfg = configs.ModelConfig(name="g", family="dense", n_layers=2, d_model=32,
                              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                              layer_pattern=("attn_local", "attn"), window_size=W,
                              dtype="float32")
    rc_full = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16)
    rc_ring = dataclasses.replace(rc_full, local_ring_cache=True)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(8), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 64, (1, 24)))

    def decode_run(rc, ring):
        cache = M.init_cache(cfg, 1, 32, ring=ring, device="cpu")
        logits, cache = M.prefill(params, cfg, rc, {"tokens": toks[:, :16]}, cache)
        outs = [logits]
        for t in range(16, 24):
            logits, cache = M.decode(params, cfg, rc, toks[:, t:t + 1], cache)
            outs.append(logits)
        return torch.cat(outs, dim=1), cache

    full, _ = decode_run(rc_full, ring=False)
    ringd, cache = decode_run(rc_ring, ring=True)
    torch.testing.assert_close(ringd, full, atol=TOL, rtol=TOL)
    # the ring buffer really is window-sized
    assert cache["segments"][0][0]["sub0"]["k"].shape[1] == W
    assert cache["segments"][0][0]["sub1"]["k"].shape[1] == 32


@pytest.mark.parametrize("arch", ["gemma3", "mixtral"])
def test_ring_serving_matches_the_jax_model(arch):
    cfg = configs.scaled_down(configs.resolve(arch))  # window 16
    rcfg = r_configs.ModelConfig(**dataclasses.asdict(cfg))
    W = cfg.window_size
    B, S, steps, max_seq = 2, W + 8, W, 2 * W + 16  # wraps in prefill and decode
    r_rc = r_configs.RunConfig(attn_chunk_kv=8, local_ring_cache=True)
    rc = configs.RunConfig(attn_chunk_kv=8, local_ring_cache=True)
    r_params = r_model.init_params(jax.random.key(5), rcfg)
    params = M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    r_cache = r_model.init_cache(rcfg, B, max_seq, ring=True)
    cache = M.init_cache(cfg, B, max_seq, ring=True, device="cpu")
    local = [j for j, (m, _) in enumerate(cfg.sublayer_kinds(0, cfg.pattern_period))
             if m == "attn_local"]
    assert local and all(cache["segments"][0][0][f"sub{j}"]["k"].shape[1] == W
                         for j in local)
    r_logits, r_cache = r_model.prefill(r_params, rcfg, r_rc, {"tokens": jnp.asarray(tokens)},
                                        r_cache)
    logits, cache = M.prefill(params, cfg, rc, {"tokens": torch.from_numpy(tokens)}, cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    for _ in range(steps):
        r_tok = jnp.argmax(r_logits[:, -1], -1)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        r_logits, r_cache = r_model.decode(r_params, rcfg, r_rc, r_tok, r_cache)
        logits, cache = M.decode(params, cfg, rc, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=TOL, rtol=TOL)
    for j in local:  # the rings hold the reference's keys, slot for slot
        np.testing.assert_allclose(cache["segments"][0][0][f"sub{j}"]["k"].numpy(),
                                   np.asarray(r_cache["segments"][0][f"sub{j}"]["k"])[0],
                                   atol=TOL, rtol=TOL)
