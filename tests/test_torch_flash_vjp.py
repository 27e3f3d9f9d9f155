"""The port's flash attention with a custom backward, against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through both packages
(float32):

* ``models.flash.flash_attention_vjp``: the output (1e-5) and the
  gradients of ``sum(sin(out))`` (2e-4, atol = rtol), against the
  reference's custom-VJP flash attention and against JAX's gradients of the
  materialised ``attention_reference``, for the ``attn``, ``attn_local``
  and ``attn_chunked`` mixers (tests/test_flash_vjp.py's cases and
  tolerances); ``bf16_tiles`` against the reference's ``bf16_tiles`` (1e-5
  / 2e-4) and against the exact tiles (1e-2 / 2e-2 relative to the max);
* ``kernels.ref.flash_attention_bwd_ref`` (the backward kernel's plain
  version) against ``jax.vjp`` of the reference's attention oracle, with
  GQA, windowed, chunked and non-causal masks, a ragged Sq > Skv whose
  chunked mask leaves queries that see no key (their gradient is 0, and
  the reference's is compared with their cotangent zeroed), and the
  forward's logsumexp against ``jax.nn.logsumexp``;
* K2's wrapper on a CPU tensor is differentiable (torch autograd through
  the plain version) with the reference's gradients;
* one training step's loss and gradients with ``flash_vjp`` equal the
  plain attention's (tests/test_flash_vjp.py's train-step case).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as RModelConfig  # noqa: E402
from repro.configs.base import RunConfig as RRunConfig  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models.flash import flash_attention_vjp as r_flash  # noqa: E402
from repro_torch.configs import ModelConfig, RunConfig  # noqa: E402
from repro_torch.kernels import flash_attention_bwd, fused_attention, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.flash import flash_attention_vjp  # noqa: E402

OUT_TOL = 1e-5  # tests/test_flash_vjp.py
GRAD_TOL = 2e-4
MIXERS = [("attn", 0, 0), ("attn_local", 16, 0), ("attn_chunked", 0, 32)]


def _qkv(seed, B=2, Sq=64, Skv=64, H=4, KV=2, hd=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))


def _torch_grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(torch.sin(out).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, arrays):
    def loss(*xs):
        return jnp.sum(jnp.sin(fn(*xs)))

    out = np.asarray(fn(*map(jnp.asarray, arrays)))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    return out, [np.asarray(g) for g in grads]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("mixer,window,chunk", MIXERS, ids=[m[0] for m in MIXERS])
def test_flash_vjp_matches_the_jax_flash_and_the_reference(mixer, window, chunk):
    arrays = _qkv(0)
    S = arrays[0].shape[1]
    kw = dict(mixer=mixer, window=window, chunk=chunk, kv_block=16)
    out, grads = _torch_grads(
        lambda q, k, v: flash_attention_vjp(q, k, v, q_pos=range(S), kv_pos=range(S), **kw),
        arrays)
    pos = jnp.arange(S)
    r_out, r_grads = _jax_grads(
        lambda q, k, v: r_flash(q, k, v, q_pos=pos, kv_pos=pos, **kw), arrays)
    a_out, a_grads = _jax_grads(
        lambda q, k, v: r_layers.attention_reference(
            q, k, v, q_pos=pos, kv_pos=pos, mixer=mixer, window=window, chunk=chunk),
        arrays)
    _close(out, r_out, OUT_TOL)
    _close(out, a_out, OUT_TOL)
    for g, rg, ag in zip(grads, r_grads, a_grads):
        _close(g, rg, GRAD_TOL)
        _close(g, ag, GRAD_TOL)


def test_flash_vjp_bf16_tiles_match_the_jax_bf16_tiles_and_stay_close():
    arrays = _qkv(3, B=1, H=2, KV=1)
    S = arrays[0].shape[1]
    pos = jnp.arange(S)

    def port(tiles):
        return _torch_grads(lambda q, k, v: flash_attention_vjp(
            q, k, v, q_pos=range(S), kv_pos=range(S), kv_block=16, bf16_tiles=tiles),
            arrays)

    out, grads = port(True)
    r_out, r_grads = _jax_grads(lambda q, k, v: r_flash(
        q, k, v, q_pos=pos, kv_pos=pos, kv_block=16, bf16_tiles=True), arrays)
    _close(out, r_out, OUT_TOL)
    for g, rg in zip(grads, r_grads):
        _close(g, rg, GRAD_TOL)
    exact, exact_grads = port(False)
    assert np.abs(out - exact).max() / np.abs(exact).max() < 1e-2
    for g, eg in zip(grads, exact_grads):
        assert np.abs(g - eg).max() / (np.abs(eg).max() + 1e-9) < 2e-2


BWD_CASES = [  # (B, Sq, Skv, H, KV, hd, causal, window, chunk)
    (2, 64, 64, 4, 2, 32, True, 0, 0),     # GQA 2, causal
    (1, 48, 48, 4, 1, 16, True, 8, 0),     # GQA 4, sliding window
    (2, 40, 40, 2, 2, 32, True, 0, 16),    # chunked, ragged chunks
    (1, 32, 48, 4, 4, 32, False, 0, 0),    # non-causal, Sq < Skv
    (1, 64, 24, 4, 2, 16, True, 0, 16),    # Sq > Skv: queries 32.. see no key
]


def _masked_rows(Sq, Skv, causal, window, chunk):
    """(Sq,) bool: the queries that see no key."""
    return ~ref._visible(Sq, Skv, causal, window, chunk, "cpu").any(dim=1).numpy()


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_backward_plain_version_matches_jax_vjp_of_the_reference(case):
    B, Sq, Skv, H, KV, hd, causal, window, chunk = case
    q, k, v = _qkv(7, B, Sq, Skv, H, KV, hd)
    dout = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    dead = _masked_rows(Sq, Skv, causal, window, chunk)
    assert dead.any() == (Sq > Skv), dead
    mask = dict(causal=causal, window=window, chunk=chunk)

    out, lse = fused_attention.flash_attention_lse(*map(torch.tensor, (q, k, v)), **mask)
    r_out, vjp = jax.vjp(lambda q, k, v: r_ref.flash_attention_ref(q, k, v, **mask),
                         *map(jnp.asarray, (q, k, v)))
    _close(out.numpy(), np.asarray(r_out), OUT_TOL)
    scores = np.einsum("bqhd,bchd->bhqc", q, np.repeat(k, H // KV, axis=2)) / np.sqrt(hd)
    bias = np.where(ref._visible(Sq, Skv, causal, window, chunk, "cpu").numpy(), 0.0, -1e30)
    want_lse = np.asarray(jax.nn.logsumexp(scores + bias, axis=-1))
    _close(lse.numpy()[:, :, ~dead], want_lse[:, :, ~dead], OUT_TOL)

    dq, dk, dv = flash_attention_bwd.flash_attention_bwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), out, torch.tensor(dout), lse,
        **mask)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert not dq.numpy()[:, dead].any()  # a query that sees no key: gradient 0
    live = dout * (~dead)[None, :, None, None]  # ... and the reference with its cotangent 0
    r_dq, r_dk, r_dv = vjp(jnp.asarray(live))
    _close(dq.numpy()[:, ~dead], np.asarray(r_dq)[:, ~dead], GRAD_TOL)
    _close(dk.numpy(), np.asarray(r_dk), GRAD_TOL)
    _close(dv.numpy(), np.asarray(r_dv), GRAD_TOL)


@pytest.mark.parametrize("mixer,window,chunk", MIXERS, ids=[m[0] for m in MIXERS])
def test_the_attention_wrapper_is_differentiable_on_the_cpu(mixer, window, chunk):
    arrays = _qkv(11, B=1, Sq=48, Skv=48)
    mask = dict(causal=True, window=window, chunk=chunk)
    out, grads = _torch_grads(
        lambda q, k, v: fused_attention.flash_attention(q, k, v, **mask), arrays)
    r_out, r_grads = _jax_grads(
        lambda q, k, v: r_ref.flash_attention_ref(q, k, v, **mask), arrays)
    _close(out, r_out, OUT_TOL)
    for g, rg in zip(grads, r_grads):
        _close(g, rg, GRAD_TOL)


def test_train_step_loss_and_grads_with_flash_match_plain():
    fields = dict(name="d", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=128,
                  layer_pattern=("attn_local", "attn"), window_size=16,
                  dtype="float32")
    cfg, r_cfg = ModelConfig(**fields), RModelConfig(**fields)
    rc0 = RunConfig(xent_chunk=16, attn_chunk_kv=16)
    rc1 = dataclasses.replace(rc0, flash_vjp=True)
    r_params = r_model.init_params(jax.random.key(6), r_cfg)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 128, (2, 32)), "labels": rng.integers(0, 128, (2, 32))}

    def port(rc):
        params = M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))
        leaves = [p.requires_grad_(True) for p in torch.utils._pytree.tree_leaves(params)]
        loss, _ = M.loss_fn(params, cfg, rc, {k: torch.tensor(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.numpy() for g in grads]

    l0, g0 = port(rc0)
    l1, g1 = port(rc1)
    assert l1 == pytest.approx(l0, rel=1e-5)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-3)
    r_loss = r_model.loss_fn(r_params, r_cfg, RRunConfig(xent_chunk=16, attn_chunk_kv=16,
                                                         flash_vjp=True),
                             jax.tree.map(jnp.asarray, batch))[0]
    assert l1 == pytest.approx(float(r_loss), rel=1e-5)
