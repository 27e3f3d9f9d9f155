"""The port's training path against the JAX package, on the CPU.

One parameter tree from ``repro.models.model.init_params`` goes, via
``params_from_jax``, into the port; one batch from the data pipeline (the
same in both packages) goes through both (float32):

* ``models.model.loss_fn`` and its gradients against
  ``jax.value_and_grad(repro.models.model.loss_fn)``, for the dense config
  (with and without ``flash_vjp``; gemma3's sliding window with it), the
  MoE, the SSM and the encoder-decoder configs at ``scaled_down``, each
  under two of the remat policies:
  the loss within 1e-5 relative, every gradient leaf within 1e-4 of the
  largest of its leaf (float32 sums in another order, over the blocked
  cross-entropy and attention);
* one ``runtime.steps.make_train_step`` step at ``microbatches`` 1 and 2
  against the reference's jitted step: parameters, moments, step, loss,
  gradient norm and learning rate (1e-5 relative to each leaf's largest),
  and a batch that does not split into the microbatches raises in both;
* tests/test_integration.py's three "learns" tests on the same
  ``TokenStream`` data.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.data import make_batch as r_make_batch  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.runtime import steps as r_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime.steps import make_init, make_train_step  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's largest |gradient|
STEP_TOL = 1e-5
CASES = [  # (registry arch, run-config overrides, remat)
    ("qwen3", {}, "none"),
    ("qwen3", {}, "dots"),
    ("qwen3", {"flash_vjp": True}, "none"),
    ("qwen3", {"flash_vjp": True}, "full"),
    ("gemma3", {"flash_vjp": True}, "dots"),
    ("mixtral", {}, "none"),
    ("mixtral", {}, "full"),
    ("falcon-mamba", {}, "none"),
    ("falcon-mamba", {}, "dots"),
    ("seamless", {}, "none"),
    ("seamless", {}, "full"),
    ("llama4", {}, "none"),
    ("llama4", {"flash_vjp": True}, "full"),
    ("arctic", {}, "none"),
    ("arctic", {"flash_vjp": True}, "full"),
    ("jamba", {}, "none"),
    ("jamba", {"flash_vjp": True}, "full"),
    ("internvl2", {}, "none"),
    ("internvl2", {"flash_vjp": True}, "full"),
    ("granite", {}, "none"),
    ("granite", {"flash_vjp": True}, "full"),
    ("phi3", {}, "none"),
    ("phi3", {"flash_vjp": True}, "full"),
]


def _cfg(arch):
    return configs.scaled_down(configs.resolve(arch))


def _ref(cfg, rc):
    return (r_configs.ModelConfig(**dataclasses.asdict(cfg)),
            r_configs.RunConfig(**dataclasses.asdict(rc)))


def _batch(cfg, B=2, S=32, step=0):
    if cfg.frontend and not cfg.is_encoder_decoder:
        S += cfg.frontend_len
    return r_make_batch(cfg, B, S, seed=0, step=step)


def _port_params(cfg, r_params):
    return M.params_from_jax(cfg, jax.tree.map(np.asarray, r_params))


def _leaves_close(got: list, want: list, tol: float, what: str) -> None:
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, f"{what} leaf {i}: max |diff| {err} > {tol} x {scale}"


def _stack_like_reference(port_tree):
    """The port's per-layer gradient tree restacked into the reference's
    structure (a leading layer axis per segment / stack), as numpy."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([n.detach().float().numpy() for n in nodes])

    out = {}
    for k, v in port_tree.items():
        if k == "segments":
            out[k] = [stack(seg) for seg in v]
        elif k in ("enc_stack", "dec_stack"):
            out[k] = stack(v)
        else:
            out[k] = pytree.tree_map(lambda t: t.detach().float().numpy(), v)
    return out


def _port_loss_and_grads(cfg, rc, params, batch):
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = M.loss_fn(pytree.tree_unflatten(leaves, spec), cfg, rc, tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return float(loss.detach()), pytree.tree_unflatten(grads, spec)


@pytest.mark.parametrize("arch,over,remat", CASES,
                         ids=[f"{a}-{'flash-' if o else ''}{r}" for a, o, r in CASES])
def test_loss_and_grads_match_the_jax_model(arch, over, remat):
    cfg = _cfg(arch)
    rc = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16, mamba_chunk=8,
                           remat=remat, **over)
    r_cfg, r_rc = _ref(cfg, rc)
    r_params = r_model.init_params(jax.random.key(1), r_cfg)
    batch = _batch(cfg)
    (r_loss, _), r_grads = jax.value_and_grad(
        lambda p: r_model.loss_fn(p, r_cfg, r_rc, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(r_params)
    loss, grads = _port_loss_and_grads(cfg, rc, _port_params(cfg, r_params), batch)
    assert loss == pytest.approx(float(r_loss), rel=LOSS_TOL)
    got = jax.tree.leaves(_stack_like_reference(grads))
    _leaves_close(got, jax.tree.leaves(r_grads), GRAD_TOL, f"{arch} {over} {remat} grads")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_matches_the_jax_step(microbatches):
    cfg = _cfg("qwen3")
    rc = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16, learning_rate=3e-3,
                           warmup_steps=2, microbatches=microbatches, remat="none")
    r_cfg, r_rc = _ref(cfg, rc)
    r_params, r_opt = r_steps.make_init(r_cfg, r_rc)(jax.random.key(0))
    batch = _batch(cfg, B=4)
    params = _port_params(cfg, r_params)
    opt = {"m": pytree.tree_map(torch.zeros_like, params),
           "v": pytree.tree_map(torch.zeros_like, params),
           "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg, rc)
    r_step = jax.jit(r_steps.make_train_step(r_cfg, r_rc))
    for i in range(2):  # the second step has a non-zero learning rate
        batch = _batch(cfg, B=4, step=i)
        params, opt, m = step(params, opt, batch)
        r_params, r_opt, r_m = r_step(r_params, r_opt, jax.tree.map(jnp.asarray, batch))
        for key in ("loss", "grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(r_m[key]), rel=STEP_TOL, abs=1e-12), key
        assert int(opt["step"]) == int(r_opt["step"]) == i + 1
        for name, got, want in (("params", params, r_params), ("m", opt["m"], r_opt["m"]),
                                ("v", opt["v"], r_opt["v"])):
            _leaves_close(jax.tree.leaves(_stack_like_reference(got)),
                          jax.tree.leaves(want), STEP_TOL, f"step {i} {name}")


def test_a_batch_that_does_not_split_into_microbatches_raises():
    """3 rows in 2 microbatches: the reference's reshape refuses them, and
    the port raises rather than train on 2 of the 3 rows."""
    cfg = _cfg("qwen3")
    rc = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16, microbatches=2, remat="none")
    r_cfg, r_rc = _ref(cfg, rc)
    r_params, r_opt = r_steps.make_init(r_cfg, r_rc)(jax.random.key(0))
    batch = _batch(cfg, B=3)
    with pytest.raises(TypeError):
        r_steps.make_train_step(r_cfg, r_rc)(r_params, r_opt,
                                             jax.tree.map(jnp.asarray, batch))
    params, opt = make_init(cfg, rc, device="cpu")(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not a multiple of microbatches=2"):
        make_train_step(cfg, rc)(params, opt, batch)


def _run_training(cfg, steps=40, batch=8, seq=32, lr=3e-3):
    """tests/test_integration.py::run_training, through the port."""
    rc = configs.RunConfig(xent_chunk=16, attn_chunk_kv=16, mamba_chunk=8,
                           learning_rate=lr, warmup_steps=4)
    params, opt = make_init(cfg, rc, device="cpu")(torch.Generator().manual_seed(0))
    step = make_train_step(cfg, rc)
    stream = TokenStream(cfg, batch, seq, seed=0)
    losses = []
    try:
        for _ in range(steps):
            _, b = next(stream)
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
    finally:
        stream.close()
    return losses


LEARNS = {
    "dense": dict(name="d", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32"),
    "moe": dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, n_experts=4, top_k=2,
                moe_every=2, moe_offset=1, moe_group_size=16, dtype="float32"),
    "mamba": dict(name="s", family="ssm", n_layers=2, d_model=64, n_heads=1,
                  n_kv_heads=1, d_ff=0, layer_pattern=("mamba",), vocab_size=256,
                  ssm_state=8, ssm_dt_rank=4, dtype="float32"),
}


@pytest.mark.parametrize("family", list(LEARNS))
def test_lm_learns(family):
    losses = _run_training(configs.ModelConfig(**LEARNS[family]))
    assert losses[-1] < losses[0] - 0.3, losses[::8]
