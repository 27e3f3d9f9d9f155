"""The port's VGG-16 (``repro_torch.models.vgg``) against the JAX model.

One numpy-made parameter tree, in the reference's layout, goes through
``repro.models.vgg.forward`` and, via ``params_from_jax``, through the
port's ``VGG16``, with and without the fused conv group (the Pallas kernel
in interpret mode on the reference side, the plain version on the port's).
The training half -- ``init_params``, ``conv_bn_relu``, ``max_pool_2x2``,
``loss_fn`` and its gradients, and ``examples/vgg_pipeline_torch.py``'s
``train`` -- is held to the reference with the reference's own weights.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch.core.ir import VGG16_CONV_PLAN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.vgg import (VGG16, conv_bn_relu, init_params, loss_fn,  # noqa: E402
                                    max_pool_2x2, params_from_jax)

IN_HW, N_CLASSES, BATCH = 32, 10, 2
# float32 logits, port vs reference: the same arithmetic with sums taken in
# another order (PyTorch's CPU convolution vs XLA's), over 16 layers.
ATOL = RTOL = 1e-4


def _numpy_tree(seed: int = 7) -> dict:
    """A VGG-16 parameter tree shaped like ``repro.models.vgg.init_params``
    (He-normal convs, N(0, 0.01^2) classifier), with small random biases so
    the bias path is exercised."""
    rng = np.random.default_rng(seed)
    convs = [
        {"w": (rng.standard_normal((3, 3, n_in, n_out), dtype=np.float32)
               * np.float32((2.0 / (9 * n_in)) ** 0.5)),
         "b": rng.standard_normal(n_out, dtype=np.float32) * np.float32(0.05)}
        for _name, n_in, n_out, _hw, _pooled in VGG16_CONV_PLAN
    ]
    s = IN_HW // 32
    dims = ((512 * s * s, 4096), (4096, 4096), (4096, N_CLASSES))
    fcs = [{"w": rng.standard_normal(d, dtype=np.float32) * np.float32(0.01),
            "b": rng.standard_normal(d[1], dtype=np.float32) * np.float32(0.01)}
           for d in dims]
    return {"convs": convs, "fcs": fcs}


@pytest.fixture(scope="module")
def setup():
    tree = _numpy_tree()
    x = np.random.default_rng(8).standard_normal(
        (BATCH, IN_HW, IN_HW, 3), dtype=np.float32)
    model = VGG16(in_hw=IN_HW, n_classes=N_CLASSES, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    jtree = {k: [{n: jnp.asarray(a) for n, a in p.items()} for p in v]
             for k, v in tree.items()}
    return tree, jtree, x, model


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_logits_match_reference(setup, fused):
    _tree, jtree, x, model = setup
    want = np.asarray(r_vgg.forward(
        jtree, jnp.asarray(x),
        fused_conv_fn=r_ops.fused_conv_fn() if fused else None))
    with torch.inference_mode():
        got = model(torch.from_numpy(x),
                    fused_conv_fn=ops.fused_conv_fn(device="cpu")
                    if fused else None).numpy()
    assert got.shape == want.shape == (BATCH, N_CLASSES)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_params_from_jax_copies_every_tensor(setup):
    tree, _jtree, _x, model = setup
    state = params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    for i, p in enumerate(tree["convs"]):
        assert np.array_equal(model.conv_w[i].numpy(), p["w"])
        assert np.array_equal(model.conv_b[i].numpy(), p["b"])
    for i, p in enumerate(tree["fcs"]):
        assert np.array_equal(model.fc_w[i].numpy(), p["w"])
    # a copy, not a view of the caller's arrays
    state["conv_w.0"].zero_()
    assert np.abs(tree["convs"][0]["w"]).sum() > 0


def test_init_is_seeded_by_the_generator():
    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return VGG16(in_hw=IN_HW, n_classes=N_CLASSES, device="cpu",
                     generator=gen)

    a, b, c = make(3), make(3), make(4)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.conv_w[0], c.conv_w[0])
    n_in = VGG16_CONV_PLAN[5][1]
    std = float(a.conv_w[5].std())
    assert abs(std - (2.0 / (9 * n_in)) ** 0.5) < 0.1 * std  # He-normal
    assert not any(p.requires_grad for p in a.parameters())
    assert float(a.conv_b[0].abs().sum()) == 0.0


def test_bfloat16_model_runs_in_its_dtype():
    model = VGG16(in_hw=IN_HW, n_classes=N_CLASSES, device="cpu",
                  dtype=torch.bfloat16)
    x = torch.randn((1, IN_HW, IN_HW, 3), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    with torch.inference_mode():
        y = model(x, fused_conv_fn=ops.fused_conv_fn(device="cpu"))
    assert y.dtype == torch.bfloat16 and y.shape == (1, N_CLASSES)
    assert torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# The training half: init_params, conv_bn_relu, max_pool_2x2, loss_fn and
# the example twin's training loop, against the reference
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
TRAIN_HW, TRAIN_CLASSES, TRAIN_BATCH = 32, 10, 8  # examples/vgg_pipeline.py's sizes
# One float32 conv (+ bias, ReLU) of at most 9 x 64 products a sum, the
# sums taken in another order than XLA's: a few ulp of values near 1.
LAYER_TOL = 1e-5
# The loss and the per-leaf relative L2 of the gradients, float32 through
# 16 layers forward and back: measured 0 and at most 2.6e-6 (conv_b[1]);
# 4x above the gradients' worst case.
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# Ten SGD+momentum steps' losses: the first equal, the last 1.4e-6 apart
# (reordered float32 sums carried through the updates); 7x above it.
STEP_LOSS_TOL = 1e-5


def _twin():
    """examples/vgg_pipeline_torch.py as a module (its ``train``)."""
    spec = importlib.util.spec_from_file_location(
        "vgg_pipeline_torch", ROOT / "examples" / "vgg_pipeline_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_batch(rng) -> dict:
    """One batch as examples/vgg_pipeline.py draws it."""
    return {"images": jnp.asarray(rng.standard_normal((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3)),
                                  jnp.float32),
            "labels": jnp.asarray(rng.integers(0, TRAIN_CLASSES, TRAIN_BATCH))}


def _torch_batch(batch) -> dict:
    return {"images": torch.from_numpy(np.array(batch["images"])),
            "labels": torch.from_numpy(np.array(batch["labels"])).long()}


@pytest.fixture(scope="module")
def ref_tree():
    """The reference example's weights: init_params(key(0)) at 32x32, 10
    classes, as numpy."""
    return jax.tree.map(np.asarray, r_vgg.init_params(
        jax.random.key(0), in_hw=TRAIN_HW, n_classes=TRAIN_CLASSES))


@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 16), (1, 7, 9, 16, 8), (2, 14, 14, 64, 64)],
                         ids=["cin3", "odd", "wide"])
def test_conv_bn_relu_matches_reference(shape):
    B, H, W, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((B, H, W, cin), dtype=np.float32)
    p = {"w": rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * np.float32(0.2),
         "b": rng.standard_normal(cout, dtype=np.float32) * np.float32(0.1)}
    want = np.asarray(r_vgg.conv_bn_relu(jnp.asarray(x), {k: jnp.asarray(v)
                                                           for k, v in p.items()}))
    got = conv_bn_relu(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL, rtol=LAYER_TOL)


def test_conv_bn_relu_keeps_the_input_dtype():
    x = torch.randn((1, 6, 6, 4), generator=torch.Generator().manual_seed(0))
    w = torch.randn((3, 3, 4, 8), generator=torch.Generator().manual_seed(1))
    y = conv_bn_relu(x.bfloat16(), {"w": w.bfloat16(), "b": torch.zeros(8).bfloat16()})
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 6, 6, 8)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 5), (3, 5, 5, 2)],
                         ids=["even", "odd_edge", "odd_square"])
def test_max_pool_2x2_matches_reference(shape):
    x = np.random.default_rng(len(shape) + shape[1]).standard_normal(shape, dtype=np.float32)
    want = np.asarray(r_vgg.max_pool_2x2(jnp.asarray(x)))
    got = max_pool_2x2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    assert np.array_equal(got, want)  # a max is exact


def test_params_from_jax_as_tree_copies_the_reference_tree(ref_tree):
    tree = params_from_jax(ref_tree, as_tree=True)
    assert sorted(tree) == ["conv_b", "conv_w", "fc_b", "fc_w"]
    for key, group, leaf in (("conv_w", "convs", "w"), ("conv_b", "convs", "b"),
                             ("fc_w", "fcs", "w"), ("fc_b", "fcs", "b")):
        assert len(tree[key]) == len(ref_tree[group])
        for t, p in zip(tree[key], ref_tree[group]):
            assert np.array_equal(t.numpy(), p[leaf])
    tree["conv_w"][0].zero_()  # a copy, not a view
    assert np.abs(ref_tree["convs"][0]["w"]).sum() > 0


def test_loss_fn_matches_reference(ref_tree):
    batch = _ref_batch(np.random.default_rng(0))
    want = float(r_vgg.loss_fn(jax.tree.map(jnp.asarray, ref_tree), batch))
    got = loss_fn(params_from_jax(ref_tree, as_tree=True), _torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_TOL


@pytest.mark.parametrize("how", ["autograd", "torch_func"])
def test_gradients_match_reference(ref_tree, how):
    batch = _ref_batch(np.random.default_rng(0))
    want = jax.grad(r_vgg.loss_fn)(jax.tree.map(jnp.asarray, ref_tree), batch)
    params = params_from_jax(ref_tree, as_tree=True)
    tb = _torch_batch(batch)
    if how == "autograd":
        for group in params.values():
            for t in group:
                t.requires_grad_(True)
        loss_fn(params, tb).backward()
        grads = {k: [t.grad for t in v] for k, v in params.items()}
    else:
        grads, _loss = torch.func.grad_and_value(loss_fn)(params, tb)
    for key, group, leaf in (("conv_w", "convs", "w"), ("conv_b", "convs", "b"),
                             ("fc_w", "fcs", "w"), ("fc_b", "fcs", "b")):
        for i, (g, p) in enumerate(zip(grads[key], want[group])):
            r = np.asarray(p[leaf])
            rel = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
            assert rel <= GRAD_TOL, (key, i, rel)


def test_training_matches_the_reference_example(ref_tree):
    # examples/vgg_pipeline.py's loop, step 4, on its own weights
    params = jax.tree.map(jnp.asarray, ref_tree)
    rng = np.random.default_rng(0)
    opt_state = jax.tree.map(lambda p: jnp.zeros_like(p), params)
    loss_grad = jax.jit(jax.value_and_grad(r_vgg.loss_fn))
    want = []
    for _step in range(10):
        loss, grads = loss_grad(params, _ref_batch(rng))
        opt_state = jax.tree.map(lambda m, g: 0.9 * m + g, opt_state, grads)
        params = jax.tree.map(lambda p, m: p - 1e-3 * m, params, opt_state)
        want.append(float(loss))
    got = _twin().train(params_from_jax(ref_tree, as_tree=True), steps=10, seed=0,
                        device="cpu")
    assert len(got) == 10
    np.testing.assert_allclose(got, want, atol=STEP_LOSS_TOL, rtol=0)
    assert got[-1] < got[0]  # the reference example's assert holds on the port's losses


def test_init_params_matches_the_reference_tree(ref_tree):
    tree = init_params(torch.Generator().manual_seed(0), in_hw=TRAIN_HW,
                       n_classes=TRAIN_CLASSES)
    for key, group, leaf in (("conv_w", "convs", "w"), ("conv_b", "convs", "b"),
                             ("fc_w", "fcs", "w"), ("fc_b", "fcs", "b")):
        assert [tuple(t.shape) for t in tree[key]] == [p[leaf].shape for p in ref_tree[group]]
        assert all(t.dtype == torch.float32 and not t.requires_grad for t in tree[key])
    assert all(float(b.abs().sum()) == 0.0 for b in tree["conv_b"] + tree["fc_b"])
    # He-normal on the wide layers (>= 1.2M draws: the sample std is within
    # 0.2% of the scale; 2% allows for it), N(0, 0.01^2) on the classifier
    for (_name, n_in, n_out, _hw, _p), w in zip(VGG16_CONV_PLAN, tree["conv_w"]):
        if n_in >= 256:
            assert abs(float(w.std()) / (2.0 / (9 * n_in)) ** 0.5 - 1) < 0.02
    assert abs(float(tree["fc_w"][1].std()) / 0.01 - 1) < 0.02


def test_init_params_is_seeded_by_the_generator_in_the_given_dtype():
    def make(seed, dtype=torch.float32):
        return init_params(torch.Generator().manual_seed(seed), in_hw=TRAIN_HW,
                           n_classes=TRAIN_CLASSES, dtype=dtype)

    a, b, c = make(3), make(3), make(4)
    assert all(torch.equal(x, y) for k in a for x, y in zip(a[k], b[k]))
    assert not torch.equal(a["conv_w"][0], c["conv_w"][0])
    h = make(3, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for k in h for t in h[k])
    assert torch.equal(h["conv_w"][0], a["conv_w"][0].bfloat16())  # drawn in float32
    # the VGG16 module holds the same draws
    m = VGG16(in_hw=TRAIN_HW, n_classes=TRAIN_CLASSES, device="cpu",
              generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(m.conv_w, a["conv_w"]))


def test_init_params_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA contract is not testable")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator(device="cuda"))
