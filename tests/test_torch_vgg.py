"""The port's VGG-16 (``repro_torch.models.vgg``) against the JAX model.

One numpy-made parameter tree, in the reference's layout, goes through
``repro.models.vgg.forward`` and, via ``params_from_jax``, through the
port's ``VGG16``, with and without the fused conv group (the Pallas kernel
in interpret mode on the reference side, the plain version on the port's).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch.core.ir import VGG16_CONV_PLAN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.vgg import VGG16, params_from_jax  # noqa: E402

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
