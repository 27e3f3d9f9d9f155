"""The port's tracing frontend against the JAX package's, on the CPU.

Every builder traces the port's model into a graph that must equal the
reference's node for node and edge for edge (the ``LayerSpec`` and
``EdgeSpec`` dataclasses compared field by field):

* ``vgg16_network`` (both pool modes), ``resnet18_graph`` (224 and 64),
  ``mobilenet_graph`` and ``mlp_block_graph`` (all four acts), which also
  equal the port's hand-built ``ir.vgg16_ir`` / ``ir.resnet18_ir``;
* ``transformer_graph`` on all 11 registry configs, ``mamba_graph`` (one
  and two chunks) and ``moe_block_graph`` on every MoE config, at the
  reduced shapes of tests/test_zoo_lowerings.py;
* the per-op locks of tests/test_frontend_ops.py, each written once in JAX
  and once in PyTorch;
* typed failures: batch > 1, VALID geometry, dilation, anisotropic strides
  and the ``fold_pool`` rules behave as in tests/test_frontend.py (the
  hypothesis property is tests/test_torch_frontend_property.py).
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as Fn  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.core import frontend as RF  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core import ir  # noqa: E402
from repro_torch.core.errors import GraphValidationError, UnsupportedOpError  # noqa: E402
from repro_torch.models import resnet, vgg  # noqa: E402
from repro_torch.models.resnet import conv_same  # noqa: E402

NAMES = sorted(r_configs.REGISTRY)
MOE_NAMES = [n for n in NAMES if r_configs.REGISTRY[n].n_experts > 1]
SEQ = 64  # tests/test_zoo_lowerings.py


def _rows(g):
    """(field names, node rows, edge rows) of a port or reference graph."""
    nodes = g.nodes if hasattr(g, "nodes") else g.layers
    edges = getattr(g, "edges", ())
    return ([f.name for f in dataclasses.fields(nodes[0])],
            [dataclasses.astuple(n) for n in nodes],
            [dataclasses.astuple(e) for e in edges])


def assert_same_graph(port, reference):
    names, p_nodes, p_edges = _rows(port)
    r_names, r_nodes, r_edges = _rows(reference)
    assert names == r_names
    assert p_nodes == r_nodes
    assert p_edges == r_edges
    assert port.name == reference.name


def _sds(*shape):
    return jax.ShapeDtypeStruct(tuple(shape), jnp.float32)


def _meta(*shape):
    return torch.empty(shape, device="meta")


# ---------------------------------------------------------------------------
# Canonical builders
# ---------------------------------------------------------------------------

SMALL_PLAN = ((32, 16, 1, 1), (16, 16, 1, 4))  # tests/test_frontend.py
BUILDERS = {
    "vgg16-separate": ("vgg16_network", dict(pool_mode="separate")),
    "vgg16-absorbed": ("vgg16_network", dict(pool_mode="absorbed")),
    "vgg16-separate-fc": ("vgg16_network", dict(pool_mode="separate", include_fc=True)),
    "vgg16-absorbed-fc": ("vgg16_network", dict(pool_mode="absorbed", include_fc=True)),
    "resnet18-224": ("resnet18_graph", dict(input_hw=224)),
    "resnet18-64": ("resnet18_graph", dict(input_hw=64)),
    "mobilenet-112": ("mobilenet_graph", dict()),
    "mobilenet-56-small": ("mobilenet_graph", dict(input_hw=56, plan=SMALL_PLAN)),
    **{f"mlp-{act}": ("mlp_block_graph", dict(act=act))
       for act in ("swiglu", "geglu", "gelu", "relu")},
    "mlp-small": ("mlp_block_graph", dict(d_model=128, d_ff=512, seq_len=64)),
}


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_traced_builder_equals_the_reference(case):
    fn, kw = BUILDERS[case]
    assert_same_graph(getattr(F, fn)(**kw), getattr(RF, fn)(**kw))


@pytest.mark.parametrize("kw", [
    dict(pool_mode="separate"), dict(pool_mode="absorbed"),
    dict(pool_mode="separate", include_fc=True),
    dict(pool_mode="absorbed", include_fc=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_traced_vgg16_equals_the_hand_built_ir(kw):
    assert F.vgg16_network(**kw) == ir.vgg16_ir(**kw)


@pytest.mark.parametrize("hw", [224, 64])
def test_traced_resnet18_equals_the_hand_built_ir(hw):
    g, h = F.resnet18_graph(input_hw=hw), ir.resnet18_ir(input_hw=hw)
    assert g.nodes == h.nodes
    assert g.edges == h.edges


# ---------------------------------------------------------------------------
# The config zoo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_transformer_graph_equals_the_reference(name):
    port = F.transformer_graph(configs.scaled_down(configs.REGISTRY[name]), seq_len=SEQ)
    reference = RF.transformer_graph(r_configs.scaled_down(r_configs.REGISTRY[name]),
                                     seq_len=SEQ)
    assert_same_graph(port, reference)


@pytest.mark.parametrize("chunks", [1, 2])
def test_mamba_graph_equals_the_reference(chunks):
    name = "falcon-mamba-7b"
    cfg = configs.scaled_down(configs.REGISTRY[name])
    port = F.mamba_graph(cfg, seq_len=SEQ, chunks=chunks)
    reference = RF.mamba_graph(r_configs.scaled_down(r_configs.REGISTRY[name]),
                               seq_len=SEQ, chunks=chunks)
    assert_same_graph(port, reference)
    scans = [n for n in port.nodes if n.kind == "scan"]
    assert len(scans) == chunks
    for scan in scans:  # the reference's frame: stacked chunk outputs
        assert (scan.h_in, scan.w_in) == (1, SEQ // chunks)
        assert scan.state_words == cfg.d_inner * cfg.ssm_state


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_block_graph_equals_the_reference(name):
    cfg = configs.scaled_down(configs.REGISTRY[name])
    port = F.moe_block_graph(cfg, seq_len=SEQ)
    reference = RF.moe_block_graph(r_configs.scaled_down(r_configs.REGISTRY[name]),
                                   seq_len=SEQ)
    assert_same_graph(port, reference)
    assert sum(n.kind == "actmul" for n in port.nodes) == 2  # dispatch, combine
    w2 = [i for i, n in enumerate(port.nodes) if n.kind in ("matmul", "fc")]
    assert len(w2) >= 1 + 2 * cfg.n_experts  # router + E branches per stack


def test_marker_scan_computes_the_plain_scan():
    g = torch.Generator().manual_seed(0)
    B, S, di, ds = 1, 8, 4, 3
    dA = torch.rand((B, S, di, ds), generator=g)
    dBx, C = torch.randn((B, S, di, ds), generator=g), torch.randn((B, S, ds), generator=g)
    h0 = torch.randn((B, di, ds), generator=g)
    from repro_torch.kernels import ref

    want_y, want_h = ref.selective_scan_ref(dA, dBx, C, h0)
    for chunk in (8, 4, 3):  # 3 does not divide S: one chunk
        y, h = F.marker_scan(chunk)(dA, dBx, C, h0)
        torch.testing.assert_close(y, want_y, rtol=0, atol=0)
        torch.testing.assert_close(h, want_h, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Per-op locks: each op written in JAX and in PyTorch, traced by both
# ---------------------------------------------------------------------------


def _jconv(x, w, groups=1, padding="SAME", stride=1):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)


def _op_cases():
    """name -> (jax fn, jax args, torch fn, torch args, check(g))."""
    def depthwise(g):
        (n,) = g.nodes
        return (n.kind, n.groups, n.n_in, n.n_out, n.h_in) == ("conv", 16, 16, 16, 8)

    cases = {
        "depthwise-groups": (
            lambda w, x: _jconv(x, w, groups=16), (_sds(3, 3, 1, 16), _sds(1, 8, 8, 16)),
            lambda w, x: conv_same(x, w, 1, groups=16), (_meta(3, 3, 1, 16), _meta(1, 8, 8, 16)),
            depthwise),
        "matmul": (
            lambda w, x: x @ w, (_sds(256, 512), _sds(128, 256)),
            lambda w, x: x @ w, (_meta(256, 512), _meta(128, 256)),
            lambda g: g.nodes[0].kind == "matmul"),
        "fc": (
            lambda w, x: x @ w, (_sds(256, 10), _sds(1, 256)),
            lambda w, x: x @ w, (_meta(256, 10), _meta(1, 256)),
            lambda g: g.nodes[0].kind == "fc"),
        "actmul": (
            lambda _w, xs: xs[0] @ xs[1].T, (_sds(1), (_sds(64, 32), _sds(64, 32))),
            lambda _w, xs: xs[0] @ xs[1].T, (_meta(1), (_meta(64, 32), _meta(64, 32))),
            lambda g: g.nodes[0].in_words == 2 * 32 * 64),
        "actmul-raw-input-ext-words": (
            lambda wq, x: (x @ wq) @ x.T, (_sds(32, 32), _sds(64, 32)),
            lambda wq, x: (x @ wq) @ x.T, (_meta(32, 32), _meta(64, 32)),
            lambda g: g.nodes[1].ext_in_words == 64 * 32),
        "join-of-two-raw-inputs": (
            lambda w, ab: _jconv(ab[0] + ab[1], w),
            (_sds(3, 3, 8, 8), (_sds(1, 8, 8, 8), _sds(1, 8, 8, 8))),
            lambda w, ab: conv_same(ab[0] + ab[1], w, 1),
            (_meta(3, 3, 8, 8), (_meta(1, 8, 8, 8), _meta(1, 8, 8, 8))),
            lambda g: g.nodes[0].ext_in_words == 512),
        "square-global-mean-is-a-pool": (
            lambda w, x: jnp.mean(_jconv(x, w), axis=(1, 2)), (_sds(3, 3, 8, 8), _sds(1, 8, 8, 8)),
            lambda w, x: conv_same(x, w, 1).mean(dim=(1, -2)), (_meta(3, 3, 8, 8), _meta(1, 8, 8, 8)),
            lambda g: (g.nodes[1].kind, g.nodes[1].stride) == ("pool", 8)),
        "residual-depthwise-block": (
            lambda p, x: x + _jconv(jax.nn.relu(_jconv(x, p["wd"], groups=8) + p["bd"]), p["wp"]),
            ({"wd": _sds(3, 3, 1, 8), "bd": _sds(8), "wp": _sds(1, 1, 8, 8)}, _sds(1, 8, 8, 8)),
            lambda p, x: x + conv_same(torch.relu(conv_same(x, p["wd"], 1, groups=8) + p["bd"]),
                                       p["wp"], 1),
            ({"wd": _meta(3, 3, 1, 8), "bd": _meta(8), "wp": _meta(1, 1, 8, 8)}, _meta(1, 8, 8, 8)),
            lambda g: g.nodes[2].ext_in_words == 512),
    }
    cases["linear-addmm"] = (
        lambda p, x: x @ p["w"].T + p["b"], ({"w": _sds(16, 32), "b": _sds(16)}, _sds(8, 32)),
        lambda p, x: Fn.linear(x, p["w"], p["b"]),
        ({"w": _meta(16, 32), "b": _meta(16)}, _meta(8, 32)),
        lambda g: (g.nodes[0].kind, g.nodes[0].n_in, g.nodes[0].n_out) == ("matmul", 32, 16))
    cases["avg-pool-2x2"] = (
        lambda w, x: jax.lax.reduce_window(_jconv(x, w), 0.0, jax.lax.add, (1, 2, 2, 1),
                                           (1, 2, 2, 1), "VALID") / 4.0,
        (_sds(3, 3, 8, 8), _sds(1, 8, 8, 8)),
        lambda w, x: Fn.avg_pool2d(conv_same(x, w, 1).permute(0, 3, 1, 2), 2),
        (_meta(3, 3, 8, 8), _meta(1, 8, 8, 8)),
        lambda g: (g.nodes[1].kind, g.nodes[1].stride) == ("pool", 2))
    cases["global-max-is-a-pool"] = (
        lambda w, x: jnp.max(_jconv(x, w), axis=(1, 2)), (_sds(3, 3, 8, 8), _sds(1, 8, 8, 8)),
        lambda w, x: conv_same(x, w, 1).amax(dim=(1, 2)), (_meta(3, 3, 8, 8), _meta(1, 8, 8, 8)),
        lambda g: g.nodes[1].kind == "pool")
    for k in (1, 5, 7):
        cases[f"conv-{k}x{k}"] = (
            lambda w, x: _jconv(x, w), (_sds(k, k, 8, 4), _sds(1, 16, 16, 8)),
            lambda w, x: conv_same(x, w, 1), (_meta(k, k, 8, 4), _meta(1, 16, 16, 8)),
            lambda g, k=k: (g.nodes[0].kh, g.nodes[0].macs) == (k, 8 * k * k * 4 * 256))
    for s in (2, 3):  # asymmetric SAME padding, looked through
        cases[f"conv-3x3-stride{s}"] = (
            lambda w, x, s=s: _jconv(x, w, stride=s), (_sds(3, 3, 8, 4), _sds(1, 18, 18, 8)),
            lambda w, x, s=s: conv_same(x, w, s), (_meta(3, 3, 8, 4), _meta(1, 18, 18, 8)),
            lambda g: g.nodes[0].h_in == 18)
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_traced_op_equals_the_reference(case):
    jfn, jargs, tfn, targs, check = OP_CASES[case]
    g = F.trace(tfn, *targs)
    assert_same_graph(g, RF.trace(jfn, *jargs))
    assert check(g)


RAISES = {
    "rectangular-reduce": (
        lambda w, x: conv_same(x, w, 1).mean(dim=(1, 2)), (_meta(3, 3, 8, 8), _meta(1, 8, 4, 8)),
        "not representable"),
    "activation-kernel": (
        lambda w, x: Fn.conv2d(w, x), (_meta(1, 4, 8, 8), _meta(4, 4, 3, 3)),
        "activation kernel"),
    "valid-geometry": (
        lambda w, x: Fn.conv2d(x.permute(0, 3, 1, 2), w), (_meta(8, 8, 3, 3), _meta(1, 16, 16, 8)),
        "SAME-padding"),
    "dilated": (
        lambda w, x: Fn.conv2d(x.permute(0, 3, 1, 2), w, padding=2, dilation=2),
        (_meta(8, 8, 3, 3), _meta(1, 16, 16, 8)), "dilated"),
    "anisotropic-strides": (
        lambda w, x: Fn.conv2d(x.permute(0, 3, 1, 2), w, stride=(1, 2), padding=1),
        (_meta(8, 8, 3, 3), _meta(1, 16, 16, 8)), "anisotropic"),
    "batch-gt-one": (
        vgg.forward, (vgg.param_specs(), _meta(2, 224, 224, 3)), "batch size 1"),
    "batched-pool": (
        lambda x: Fn.max_pool2d(x, 2), (_meta(2, 4, 8, 8),), "batch size 1"),
    "untraceable": (
        lambda w, x: x @ w, (_meta(3, 4), _meta(5, 6)), "not traceable"),
    "no-layers": (lambda x: torch.relu(x), (_meta(4, 4),), "no layers"),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_unrepresentable_input_raises_typed(case):
    fn, args, match = RAISES[case]
    with pytest.raises(UnsupportedOpError, match=match):
        F.trace(fn, *args)


def test_fold_pool_absorbs_only_window_equal_stride_pools_of_convs():
    """ResNet traces identically with fold_pool (its 3x3/2 max pool and its
    global average pool cannot be absorbed); VGG's 2x2/2 pools are."""
    g = F.trace(resnet.forward, resnet.param_specs(), _meta(1, 224, 224, 3),
                name="resnet18", fold_pool=True)
    h = RF.trace(r_resnet.forward, r_resnet.param_specs(), _sds(1, 224, 224, 3),
                 name="resnet18", fold_pool=True)
    assert_same_graph(g, h)
    assert [n.kind for n in g.nodes].count("pool") == 2
    v = F.trace(vgg.forward, vgg.param_specs(), _meta(1, 224, 224, 3), fold_pool=True)
    assert [n.kind for n in v.nodes].count("pool") == 0
    assert [n.pool_after for n in v.nodes].count(2) == 5


def test_rename_nodes_and_to_chain_are_checked():
    g = F.mlp_block_graph()
    with pytest.raises(UnsupportedOpError, match="names"):
        F.rename_nodes(g, ["a", "b"])
    with pytest.raises(UnsupportedOpError, match="not a chain"):
        F.to_chain(g)
    assert F.to_chain(F.mlp_block_graph(act="gelu")).layers == \
        F.mlp_block_graph(act="gelu").nodes


def test_zoo_builders_refuse_what_they_cannot_trace():
    qwen = configs.scaled_down(configs.REGISTRY["qwen3-0.6b"])
    with pytest.raises(UnsupportedOpError, match="no mamba"):
        F.mamba_graph(qwen)
    with pytest.raises(UnsupportedOpError, match="no MoE"):
        F.moe_block_graph(qwen)
    mamba = configs.scaled_down(configs.REGISTRY["falcon-mamba-7b"])
    with pytest.raises(UnsupportedOpError, match="chunks"):
        F.mamba_graph(mamba, seq_len=64, chunks=3)
    mixtral = configs.scaled_down(configs.REGISTRY["mixtral-8x7b"])
    with pytest.raises(UnsupportedOpError, match="routing groups"):
        F.moe_block_graph(mixtral, seq_len=24)


# ---------------------------------------------------------------------------
# The search flow over traced graphs at full width (what chip_smoke.py runs
# on the card), port on the CPU against the reference
# ---------------------------------------------------------------------------

FLOWS = {  # builder, config (the zoo blocks sweep under loose constraints)
    "resnet18": ("resnet18_graph", None),
    "mobilenet": ("mobilenet_graph", None),
    "qwen3-block": ("transformer_graph", "qwen3-0.6b"),
    "falcon-mamba-mixer": ("mamba_graph", "falcon-mamba-7b"),
    "mixtral-moe": ("moe_block_graph", "mixtral-8x7b"),
}


@pytest.mark.parametrize("case", sorted(FLOWS))
def test_search_flow_over_a_traced_graph_equals_the_reference(case):
    import numpy as np

    from repro.core.arch import Constraints as r_Constraints
    from repro.core.flow import run_flow as r_run_flow
    from repro_torch.core.arch import Constraints
    from repro_torch.core.flow import run_flow

    fn, name = FLOWS[case]
    loose = name is not None
    if loose:
        port_g = getattr(F, fn)(configs.REGISTRY[name], seq_len=512)
        ref_g = getattr(RF, fn)(r_configs.REGISTRY[name], seq_len=512)
    else:
        port_g, ref_g = getattr(F, fn)(), getattr(RF, fn)()
    assert_same_graph(port_g, ref_g)
    inf = [float("inf")] * 4
    got = run_flow(port_g, groupings="search", device="cpu",
                   **({"constraints": Constraints(*inf)} if loose else {}))
    want = r_run_flow(ref_g, groupings="search",
                      **({"constraints": r_Constraints(*inf)} if loose else {}))
    assert dataclasses.astuple(got.best_hw) == dataclasses.astuple(want.best_hw)
    assert dataclasses.astuple(got.best_metrics) == dataclasses.astuple(want.best_metrics)
    np.testing.assert_array_equal(got.best_cuts, want.best_cuts)
    assert (got.group_sizes, got.n_candidates, got.n_feasible, got.search_engine) == \
        (want.group_sizes, want.n_candidates, want.n_feasible, want.search_engine)
