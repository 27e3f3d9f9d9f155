"""The aten-graph cost walker (``repro_torch.core.hlo_cost``) and the
kernels' fusion-group billing (``roofline.kernel_cost``), on the CPU.

The counterparts of ``tests/test_hlo_cost.py``: exact dot FLOPs on a
loop-free function, loops counted once per trip (``make_fx`` unrolls them),
the Eq. (1) group bytes below the unfused sum, collectives counted per kind
by output bytes under a fake process group of 8 ranks.  Then each kernel's
marker node is billed exactly by ``kernel_cost``, and ``kernel_cost`` equals
the formulas ``chip_smoke.py`` used inline for the kernel rows of
``PERF.md`` (copied here as they were).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import resolve, run_config, scaled_down
from repro_torch.core import hlo_cost as HC
from repro_torch.core import roofline as RL
from repro_torch.core.ir import VGG16_CONV_PLAN
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime.steps import make_train_step


def ones(*shape):
    return torch.ones(shape)


def test_dot_flops_exact_loop_free():
    w = HC.cost_of(lambda a, b, c: torch.tanh(a @ b) @ c,
                   ones(256, 512), ones(512, 1024), ones(1024, 128))
    assert w.dot_flops == 2 * 256 * 512 * 1024 + 2 * 256 * 1024 * 128


def test_a_loop_counts_every_trip():
    def g(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    assert HC.cost_of(g, ones(128, 128), ones(10, 128, 128)).dot_flops == 10 * 2 * 128 ** 3


def test_nested_loops_count_every_trip():
    def g(x, ws):
        for i in range(ws.shape[0]):
            for _ in range(3):
                x = torch.tanh(x @ ws[i])
        return x

    assert HC.cost_of(g, ones(64, 64), ones(5, 64, 64)).dot_flops == 5 * 3 * 2 * 64 ** 3


def test_fusion_group_bytes_below_unfused_sum():
    """A long elementwise chain is billed ~ inputs + outputs, not per op
    (the Eq. (1) fusion-group model applied to the aten graph)."""
    def chain(x):
        for _ in range(12):
            x = torch.tanh(x) * 1.01 + 0.1
        return x

    nbytes = 1024 * 1024 * 4
    w = HC.cost_of(chain, ones(1024, 1024))
    gm = HC.trace(chain, ones(1024, 1024))
    unfused = sum(HC.tensor_bytes(n.meta["val"]) * 2 for n in gm.graph.nodes
                  if HC.kind(n) == "fusible")
    assert w.bytes == 2 * nbytes  # one read, one write
    assert w.bytes <= unfused / 10
    assert w.elem_flops == 36 * 1024 * 1024
    assert w.bytes_lo == 0.0  # no dot, slice, copy, collective or kernel


def test_bytes_grow_with_the_loop_length():
    def g(ws):
        x = torch.ones((64, 64))
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    w5 = HC.cost_of(g, ones(5, 64, 64))
    w10 = HC.cost_of(g, ones(10, 64, 64))
    assert w10.bytes > 1.5 * w5.bytes


def test_views_are_free_and_slices_bill_their_size():
    # a transposed weight reaches mm through a view: billed once, at its
    # size; an index read is billed at 2x its output, its reader not again
    w = HC.cost_of(lambda x, W: x @ W.t(), ones(32, 64), ones(128, 64))
    assert w.bytes == w.bytes_lo == 4 * (32 * 64 + 128 * 64 + 32 * 128)
    idx = torch.tensor([0, 3, 5])
    e = HC.cost_of(lambda t, i: t[i] @ torch.ones((64, 8)), ones(100, 64), idx)
    assert e.bytes == 2 * 3 * 64 * 4 + 3 * 8 * 4


@pytest.fixture
def fake_pg():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_collectives_are_counted_per_kind_by_output_bytes(fake_pg):
    import torch.distributed as dist

    def f(x):
        y = x * 2
        dist.all_reduce(y)
        pieces = [torch.empty_like(y) for _ in range(8)]
        dist.all_gather(pieces, y)
        buf = torch.empty((8 * 16, 128))
        dist.all_gather_into_tensor(buf, y)
        out = torch.empty((2, 128))
        dist.reduce_scatter_tensor(out, y)
        return torch.cat(pieces), buf, out

    w = HC.cost_of(f, ones(16, 128))
    assert w.coll["all-reduce"] == 16 * 128 * 4
    assert w.coll["all-gather"] == 2 * 8 * 16 * 128 * 4
    assert w.coll["reduce-scatter"] == 2 * 128 * 4
    assert w.coll_count == 4


# ---------------------------------------------------------------------------
# The kernels' marker nodes
# ---------------------------------------------------------------------------

T = ops.traced_kernels()
GEN = torch.Generator().manual_seed(0)


def randn(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=GEN).to(dtype)


def marker_nodes(gm):
    return [n for n in gm.graph.nodes if HC.kind(n) == "kernel"]


MARKER_CASES = {
    "fused_conv3x3": (
        lambda x, w, b: T.conv3x3(x, w, b, pool=True),
        lambda: (randn(2, 8, 8, 4), randn(3, 3, 4, 16), randn(16)),
        RL.kernel_cost("fused_conv3x3", x=(2, 8, 8, 4), cout=16, pool=True, itemsize=4)),
    "flash_attention": (
        lambda q, k, v: T.attention(q, k, v, causal=True, window=8),
        lambda: (randn(2, 32, 4, 16, dtype=torch.bfloat16),
                 randn(2, 32, 2, 16, dtype=torch.bfloat16),
                 randn(2, 32, 2, 16, dtype=torch.bfloat16)),
        RL.kernel_cost("flash_attention", q=(2, 32, 4, 16), kv=(2, 32, 2, 16), itemsize=2,
                       causal=True, window=8, chunk=0)),
    "fused_mlp": (
        lambda x, w1, w2, w3: T.mlp(x, w1, w2, w3, act="swiglu"),
        lambda: (randn(2, 8, 32), randn(32, 64), randn(64, 32), randn(32, 64)),
        RL.kernel_cost("fused_mlp", x=(16, 32), ff=64, gated=True, itemsize=4)),
    "selective_scan": (
        lambda a, b, c, h: T.ssm_scan(a, b, c, h),
        lambda: (randn(2, 16, 8, 4), randn(2, 16, 8, 4), randn(2, 16, 4), randn(2, 8, 4)),
        RL.kernel_cost("selective_scan", x=(2, 16, 8, 4), h0=True, final_state=True)),
}


@pytest.mark.parametrize("name", sorted(MARKER_CASES))
def test_a_marker_node_is_billed_exactly_by_kernel_cost(name):
    fn, args, want = MARKER_CASES[name]
    args = args()
    gm = HC.trace(fn, *args)
    nodes = marker_nodes(gm)
    assert [ops.MARKERS[n.target] for n in nodes] == [name]
    cost = HC.module_cost(gm)
    assert cost.bytes == cost.bytes_lo == want.bytes
    flops = cost.elem_flops if name == "selective_scan" else cost.dot_flops
    assert flops == want.flops


def test_the_backward_marker_is_billed_exactly_by_kernel_cost():
    q = randn(2, 64, 4, 32, dtype=torch.bfloat16).requires_grad_()
    k = randn(2, 64, 2, 32, dtype=torch.bfloat16).requires_grad_()
    v = randn(2, 64, 2, 32, dtype=torch.bfloat16).requires_grad_()

    def fn(q, k, v):
        out = T.attention(q, k, v, causal=True, chunk=16)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    gm = HC.trace(fn, q, k, v)
    nodes = {ops.MARKERS[n.target]: n for n in marker_nodes(gm)}
    assert sorted(nodes) == ["flash_attention", "flash_attention_bwd"]
    mask = dict(causal=True, window=0, chunk=16)
    shapes = dict(q=(2, 64, 4, 32), kv=(2, 64, 2, 32), itemsize=2)
    assert HC._kernel(nodes["flash_attention"])[0] == RL.kernel_cost(
        "flash_attention", **shapes, **mask, lse=True)
    assert HC._kernel(nodes["flash_attention_bwd"])[0] == RL.kernel_cost(
        "flash_attention_bwd", **shapes, **mask)


def test_the_markers_compute_the_plain_versions_and_their_gradients():
    q, k, v = (randn(1, 24, 4, 16).requires_grad_() for _ in range(3))
    k2, v2 = (t.detach()[:, :, :2].clone().requires_grad_() for t in (k, v))
    got = T.attention(q, k2, v2, causal=True, window=5)
    want = ref.flash_attention_ref(q, k2, v2, causal=True, window=5)
    assert torch.allclose(got, want, atol=1e-6)
    g_got = torch.autograd.grad(got.square().sum(), (q, k2, v2))
    g_want = torch.autograd.grad(want.square().sum(), (q, k2, v2))
    for a, b in zip(g_got, g_want):
        assert torch.allclose(a, b, atol=1e-5)
    x, w1, w2, w3 = randn(6, 16), randn(16, 32), randn(32, 16), randn(16, 32)
    assert torch.equal(T.mlp(x, w1, w2, w3, act="geglu"),
                       ref.fused_mlp_ref(x, w1, w2, w3, act="geglu"))
    a, b, c = randn(2, 8, 4, 3).sigmoid(), randn(2, 8, 4, 3), randn(2, 8, 3)
    y, h = T.ssm_scan(a, b, c, None)
    y0, h0 = ref.selective_scan_ref(a, b, c, None)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert T.ssm_scan(a, b, c, None, final_state=False)[1] is None
    x, w, bias = randn(1, 6, 6, 3), randn(3, 3, 3, 4), randn(4)
    assert torch.equal(T.conv3x3(x, w, bias, pool=True),
                       ref.fused_conv3x3_ref(x, w, bias, pool=True))


def test_traced_kernels_swaps_only_the_hand_written_kernels():
    train = ops.train_kernels(64)
    traced = ops.traced_kernels(train)
    assert traced.attention is ops.traced_attention
    assert traced.mlp is train.mlp and traced.ssm_scan is train.ssm_scan
    assert ops.traced_kernels(ops.PLAIN) == ops.PLAIN
    assert ops.traced_kernels().mlp is ops.traced_mlp


# ---------------------------------------------------------------------------
# kernel_cost against the formulas chip_smoke.py used inline
# ---------------------------------------------------------------------------


def old_visible_pairs(Sq, Skv, causal, window, chunk) -> int:
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
        if not causal:
            ok &= (kp - qp) < window
    elif chunk:
        ok &= (qp // chunk) == (kp // chunk)
    return int(ok.sum())


PAIR_CASES = [(512, 512, True, 0, 0), (1280, 1280, True, 1024, 0), (512, 1024, False, 0, 0),
              (1024, 1024, True, 256, 0), (1024, 1024, True, 0, 256),
              (512, 512, False, 0, 0), (1000, 1000, True, 0, 0), (256, 256, True, 64, 0),
              (256, 256, True, 0, 128), (256, 256, False, 32, 0), (128, 256, True, 0, 0),
              (384, 384, True, 0, 0), (4096, 4096, True, 0, 0)]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_visible_pairs_equal_the_mask_count(case):
    assert RL.visible_pairs(*case) == old_visible_pairs(*case)


# (B, Sq, Skv, H, KV, hd, itemsize, causal, window, chunk): PERF.md's K2 rows
ATTENTION_ROWS = [
    (8, 512, 512, 16, 8, 128, 2, True, 0, 0), (8, 512, 512, 32, 8, 128, 2, True, 4096, 0),
    (8, 1024, 1024, 16, 16, 64, 2, False, 0, 0), (8, 512, 512, 16, 16, 64, 2, True, 0, 0),
    (8, 512, 1024, 16, 16, 64, 2, False, 0, 0), (8, 1280, 1280, 32, 16, 128, 2, True, 1024, 0),
    (8, 1280, 1280, 32, 16, 128, 2, True, 0, 0), (4, 4096, 4096, 16, 8, 128, 2, True, 0, 0),
    (8, 512, 512, 16, 8, 128, 4, True, 0, 0), (2, 256, 256, 4, 2, 64, 4, True, 64, 0),
]
# PERF.md's K2-backward rows
BWD_ROWS = [
    (4, 4096, 4096, 16, 8, 128, 2, True, 0, 0), (2, 1024, 1024, 16, 8, 128, 2, True, 256, 0),
    (2, 1024, 1024, 16, 8, 128, 2, True, 0, 256), (2, 512, 512, 16, 4, 64, 2, False, 0, 0),
    (2, 1000, 1000, 8, 4, 96, 2, True, 0, 0), (2, 512, 512, 16, 8, 128, 4, True, 0, 0),
]


@pytest.mark.parametrize("row", ATTENTION_ROWS)
@pytest.mark.parametrize("lse", [False, True])
def test_attention_cost_is_chip_smokes_formula(row, lse):
    B, Sq, Skv, H, KV, hd, es, causal, window, chunk = row
    pairs = old_visible_pairs(Sq, Skv, causal, window, chunk)
    n_q, n_kv = B * Sq * H * hd, B * Skv * KV * hd
    want = RL.KernelCost(flops=4 * B * H * hd * pairs,
                         bytes=es * (2 * n_q + n_kv + n_kv) + (4 * B * H * Sq if lse else 0))
    assert RL.kernel_cost("flash_attention", q=(B, Sq, H, hd), kv=(B, Skv, KV, hd),
                          itemsize=es, causal=causal, window=window, chunk=chunk,
                          lse=lse) == want


@pytest.mark.parametrize("row", BWD_ROWS)
def test_attention_backward_cost_is_chip_smokes_formula(row):
    B, Sq, Skv, H, KV, hd, es, causal, window, chunk = row
    pairs = old_visible_pairs(Sq, Skv, causal, window, chunk)
    n_q, n_kv = B * Sq * H * hd, B * Skv * KV * hd
    want = RL.KernelCost(flops=10 * B * H * hd * pairs,
                         bytes=es * (3 * n_q + 2 * n_kv + 2 * n_kv) + 4 * B * H * Sq)
    assert RL.kernel_cost("flash_attention_bwd", q=(B, Sq, H, hd), kv=(B, Skv, KV, hd),
                          itemsize=es, causal=causal, window=window, chunk=chunk) == want


@pytest.mark.parametrize("batch, es", [(1, 4), (1, 2), (8, 4)])
def test_conv_cost_is_chip_smokes_formula(batch, es):
    for _, cin, cout, hw, pool in VGG16_CONV_PLAN:
        out_hw = hw // 2 if pool else hw
        want = RL.KernelCost(
            flops=2 * 9 * cin * cout * hw * hw * batch,
            bytes=es * (batch * hw * hw * cin + 9 * cin * cout + cout
                        + batch * out_hw * out_hw * cout))
        assert RL.kernel_cost("fused_conv3x3", x=(batch, hw, hw, cin), cout=cout,
                              pool=pool, itemsize=es) == want


# (T, d, ff, act, itemsize): PERF.md's K3 rows and the test shapes
MLP_ROWS = [(4096, 1024, 3072, "swiglu", 2), (8, 1024, 3072, "swiglu", 2),
            (8192, 1024, 8192, "relu", 2), (4096, 1024, 8192, "relu", 2),
            (8, 1024, 8192, "relu", 2), (10240, 5376, 21504, "geglu", 2),
            (8, 5376, 21504, "geglu", 2), (4096, 1024, 3072, "swiglu", 4),
            (128, 64, 128, "gelu", 4)]


@pytest.mark.parametrize("row", MLP_ROWS)
def test_mlp_cost_is_chip_smokes_formula(row):
    T_, d, ff, act, es = row
    gated = act in ("swiglu", "geglu")
    want = RL.KernelCost(flops=2 * T_ * d * ff * (2 if gated else 1) + 2 * T_ * ff * d,
                         bytes=es * (2 * T_ * d + (3 if gated else 2) * d * ff))
    assert RL.kernel_cost("fused_mlp", x=(T_, d), ff=ff, gated=gated, itemsize=es) == want


@pytest.mark.parametrize("shape, state", [((8, 512, 8192, 16), True),
                                          ((8, 1, 8192, 16), True),
                                          ((1, 64, 16, 4), False),
                                          ((3, 200, 1000, 16), True)])
def test_scan_cost_is_chip_smokes_formula(shape, state):
    b, s, di, ds = shape
    want = RL.KernelCost(flops=4 * b * s * di * ds,
                         bytes=4 * (2 * b * s * di * ds + b * s * ds + b * s * di
                                    + (2 * b * di * ds if state else 0)))
    assert RL.kernel_cost("selective_scan", x=shape, h0=state, final_state=state) == want


# ---------------------------------------------------------------------------
# The training step: recompute, and the traced kernel set
# ---------------------------------------------------------------------------


def train_cost(remat: str, layers: int = 2):
    cfg = dataclasses.replace(scaled_down(resolve("qwen3")), n_layers=layers)
    rc = run_config(cfg.name, "train_4k", remat=remat, flash_vjp=True, microbatches=2,
                    xent_chunk=64)
    params = M.abstract_params(cfg)
    opt = init_opt_state(params, AdamWConfig())
    batch = {"tokens": torch.zeros((4, 128), dtype=torch.int64, device="meta"),
             "labels": torch.zeros((4, 128), dtype=torch.int64, device="meta")}
    step = make_train_step(cfg, rc, kernels=ops.traced_kernels(ops.train_kernels(64)))
    gm = HC.trace(step, params, opt, batch)
    return cfg, HC.module_cost(gm), gm


def test_full_remat_recomputes_the_forward_in_the_walked_flops():
    cfg, none, gm_none = train_cost("none")
    _, full, gm_full = train_cost("full")
    count = {g: sum(1 for n in marker_nodes(gm) if ops.MARKERS[n.target] == "flash_attention")
             for g, gm in (("none", gm_none), ("full", gm_full))}
    # K2 once a layer a microbatch, and again for the recompute
    assert count == {"none": 2 * cfg.n_layers, "full": 4 * cfg.n_layers}
    assert full.dot_flops > none.dot_flops
    # the recompute is one forward of the trunk: less than a third of the step
    assert full.dot_flops - none.dot_flops < none.dot_flops / 3


def test_live_bytes_hold_the_arguments_and_the_outputs():
    x, w = ones(64, 32), ones(32, 16)
    live = HC.live_bytes(HC.trace(lambda x, w: torch.relu(x @ w) @ w.t(), x, w))
    assert live["argument_size_in_bytes"] == 4 * (64 * 32 + 32 * 16)
    assert live["output_size_in_bytes"] == 4 * 64 * 32
    assert live["peak_live_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16 + 64 * 32)
    assert np.isclose(live["peak_intermediate_bytes"], 4 * (64 * 16 + 64 * 32))
