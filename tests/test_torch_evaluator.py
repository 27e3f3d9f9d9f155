"""The port's evaluator (``repro_torch.core``) against the JAX reference.

Every evaluator output is held bit for bit in float64: the layer IR, the
scalar Eq. (1)-(4) oracles, the raw (H, C, 5) and composed (H, C, 4) sweep
planes, the flow's best point and the fused-vs-layer-by-layer comparison.
The port runs on the CPU here (``device="cpu"``); the reference runs its
jitted sweep under scoped ``enable_x64``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
from jax.experimental import enable_x64  # noqa: E402

from repro.core import arch as RA  # noqa: E402
from repro.core import errors as RE  # noqa: E402
from repro.core import flow as RF  # noqa: E402
from repro.core import fusion as RFu  # noqa: E402
from repro.core import ir as RI  # noqa: E402
from repro.core import metrics as RM  # noqa: E402
from repro_torch.core import arch as TA  # noqa: E402
from repro_torch.core import errors as TE  # noqa: E402
from repro_torch.core import flow as TF  # noqa: E402
from repro_torch.core import fusion as TFu  # noqa: E402
from repro_torch.core import ir as TI  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402

SEED = 20221129
VGG_MODES = [(m, fc) for m in ("separate", "absorbed") for fc in (False, True)]


def _fields(obj) -> dict:
    """A dataclass's fields as a dict: port and reference dataclasses are
    distinct types, so ``==`` between them is always False."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _hw_pair(i: int):
    """The i-th point of the default space in both packages."""
    return RA.default_config_space()[i], TA.default_config_space()[i]


def _cut_batch(n_edges: int, n_random: int) -> np.ndarray:
    """(pool-less) lbl + whole-network + seeded random cut vectors."""
    rng = np.random.default_rng(SEED)
    rows = [np.ones(n_edges, bool), np.zeros(n_edges, bool)]
    rows += list(rng.random((n_random, n_edges)) < 0.5)
    return np.stack(rows)


@pytest.fixture(scope="module")
def vgg():
    """VGG-16 (separate pools) in both packages, as graphs."""
    return (RI.as_graph(RI.vgg16_ir(pool_mode="separate")),
            TI.as_graph(TI.vgg16_ir(pool_mode="separate")))


# ---------------------------------------------------------------------------
# IR, arch and errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool_mode,include_fc", VGG_MODES)
def test_vgg16_ir_matches_reference(pool_mode, include_fc):
    ref = RI.vgg16_ir(pool_mode=pool_mode, include_fc=include_fc)
    port = TI.vgg16_ir(pool_mode=pool_mode, include_fc=include_fc)
    assert port.name == ref.name
    assert [_fields(l) for l in port.layers] == [_fields(l) for l in ref.layers]
    assert np.array_equal(port.feature_matrix(), ref.feature_matrix())
    assert np.array_equal(port.pool_boundary_cuts(), ref.pool_boundary_cuts())
    rg, pg = RI.as_graph(ref), TI.as_graph(port)
    assert [_fields(e) for e in pg.edges] == [_fields(e) for e in rg.edges]
    assert np.array_equal(pg.pool_boundary_cuts(), rg.pool_boundary_cuts())
    for a, b in zip(pg.edge_arrays(), rg.edge_arrays()):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_unknown_pool_mode_raises_typed_error():
    with pytest.raises(TE.UnsupportedOpError):
        TI.vgg16_ir(pool_mode="fused")


@pytest.mark.parametrize("n_nodes,n_edges", [(None, None), (32, 64)])
def test_pad_graph_matches_reference(vgg, n_nodes, n_edges):
    rg, pg = vgg
    a = RI.pad_graph(rg, n_nodes=n_nodes, n_edges=n_edges)
    b = TI.pad_graph(pg, n_nodes=n_nodes, n_edges=n_edges)
    for name, va in _fields(a).items():
        vb = getattr(b, name)
        assert np.array_equal(va, vb), name
    cuts = _cut_batch(rg.n_edges, 5)
    assert np.array_equal(RI.pad_cuts_batch(cuts, 64, 8),
                          TI.pad_cuts_batch(cuts, 64, 8))
    assert [RI.bucket_size(n, 4) for n in range(70)] == [
        TI.bucket_size(n, 4) for n in range(70)]


@pytest.mark.parametrize("space", ["paper", "default", "grid"])
def test_config_spaces_match_reference(space):
    make = {"paper": "paper_config_space", "default": "default_config_space",
            "grid": "config_space_grid"}[space]
    ref, port = getattr(RA, make)(), getattr(TA, make)()
    assert [_fields(c) for c in port] == [_fields(c) for c in ref]
    assert np.array_equal(np.stack([c.as_row() for c in port]),
                          np.stack([c.as_row() for c in ref]))
    assert np.array_equal(TM.area_consts_of_space(port),
                          RM.area_consts_of_space(ref))
    assert TA.DLAConfig.ROW_FIELDS == RA.DLAConfig.ROW_FIELDS
    assert _fields(TA.PAPER_CONSTRAINTS) == _fields(RA.PAPER_CONSTRAINTS)
    assert _fields(TA.PAPER_OPTIMAL_CONFIG) == _fields(RA.PAPER_OPTIMAL_CONFIG)


def test_mixed_area_calibrations_raise_typed_error():
    space = [TA.DLAConfig("hsiao", 2, 2, 2, 2),
             TA.DLAConfig("hsiao", 2, 2, 2, 2, area_controller_um2=1.0)]
    with pytest.raises(TE.ConfigValidationError):
        TM.area_consts_of_space(space)


def test_gpu_spec_without_cuda_is_the_datasheet():
    import torch

    spec = TA.gpu_spec()
    if torch.cuda.is_available():
        assert spec.source == "device" and spec.sm_count > 0
    else:
        assert spec == TA.H100 and spec.source == "datasheet"
    assert spec.smem_per_block_optin == 232_448 or spec.source == "device"


@pytest.mark.parametrize("name", [
    "GraphValidationError", "ConfigValidationError", "InfeasibleBudgetError",
    "InfeasibleConstraintsError", "PoisonedResultError", "SearchDeclined",
    "UnsupportedOpError",
])
def test_error_taxonomy_keeps_builtin_bases(name):
    ref, port = getattr(RE, name), getattr(TE, name)
    builtins = (ValueError, ArithmeticError, TimeoutError, KeyError)
    assert [issubclass(port, b) for b in builtins] == [
        issubclass(ref, b) for b in builtins]
    assert issubclass(port, TE.EvaluatorError)


# ---------------------------------------------------------------------------
# Scalar oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool_mode", ["separate", "absorbed"])
def test_scalar_oracles_bit_identical(pool_mode):
    rg = RI.vgg16_ir(pool_mode=pool_mode)
    pg = TI.vgg16_ir(pool_mode=pool_mode)
    cuts = np.concatenate([
        _cut_batch(len(rg) - 1, 16), rg.pool_boundary_cuts()[None, :]])
    assert RM.sram_accesses_ref(rg) == TM.sram_accesses_ref(pg)
    for i in (0, 37, 150, 255, 256, 300, 319):
        rh, ph = _hw_pair(i)
        assert RM.pe_energy_count_ref(rg, rh) == TM.pe_energy_count_ref(pg, ph)
        for c in cuts:
            assert (_fields(TM.evaluate_ref(pg, c, ph))
                    == _fields(RM.evaluate_ref(rg, c, rh)))
            assert TM.buffer_words_ref(pg, c) == RM.buffer_words_ref(rg, c)
    assert np.array_equal(TM.bandwidth_batch_graph(pg, cuts),
                          RM.bandwidth_batch_graph(rg, cuts))


# ---------------------------------------------------------------------------
# The batched sweep: raw and composed planes
# ---------------------------------------------------------------------------


def _reference_args(g, cuts, space, bucket: bool) -> tuple:
    """The reference flow's sweep arguments, built with its own helpers."""
    hw_rows = np.stack([c.as_row() for c in space])
    area = RM.area_consts_of_space(space)
    if not bucket:
        esrc, edst, ewords = g.edge_arrays()
        return (g.node_features(), esrc, edst, ewords, g.source_mask,
                g.sink_mask, cuts, hw_rows, area)
    pg = RI.pad_graph(g, n_nodes=RI.bucket_size(g.n_nodes, RF.NODE_BUCKET_FLOOR),
                      n_edges=RI.bucket_size(g.n_edges, RF.EDGE_BUCKET_FLOOR))
    padded = RI.pad_cuts_batch(
        cuts, pg.n_edges_padded, RI.bucket_size(len(cuts), RF.CUT_BUCKET_FLOOR))
    return (pg.feat, pg.esrc, pg.edst, pg.ewords, pg.src_mask, pg.sink_mask,
            padded, hw_rows, area, pg.node_mask, pg.edge_mask)


@pytest.mark.parametrize("bucket", [False, True], ids=["unpadded", "padded"])
def test_raw_and_composed_planes_bit_identical(vgg, bucket):
    rg, pg = vgg
    exhaustive = RFu.enumerate_valid_edge_cuts(rg)
    pick = np.random.default_rng(SEED).choice(len(exhaustive), 256,
                                              replace=False)
    cuts = np.concatenate([
        np.stack([rg.pool_boundary_cuts(), RFu.layer_by_layer_cuts(rg)]),
        exhaustive[np.sort(pick)]])
    r_args = _reference_args(rg, cuts, RA.default_config_space(), bucket)
    p_args = TF.sweep_args(pg, cuts, TA.default_config_space(), bucket=bucket)
    assert len(p_args) == len(r_args)
    for a, b in zip(p_args, r_args):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    with enable_x64():
        raw_ref = np.asarray(RM._jit_batch_graph(*r_args))
    raw = TM.evaluate_raw_graph(*p_args, device="cpu").numpy()
    assert raw.dtype == np.float64 and raw.shape == raw_ref.shape
    assert np.array_equal(raw, raw_ref)
    hw_rows = r_args[7]
    composed = TM.evaluate_batch_graph(*p_args, device="cpu")
    assert np.array_equal(composed, RM.compose_metrics(raw_ref, hw_rows))
    assert np.array_equal(composed, RM.evaluate_batch_graph(*r_args))


def test_padded_sweep_equals_unpadded(vgg):
    _, pg = vgg
    cuts = _cut_batch(pg.n_edges, 13)
    space = TA.paper_config_space()
    C = len(cuts)
    flat = TM.evaluate_raw_graph(*TF.sweep_args(pg, cuts, space, bucket=False),
                                 device="cpu")
    padded = TM.evaluate_raw_graph(*TF.sweep_args(pg, cuts, space),
                                   device="cpu")
    assert padded.shape[1] == TI.bucket_size(C, TF.CUT_BUCKET_FLOOR)
    assert np.array_equal(padded[:, :C].numpy(), flat.numpy())


def test_sweep_slabs_do_not_change_the_plane(vgg, monkeypatch):
    """A slab of a few hardware rows gives the plane of one whole slab."""
    _, pg = vgg
    args = TF.sweep_args(pg, _cut_batch(pg.n_edges, 30),
                         TA.default_config_space())
    whole = TM.evaluate_raw_graph(*args, device="cpu")
    monkeypatch.setattr(TM, "SWEEP_SLAB_BYTES", 1)  # one hw row a slab
    assert np.array_equal(TM.evaluate_raw_graph(*args, device="cpu").numpy(),
                          whole.numpy())


# ---------------------------------------------------------------------------
# The flow
# ---------------------------------------------------------------------------


def _assert_same_flow(port, ref):
    assert _fields(port.best_hw) == _fields(ref.best_hw)
    assert np.array_equal(port.best_cuts, ref.best_cuts)
    assert _fields(port.best_metrics) == _fields(ref.best_metrics)
    assert port.group_sizes == ref.group_sizes
    assert port.n_candidates == ref.n_candidates
    assert port.n_feasible == ref.n_feasible
    assert port.n_pruned == ref.n_pruned
    assert port.search_engine == ref.search_engine


def test_run_flow_pool_on_paper_space_matches_reference(vgg):
    rg, pg = vgg
    ref = RF.run_flow(rg, config_space=RA.paper_config_space(),
                      constraints=RA.PAPER_CONSTRAINTS, groupings="pool")
    port = TF.run_flow(pg, config_space=TA.paper_config_space(),
                       constraints=TA.PAPER_CONSTRAINTS, groupings="pool",
                       device="cpu")
    _assert_same_flow(port, ref)
    assert port.best_hw == TA.PAPER_OPTIMAL_CONFIG


@pytest.mark.parametrize("bucket", [True, False])
def test_run_flow_exhaustive_on_optimal_config_matches_reference(vgg, bucket):
    rg, pg = vgg
    ref = RF.run_flow(rg, config_space=[RA.PAPER_OPTIMAL_CONFIG],
                      constraints=RA.PAPER_CONSTRAINTS,
                      groupings="exhaustive", bucket=bucket)
    port = TF.run_flow(pg, config_space=[TA.PAPER_OPTIMAL_CONFIG],
                       constraints=TA.PAPER_CONSTRAINTS,
                       groupings="exhaustive", bucket=bucket, device="cpu")
    _assert_same_flow(port, ref)
    assert port.n_candidates == 2 ** 17


def test_run_flow_budget_and_pareto_match_reference(vgg):
    rg, pg = vgg
    kw = dict(groupings="exhaustive", sram_budget_words=700_000.0,
              pareto=True, constraints=RA.Constraints(*[float("inf")] * 4))
    space = [0, 100, 255, 256, 319]
    ref = RF.run_flow(rg, config_space=[RA.default_config_space()[i]
                                        for i in space], **kw)
    port = TF.run_flow(pg, config_space=[TA.default_config_space()[i]
                                         for i in space], device="cpu", **kw)
    _assert_same_flow(port, ref)
    assert port.n_pruned > 0
    for name in ("metrics", "hw_indices", "cut_indices", "cuts"):
        assert np.array_equal(getattr(port.pareto, name),
                              getattr(ref.pareto, name)), name
    assert port.pareto.n_feasible == ref.pareto.n_feasible


def test_run_flow_infeasible_budget_raises_like_reference(vgg):
    rg, pg = vgg
    fused = np.zeros((1, rg.n_edges), bool)  # the whole network, one group
    with pytest.raises(RE.InfeasibleBudgetError) as r:
        RF.run_flow(rg, groupings=fused, sram_budget_words=10.0)
    with pytest.raises(TE.InfeasibleBudgetError) as p:
        TF.run_flow(pg, groupings=fused, sram_budget_words=10.0,
                    device="cpu")
    assert (p.value.min_feasible_budget_words
            == r.value.min_feasible_budget_words)


@pytest.mark.parametrize("cfg", [("hsiao", 2, 2, 2, 2), ("vwa", 8, 8, 3, 8)])
def test_infeasible_points_raise_value_error(vgg, cfg):
    _, pg = vgg
    with pytest.raises(ValueError):
        TF.run_flow(pg, config_space=[TA.DLAConfig(*cfg)],
                    constraints=TA.PAPER_CONSTRAINTS, groupings="pool",
                    device="cpu")


def test_compare_fusion_matches_reference(vgg):
    rg, pg = vgg
    ref = RF.compare_fusion(rg, RA.PAPER_OPTIMAL_CONFIG)
    port = TF.compare_fusion(pg, TA.PAPER_OPTIMAL_CONFIG)
    assert _fields(port.lbl) == _fields(ref.lbl)
    assert _fields(port.fused) == _fields(ref.fused)
    assert (port.bw_reduction, port.latency_reduction,
            port.energy_reduction) == (ref.bw_reduction,
                                       ref.latency_reduction,
                                       ref.energy_reduction)
    assert port.describe() == ref.describe()
    assert port.bw_reduction == pytest.approx(0.602, abs=0.005)
    assert not port.lbl.meets(TA.PAPER_CONSTRAINTS)
    assert port.fused.meets(TA.PAPER_CONSTRAINTS)


@pytest.mark.parametrize("budget", [float("inf"), 2_000_000.0, 400_000.0])
def test_optimal_cuts_chain_dp_matches_reference(budget):
    ref = RFu.optimal_cuts(RI.vgg16_ir(), sram_budget_words=budget)
    port = TFu.optimal_cuts(TI.vgg16_ir(), sram_budget_words=budget)
    assert port.engine == ref.engine == "chain_dp" and port.exact
    assert np.array_equal(port.cuts, ref.cuts)
    assert (port.group_cost_words, port.n_groups) == (
        ref.group_cost_words, ref.n_groups)


def _diamond(mod):
    """A small residual DAG (fan-out, join) built the same way in both."""
    L = mod.LayerSpec
    nodes = [L("a", "conv", 8, 8, 16, 16, 3, 3), L("b", "conv", 8, 8, 16, 16, 3, 3),
             L("c", "conv", 8, 8, 16, 16, 3, 3), L("d", "elementwise", 8, 8, 16, 16),
             L("e", "conv", 8, 16, 16, 16, 3, 3, pool_after=2)]
    return mod.graph_ir("diamond", nodes, [(0, 1), (1, 2), (0, 3), (2, 3), (3, 4)])


def test_dag_enumeration_and_buffers_match_reference():
    rg, pg = _diamond(RI), _diamond(TI)
    ref = RFu.enumerate_valid_edge_cuts(rg)
    port = TFu.enumerate_valid_edge_cuts(pg)
    assert np.array_equal(port, ref) and not port.flags.writeable
    bits = _cut_batch(pg.n_edges, 30)
    assert np.array_equal(TFu.is_valid_cuts_batch(pg, bits),
                          RFu.is_valid_cuts_batch(rg, bits))
    assert [TFu.is_valid_cuts(pg, c) for c in bits] == [
        RFu.is_valid_cuts(rg, c) for c in bits]
    assert np.array_equal(TFu.graph_max_intermediate_batch(pg, bits),
                          RFu.graph_max_intermediate_batch(rg, bits))
    assert [TFu.graph_max_intermediate(pg, c) for c in bits] == [
        RFu.graph_max_intermediate(rg, c) for c in bits]
    assert np.array_equal(pg.pool_boundary_cuts(), rg.pool_boundary_cuts())
    for c in bits:
        assert np.array_equal(TFu.cut_group_labels(pg, c),
                              RFu.cut_group_labels(rg, c))


def test_run_flow_on_dag_matches_reference():
    rg, pg = _diamond(RI), _diamond(TI)
    kw = dict(groupings="exhaustive", constraints=RA.Constraints(
        *[float("inf")] * 4))
    ref = RF.run_flow(rg, config_space=RA.paper_config_space(), **kw)
    port = TF.run_flow(pg, config_space=TA.paper_config_space(),
                       device="cpu", **kw)
    _assert_same_flow(port, ref)


def test_optimal_cuts_on_dag_declines():
    with pytest.raises(TE.SearchDeclined, match="frontier-state DP"):
        TFu.optimal_cuts(_diamond(TI))
    with pytest.raises(ValueError):
        TF.run_flow(_diamond(TI), groupings="search", device="cpu")


# ---------------------------------------------------------------------------
# Poison quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,column", [(float("nan"), 1),
                                          (float("inf"), 4), (-1.0, 0)])
def test_injected_poison_is_quarantined_like_reference(vgg, monkeypatch,
                                                       value, column):
    rg, pg = vgg
    cell = (5, 1)  # (h, c) of a feasible, non-winning candidate

    def poison(raw):
        raw = np.array(raw, copy=True)
        raw[cell + (column,)] = value
        return raw

    run_sweep_ref = RF._run_sweep
    monkeypatch.setattr(RF, "_run_sweep", lambda exe, args: (
        lambda out: (poison(out[0]), out[1]))(run_sweep_ref(exe, args)))
    sweep_port = TM._evaluate_batch_graph
    monkeypatch.setattr(TM, "_evaluate_batch_graph", lambda *a: (
        TM.torch.from_numpy(poison(sweep_port(*a).numpy()))))
    kw = dict(groupings="pool", constraints=RA.Constraints(
        *[float("inf")] * 4))
    ref = RF.run_flow(rg, config_space=RA.default_config_space()[:8], **kw)
    port = TF.run_flow(pg, config_space=TA.default_config_space()[:8],
                       device="cpu", **kw)
    _assert_same_flow(port, ref)
    assert ref.quarantine is not None and port.quarantine is not None
    # repr: NaN != NaN, but the provenance records must agree field by field
    assert [repr(_fields(c)) for c in port.quarantine.cells] == [
        repr(_fields(c)) for c in ref.quarantine.cells]
    assert (port.quarantine.cells[0].hw, port.quarantine.cells[0].cut) == cell
    assert port.quarantine.describe() == ref.quarantine.describe()


def test_fully_poisoned_sweep_raises_typed_error(vgg, monkeypatch):
    _, pg = vgg
    monkeypatch.setattr(TM, "_evaluate_batch_graph",
                        lambda *a: TM.torch.full((8, 4, 5), float("nan"),
                                                 dtype=TM.torch.float64))
    with pytest.raises(TE.PoisonedResultError) as e:
        TF.run_flow(pg, config_space=TA.default_config_space()[:8],
                    groupings="pool", device="cpu")
    assert len(e.value.quarantined) == 8 * 2


def test_exactness_guard_names_the_offender():
    with pytest.raises(TE.GraphValidationError, match="feature table"):
        TM.assert_exact_f64(np.array([1.0, 0.5]))
    raw = np.ones((2, 3, 5))
    raw[1, 2, 3] = 2.0 ** 60
    assert np.array_equal(TM.poison_mask(raw), RM.poison_mask(raw))


def test_sweep_cache_stats_keep_reference_keys(vgg):
    _, pg = vgg
    TF.clear_sweep_cache()
    TF.run_flow(pg, config_space=TA.paper_config_space(), groupings="pool",
                device="cpu")
    stats = TF.sweep_cache_stats()
    assert set(stats) == set(RF.sweep_cache_stats())
    assert stats["misses"] == 1 and stats["size"] == 0
    TF.clear_sweep_cache()
    assert TF.sweep_cache_stats()["misses"] == 0
