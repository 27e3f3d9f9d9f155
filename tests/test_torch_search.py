"""The port's grouping search over DAGs (``repro_torch.core.fusion``) against
the JAX package's.

The search is numpy on the host in both packages, and every word count is an
integer-valued float64, so every comparison here is exact: the same cut
vectors, group costs, group counts, ``engine`` and ``exact``.  The graphs
are built the same way in both packages (seeded random DAGs, the in-repo
builders), and ``run_flow(groupings="search")`` runs the port's sweep on the
CPU (``device="cpu"``) against the reference's jitted one.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import arch as RA  # noqa: E402
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

INF = float("inf")
DAG_SEEDS = range(10)
# (builder, SRAM budget, locked group cost) — tests/test_frontier_dp.py's
# DP optima, and ResNet-18's at 224x224.
LOCKS = [
    ("residual_block_ir", INF, 200704.0),
    ("residual_block_ir", 150_000.0, 501760.0),
    ("encoder_decoder_ir", INF, 720896.0),
    ("encoder_decoder_ir", 300_000.0, 11206656.0),
    ("resnet18_ir", INF, 151528.0),
    ("resnet18_ir", 200_000.0, 5670888.0),
]
ENGINES = ["frontier_dp_min_bw", "brute_force_min_bw", "greedy_merge_cuts",
           "beam_merge_cuts"]


def _fields(obj) -> dict:
    """A dataclass's fields as a dict (port and reference types differ)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_result(port, ref):
    assert np.array_equal(port.cuts, ref.cuts)
    assert port.cuts.dtype == ref.cuts.dtype == bool
    assert (port.group_cost_words, port.n_groups, port.engine, port.exact) == (
        ref.group_cost_words, ref.n_groups, ref.engine, ref.exact)


def _random_dag(mod, seed: int, n: int | None = None):
    """tests/test_graph_ir.py's ``random_dag`` in either package: a random
    connected DAG of conv nodes with producer-sized edges, from one seed."""
    rng = np.random.default_rng(seed)
    if n is None:
        n = int(rng.integers(3, 11))
    nodes = []
    for i in range(n):
        c = int(rng.choice([4, 8, 16]))
        co = int(rng.choice([4, 8, 16]))
        nodes.append(mod.LayerSpec(f"n{i}", "conv", c, co, 16, 16, 3, 3, 1))
    edges = []
    for i in range(1, n):
        src = int(rng.integers(0, i))  # keep it connected
        edges.append(mod.EdgeSpec(src, i, nodes[src].out_words))
    for _ in range(int(rng.integers(0, n))):
        a, b = sorted(rng.choice(n, size=2, replace=False))
        if all((e.src, e.dst) != (a, b) for e in edges):
            edges.append(mod.EdgeSpec(int(a), int(b), nodes[a].out_words))
    return mod.GraphIR("dag", tuple(nodes), tuple(edges))


def _wide_dag(mod, n_mid: int):
    """source -> n_mid parallel convs -> join: frontier width n_mid."""
    L = mod.LayerSpec
    nodes = [L("src", "conv", 4, 4, 8, 8, 3, 3, 1)]
    nodes += [L(f"m{i}", "conv", 4, 4, 8, 8, 3, 3, 1) for i in range(n_mid)]
    nodes.append(L("join", "elementwise", 4, 4, 8, 8))
    edges = [mod.EdgeSpec(0, i + 1, nodes[0].out_words) for i in range(n_mid)]
    edges += [mod.EdgeSpec(i + 1, n_mid + 1, nodes[i + 1].out_words)
              for i in range(n_mid)]
    return mod.GraphIR("wide", tuple(nodes), tuple(edges))


def _wide_fanin_dag(mod, n_src: int):
    """n_src parallel sources feeding one join: wide, yet enumerable."""
    L = mod.LayerSpec
    nodes = [L(f"s{i}", "conv", 4, 4, 8, 8, 3, 3, 1) for i in range(n_src)]
    nodes.append(L("join", "elementwise", 4, 4, 8, 8))
    edges = [mod.EdgeSpec(i, n_src, nodes[i].out_words) for i in range(n_src)]
    return mod.GraphIR("fanin", tuple(nodes), tuple(edges))


def _median_budget(g) -> float:
    """The budget tests/test_frontier_dp.py searches random DAGs under."""
    return float(np.median(g.node_features()[:, TM.F_OUT_PRE]))


def _pair(name: str, **kw):
    return getattr(RI, name)(**kw), getattr(TI, name)(**kw)


# ---------------------------------------------------------------------------
# The graph builders and the frontier utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_hw", [224, 64])
def test_resnet18_ir_equals_the_reference(input_hw):
    ref, port = _pair("resnet18_ir", input_hw=input_hw)
    assert port.name == ref.name
    assert [_fields(n) for n in port.nodes] == [_fields(n) for n in ref.nodes]
    assert [_fields(e) for e in port.edges] == [_fields(e) for e in ref.edges]
    assert np.array_equal(port.node_features(), ref.node_features())
    assert (len(port.nodes), port.n_edges) == ((31, 38) if input_hw == 224
                                               else (len(ref.nodes), ref.n_edges))
    assert TI.resnet18_ir(input_hw=input_hw) is port  # memoised like the reference


@pytest.mark.parametrize("name,n_edges,n_valid", [
    ("residual_block_ir", 4, 8), ("encoder_decoder_ir", 21, 262_144)])
def test_dag_builders_equal_the_reference(name, n_edges, n_valid):
    ref, port = _pair(name)
    assert port.name == ref.name
    assert [_fields(n) for n in port.nodes] == [_fields(n) for n in ref.nodes]
    assert [_fields(e) for e in port.edges] == [_fields(e) for e in ref.edges]
    assert port.n_edges == n_edges
    cuts = TFu.enumerate_valid_edge_cuts(port)
    assert cuts.shape == (n_valid, n_edges)
    assert np.array_equal(cuts, RFu.enumerate_valid_edge_cuts(ref))


@pytest.mark.parametrize("seed", DAG_SEEDS)
def test_frontier_utilities_match_reference(seed):
    rg, pg = _random_dag(RI, 90 + seed), _random_dag(TI, 90 + seed)
    order = TI.min_width_topo_order(pg)
    assert order == RI.min_width_topo_order(rg)
    pos = {v: t for t, v in enumerate(order)}
    assert all(pos[e.src] < pos[e.dst] for e in pg.edges)
    for o in (None, order):
        assert TI.topo_frontier_sets(pg, o) == RI.topo_frontier_sets(rg, o)
        assert TI.topo_frontier_width(pg, o) == RI.topo_frontier_width(rg, o)
    sets = TI.topo_frontier_sets(pg)
    assert sets[-1] == []
    for t, frontier in enumerate(sets):
        assert frontier == sorted({e.src for e in pg.edges if e.src <= t < e.dst})


@pytest.mark.parametrize("name,width", [
    ("residual_block_ir", 2), ("encoder_decoder_ir", 3), ("resnet18_ir", 2)])
def test_frontier_width_of_the_builders(name, width):
    ref, port = _pair(name)
    assert TI.topo_frontier_width(port) == RI.topo_frontier_width(ref) == width
    alt = TI.min_width_topo_order(port)
    assert alt == RI.min_width_topo_order(ref)
    assert TI.topo_frontier_width(port, alt) <= width


@pytest.mark.parametrize("order", [[3, 2, 1, 0], [0, 0, 1, 2], [0, 2, 1, 3]])
def test_frontier_sets_reject_what_the_reference_rejects(order):
    rb_ref, rb = _pair("residual_block_ir")
    with pytest.raises(ValueError) as port_err:
        TI.topo_frontier_sets(rb, order)
    with pytest.raises(ValueError) as ref_err:
        RI.topo_frontier_sets(rb_ref, order)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("seed", range(4))
def test_label_batches_match_reference_and_scalar(seed):
    rg, pg = _random_dag(RI, seed, 9), _random_dag(TI, seed, 9)
    rng = np.random.default_rng(seed)
    cuts = rng.random((64, pg.n_edges)) < 0.5
    port = TI.uncut_component_labels_batch(len(pg.nodes), pg.edges, cuts)
    ref = RI.uncut_component_labels_batch(len(rg.nodes), rg.edges, cuts)
    assert np.array_equal(port, ref) and port.dtype == ref.dtype
    scalar = np.stack([TI.uncut_component_labels(len(pg.nodes), pg.edges, c)
                       for c in cuts])
    assert np.array_equal(port, scalar)
    raw = rng.integers(0, len(pg.nodes), (32, len(pg.nodes)))
    assert np.array_equal(TI.canonicalize_labels_batch(raw),
                          RI.canonicalize_labels_batch(raw))


# ---------------------------------------------------------------------------
# Prefix tables, chain masks and the buffer predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet18_ir", "encoder_decoder_ir"])
def test_prefix_tables_match_reference(name):
    ref, port = _pair(name)
    pt, rt = TM.graph_prefix_tables(port), RM.graph_prefix_tables(ref)
    assert TM.graph_prefix_tables(port) is pt  # per-instance memo
    for f in dataclasses.fields(pt):
        a, b = getattr(pt, f.name), getattr(rt, f.name)
        if isinstance(a, tuple):
            assert len(a) == len(b) and all(
                np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b)), f.name
        else:
            assert np.array_equal(a, b), f.name
    ga, ra = TM.graph_arrays(port), RM.graph_arrays(ref)
    assert all(np.array_equal(x, y) for x, y in zip(ga.out_edges, ra.out_edges))


def test_chain_group_masks_match_reference():
    rng = np.random.default_rng(3)
    for cuts in rng.random((16, 12)) < 0.4:
        assert all(np.array_equal(a, b) for a, b in zip(
            TM.group_masks(cuts), RM.group_masks(cuts)))
        groups = TM.groups_from_cuts(cuts)
        assert groups == RM.groups_from_cuts(cuts)
        assert np.array_equal(TFu.cuts_from_groups(groups, 13), cuts)


@pytest.mark.parametrize("budget", [INF, 2_000_000.0, 400_000.0])
def test_chain_buffer_predicates_match_reference(budget):
    ref, port = RI.vgg16_ir(), TI.vgg16_ir()
    feat = port.feature_matrix()
    cuts = np.random.default_rng(5).random((64, len(port.layers) - 1)) < 0.5
    assert np.array_equal(TFu.feasible_mask_batch(feat, cuts, budget),
                          RFu.feasible_mask_batch(ref.feature_matrix(), cuts, budget))
    for c in cuts:
        assert TFu.group_max_intermediate(feat, c) == RFu.group_max_intermediate(
            ref.feature_matrix(), c)
        assert TFu.buffer_feasible(feat, c, budget) == RFu.buffer_feasible(
            ref.feature_matrix(), c, budget)
    assert np.array_equal(TFu.feasible_mask_batch(feat, cuts, budget),
                          [TFu.buffer_feasible(feat, c, budget) for c in cuts])


@pytest.mark.parametrize("name", ["resnet18_ir", "encoder_decoder_ir"])
def test_padded_predicates_equal_the_unpadded_ones(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(6)
    cuts = rng.random((48, port.n_edges)) < 0.5
    n_nodes, n_edges = TI.bucket_size(len(port.nodes)), TI.bucket_size(port.n_edges)
    pg = TI.pad_graph(port, n_nodes=n_nodes, n_edges=n_edges)
    padded = TI.pad_cuts_batch(cuts, pg.n_edges_padded, cuts.shape[0])
    padded[:, port.n_edges:] = True  # a padded column is inert either way
    want = TFu.graph_max_intermediate_batch(port, cuts)
    got = TFu.padded_max_intermediate_batch(pg, padded)
    assert np.array_equal(got, want)
    rpg = RI.pad_graph(ref, n_nodes=n_nodes, n_edges=n_edges)
    assert np.array_equal(got, RFu.padded_max_intermediate_batch(rpg, padded))
    budget = float(np.median(want))
    assert np.array_equal(TFu.padded_feasible_mask_batch(pg, padded, budget),
                          TFu.graph_feasible_mask_batch(port, cuts, budget))


@pytest.mark.parametrize("seed", range(4))
def test_cuts_from_labels_matches_reference(seed):
    rg, pg = _random_dag(RI, seed, 8), _random_dag(TI, seed, 8)
    labels = np.random.default_rng(seed).integers(0, 3, (16, 8))
    for lab in labels:
        assert np.array_equal(TFu.cuts_from_labels(pg, lab),
                              RFu.cuts_from_labels(rg, lab))


# ---------------------------------------------------------------------------
# The four engines on seeded random DAGs
# ---------------------------------------------------------------------------


def _engine_kwargs(engine: str) -> dict:
    # tests/test_frontier_dp.py lifts the DP's caps on random DAGs
    if engine == "frontier_dp_min_bw":
        return dict(max_width=None, max_states=1 << 22)
    return {}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", DAG_SEEDS)
def test_engines_match_reference_on_random_dags(engine, seed):
    rg, pg = _random_dag(RI, 4200 + seed), _random_dag(TI, 4200 + seed)
    kw = _engine_kwargs(engine)
    for budget in (INF, _median_budget(pg)):
        port = getattr(TFu, engine)(pg, sram_budget_words=budget, **kw)
        ref = getattr(RFu, engine)(rg, sram_budget_words=budget, **kw)
        _assert_same_result(port, ref)
        assert TFu.graph_max_intermediate(pg, port.cuts) <= budget
        assert TFu._graph_cost(pg, port.cuts) == port.group_cost_words


@pytest.mark.parametrize("seed", DAG_SEEDS)
def test_frontier_dp_cost_equals_brute_force(seed):
    pg = _random_dag(TI, 4200 + seed)
    for budget in (INF, _median_budget(pg)):
        dp = TFu.frontier_dp_min_bw(pg, sram_budget_words=budget,
                                    max_width=None, max_states=1 << 22)
        bf = TFu.brute_force_min_bw(pg, sram_budget_words=budget)
        assert dp.group_cost_words == bf.group_cost_words
        assert TFu.is_valid_cuts(pg, dp.cuts)


@pytest.mark.parametrize("seed", DAG_SEEDS)
def test_frontier_dp_in_another_topological_order_matches_reference(seed):
    rg, pg = _random_dag(RI, 90 + seed), _random_dag(TI, 90 + seed)
    order = TI.min_width_topo_order(pg)
    port = TFu.frontier_dp_min_bw(pg, max_width=None, order=order)
    _assert_same_result(port, RFu.frontier_dp_min_bw(rg, max_width=None,
                                                     order=order))
    assert port.group_cost_words == TFu.frontier_dp_min_bw(
        pg, max_width=None).group_cost_words


@pytest.mark.parametrize("max_group_len", [1, 2, 3])
def test_brute_force_group_length_cap_matches_reference(max_group_len):
    rg, pg = _random_dag(RI, 4203), _random_dag(TI, 4203)
    port = TFu.brute_force_min_bw(pg, max_group_len=max_group_len)
    _assert_same_result(port, RFu.brute_force_min_bw(rg, max_group_len=max_group_len))
    sizes = [len(g) for g in TFu.groups_from_labels(TFu.cut_group_labels(pg, port.cuts))]
    assert max(sizes) <= max_group_len


@pytest.mark.parametrize("oracle,batched", [
    ("_brute_force_min_bw_scalar", "brute_force_min_bw"),
    ("_greedy_merge_cuts_scalar", "greedy_merge_cuts"),
    ("_beam_merge_cuts_scalar", "beam_merge_cuts")])
@pytest.mark.parametrize("seed", range(3))
def test_scalar_oracles_match_reference_and_batched(oracle, batched, seed):
    rg, pg = _random_dag(RI, 4200 + seed, 6), _random_dag(TI, 4200 + seed, 6)
    for budget in (INF, _median_budget(pg)):
        port = getattr(TFu, oracle)(pg, sram_budget_words=budget)
        _assert_same_result(port, getattr(RFu, oracle)(rg, sram_budget_words=budget))
        fast = getattr(TFu, batched)(pg, sram_budget_words=budget)
        assert fast.group_cost_words == port.group_cost_words


def _with_carry(mod, state_words: int):
    """The residual block with a recurrent carry on its join node."""
    g = mod.residual_block_ir()
    nodes = list(g.nodes)
    nodes[3] = dataclasses.replace(nodes[3], kind="scan", state_words=state_words)
    return mod.GraphIR("carry", tuple(nodes), g.edges)


@pytest.mark.parametrize("engine", ["frontier_dp_min_bw", "brute_force_min_bw"])
def test_infeasible_budget_raises_like_the_reference(engine):
    # a carry held in every grouping cannot fit a budget below it
    with pytest.raises(TE.InfeasibleBudgetError) as port:
        getattr(TFu, engine)(_with_carry(TI, 5000), sram_budget_words=4000.0)
    with pytest.raises(ValueError) as ref:
        getattr(RFu, engine)(_with_carry(RI, 5000), sram_budget_words=4000.0)
    assert str(port.value) == str(ref.value)
    assert isinstance(port.value, ValueError)


@pytest.mark.parametrize("budget", [1.0, 150_000.0, INF])
def test_a_carry_shrinks_the_budget_like_the_reference(budget):
    port = TFu.optimal_cuts(_with_carry(TI, 1000), sram_budget_words=budget + 1000)
    ref = RFu.optimal_cuts(_with_carry(RI, 1000), sram_budget_words=budget + 1000)
    _assert_same_result(port, ref)


# ---------------------------------------------------------------------------
# The in-repo DAGs: the locked optima
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,budget,cost", LOCKS)
def test_locked_optima_match_reference(name, budget, cost):
    ref, port = _pair(name)
    got = TFu.frontier_dp_min_bw(port, sram_budget_words=budget)
    _assert_same_result(got, RFu.frontier_dp_min_bw(ref, sram_budget_words=budget))
    assert got.engine == "frontier_dp" and got.exact
    assert got.group_cost_words == cost
    disp = TFu.optimal_cuts(port, sram_budget_words=budget)
    _assert_same_result(disp, RFu.optimal_cuts(ref, sram_budget_words=budget))
    assert np.array_equal(disp.cuts, got.cuts)


@pytest.mark.parametrize("engine", ["greedy_merge_cuts", "beam_merge_cuts"])
@pytest.mark.parametrize("budget", [INF, 200_000.0])
def test_merge_search_on_resnet18_matches_reference(engine, budget):
    ref, port = _pair("resnet18_ir")
    got = getattr(TFu, engine)(port, sram_budget_words=budget)
    _assert_same_result(got, getattr(RFu, engine)(ref, sram_budget_words=budget))
    dp = TFu.optimal_cuts(port, sram_budget_words=budget)
    assert dp.group_cost_words <= got.group_cost_words


@pytest.mark.parametrize("budget", [INF, 150_000.0])
def test_brute_force_on_the_residual_block_matches_the_dp(budget):
    ref, port = _pair("residual_block_ir")
    bf = TFu.brute_force_min_bw(port, sram_budget_words=budget)
    _assert_same_result(bf, RFu.brute_force_min_bw(ref, sram_budget_words=budget))
    assert bf.group_cost_words == TFu.frontier_dp_min_bw(
        port, sram_budget_words=budget).group_cost_words


# ---------------------------------------------------------------------------
# optimal_cuts: dispatch, caps, memo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,engine", [
    ("chain", "chain_dp"), ("residual", "frontier_dp"),
    ("wide_fanin", "exhaustive"), ("wide", "beam")])
def test_optimal_cuts_dispatch_matches_reference(case, engine):
    width = TFu.FRONTIER_DP_MAX_WIDTH + 1
    build = {"chain": lambda m: m.vgg16_ir(),
             "residual": lambda m: m.residual_block_ir(),
             "wide_fanin": lambda m: _wide_fanin_dag(m, width),
             "wide": lambda m: _wide_dag(m, width)}[case]
    port = TFu.optimal_cuts(build(TI))
    _assert_same_result(port, RFu.optimal_cuts(build(RI)))
    assert port.engine == engine
    assert port.exact == (engine != "beam")


def test_wide_graphs_decline_the_dp_like_the_reference():
    width = TFu.FRONTIER_DP_MAX_WIDTH + 1
    assert _wide_fanin_dag(TI, width).n_edges <= TFu.MAX_EXHAUSTIVE_EDGES
    assert _wide_dag(TI, width).n_edges > TFu.MAX_EXHAUSTIVE_EDGES
    for build in (_wide_dag, _wide_fanin_dag):
        with pytest.raises(TFu.FrontierTooWide, match="frontier width 13"):
            TFu.frontier_dp_min_bw(build(TI, width))
        with pytest.raises(RFu.FrontierTooWide, match="frontier width 13"):
            RFu.frontier_dp_min_bw(build(RI, width))
    assert issubclass(TFu.FrontierTooWide, TE.SearchDeclined)


def test_state_cap_raises_frontier_too_wide():
    pg = _random_dag(TI, 4200)
    rg = _random_dag(RI, 4200)
    budget = _median_budget(pg)
    with pytest.raises(TFu.FrontierTooWide, match="live states"):
        TFu.frontier_dp_min_bw(pg, sram_budget_words=budget, max_width=None,
                               max_states=1)
    with pytest.raises(RFu.FrontierTooWide, match="live states"):
        RFu.frontier_dp_min_bw(rg, sram_budget_words=budget, max_width=None,
                               max_states=1)


def test_optimal_cuts_hands_out_fresh_cuts():
    g = TI.residual_block_ir()
    a = TFu.optimal_cuts(g)
    a.cuts[:] = True
    b = TFu.optimal_cuts(g)
    assert not b.cuts.all() and b.group_cost_words == 200704.0


def test_the_memo_is_keyed_by_value():
    # two builds of one graph are equal, hash alike and share the memo
    a, b = TI.residual_block_ir(channels=96), TI.residual_block_ir(channels=96)
    assert a is not b and a == b and hash(a) == hash(b)
    TFu._frontier_dp_cached.cache_clear()
    TFu.optimal_cuts(a)
    TFu.optimal_cuts(b, sram_budget_words=INF)
    info = TFu._frontier_dp_cached.cache_info()
    assert (info.hits, info.misses) == (1, 1)


def test_a_declined_dp_is_memoised():
    g = _wide_dag(TI, TFu.FRONTIER_DP_MAX_WIDTH + 1)
    TFu._frontier_dp_cached.cache_clear()
    assert TFu._frontier_dp_cached(g, INF) is None
    assert TFu._frontier_dp_cached(g, INF) is None
    assert TFu._frontier_dp_cached.cache_info().hits == 1


# ---------------------------------------------------------------------------
# Merge moves: the incremental delta and the convexity filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_merge_bandwidth_delta_is_the_bandwidth_difference(seed):
    rg, pg = _random_dag(RI, 300 + seed, 9), _random_dag(TI, 300 + seed, 9)
    labels = np.arange(len(pg.nodes))
    ga = TM.graph_arrays(pg)
    for _ in range(len(pg.nodes)):
        pairs = TFu._valid_merge_pairs(ga, labels)
        if not pairs:
            break
        before = TM.bandwidth_ref(pg, TFu.cuts_from_labels(pg, labels))
        for a, b in pairs:
            merged = np.where(labels == b, a, labels)
            want = TM.bandwidth_ref(pg, TFu.cuts_from_labels(pg, merged)) - before
            got = TFu.merge_bandwidth_delta(pg, labels, a, b)
            assert got == want == RFu.merge_bandwidth_delta(rg, labels, a, b)
        a, b = pairs[len(pairs) // 2]
        labels = np.where(labels == b, a, labels)


@pytest.mark.parametrize("seed", range(6))
def test_valid_merge_pairs_equal_the_scalar_convexity_filter(seed):
    rg, pg = _random_dag(RI, 500 + seed, 10), _random_dag(TI, 500 + seed, 10)
    rng = np.random.default_rng(seed)
    ga, ra = TM.graph_arrays(pg), RM.graph_arrays(rg)
    for _ in range(8):
        # a valid grouping: the components of a random set of uncut edges,
        # re-cut where a cut edge fell inside a group
        cuts = rng.random(pg.n_edges) < 0.6
        labels = TFu.cut_group_labels(pg, cuts)
        if not TFu._quotient_is_dag(pg, labels):
            continue
        got = TFu._valid_merge_pairs(ga, labels)
        assert got == RFu._valid_merge_pairs(ra, labels)
        assert got == [
            (a, b) for a, b in TFu._merge_pairs(ga.esrc, ga.edst, labels)
            if TFu._quotient_is_dag(pg, np.where(labels == b, a, labels))]
        merged = TFu._merged_label_batch(labels, got) if got else None
        if merged is not None:
            assert np.array_equal(merged, RFu._merged_label_batch(labels, got))


# ---------------------------------------------------------------------------
# The flow on ResNet-18
# ---------------------------------------------------------------------------


def _assert_same_flow(port, ref):
    assert _fields(port.best_hw) == _fields(ref.best_hw)
    assert np.array_equal(port.best_cuts, ref.best_cuts)
    assert _fields(port.best_metrics) == _fields(ref.best_metrics)
    assert port.group_sizes == ref.group_sizes
    assert (port.n_candidates, port.n_feasible, port.n_pruned) == (
        ref.n_candidates, ref.n_feasible, ref.n_pruned)
    assert port.search_engine == ref.search_engine


def test_run_flow_search_on_resnet18_matches_reference():
    ref, port = _pair("resnet18_ir")
    r = RF.run_flow(ref, config_space=RA.default_config_space(), groupings="search")
    p = TF.run_flow(port, config_space=TA.default_config_space(),
                    groupings="search", device="cpu")
    _assert_same_flow(p, r)
    assert (p.n_candidates, p.n_feasible) == (960, 788)
    assert p.best_hw == TA.DLAConfig("hsiao", 8, 2, 2, 4)
    assert p.group_sizes == (31,) and p.search_engine == "frontier_dp"
    assert _fields(p.best_metrics) == _fields(
        TM.evaluate_ref(port, p.best_cuts, p.best_hw))


@pytest.mark.parametrize("budget", [200_000.0, 400_000.0])
def test_run_flow_search_under_a_budget_matches_reference(budget):
    ref, port = _pair("resnet18_ir")
    kw = dict(groupings="search", sram_budget_words=budget,
              constraints=RA.Constraints(*[INF] * 4))
    r = RF.run_flow(ref, config_space=RA.default_config_space()[::8], **kw)
    p = TF.run_flow(port, config_space=TA.default_config_space()[::8],
                    device="cpu", **kw)
    _assert_same_flow(p, r)
    assert p.n_pruned > 0 and p.search_engine == "frontier_dp"
    dp = TFu.optimal_cuts(port, sram_budget_words=budget)
    assert p.best_metrics.bandwidth_words == TM.bandwidth_ref(port, dp.cuts)


def test_compare_fusion_on_resnet18_matches_reference():
    ref, port = _pair("resnet18_ir")
    cuts = TFu.optimal_cuts(port).cuts
    r = RF.compare_fusion(ref, RA.PAPER_OPTIMAL_CONFIG, fused_cuts=cuts)
    p = TF.compare_fusion(port, TA.PAPER_OPTIMAL_CONFIG, fused_cuts=cuts)
    assert _fields(p.lbl) == _fields(r.lbl) and _fields(p.fused) == _fields(r.fused)
    assert (p.bw_reduction, p.latency_reduction, p.energy_reduction) == (
        r.bw_reduction, r.latency_reduction, r.energy_reduction)
    assert p.bw_reduction == 0.39744620408283005
    assert p.latency_reduction == 0.33105833902675863
    assert p.energy_reduction == 0.3235805468798656


def test_exhaustive_flow_on_the_residual_block_matches_reference():
    ref, port = _pair("residual_block_ir")
    kw = dict(groupings="exhaustive", constraints=RA.Constraints(*[INF] * 4))
    r = RF.run_flow(ref, config_space=RA.paper_config_space(), **kw)
    p = TF.run_flow(port, config_space=TA.paper_config_space(), device="cpu", **kw)
    _assert_same_flow(p, r)
    assert p.search_engine == "exhaustive"
