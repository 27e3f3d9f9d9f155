"""The port's fleet sweep (``repro_torch.core.flow.run_fleet``) against the
JAX package's, on the CPU.

Every comparison is exact: the same inputs (the bench_shard co-search's four
workloads, explicit per-graph batches, SRAM budgets) go through the
reference's jitted fleet program and the port's float64 torch sweep
(``device="cpu"``), and every evaluator output — best hardware, cuts,
metrics, counts, engine, Pareto metrics and indices — must be bit-identical.
The hardware-axis split (``devices=("cpu",) * k``) must equal the
single-device sweep at every k, including one that pads H.  The co-search's
digests are ``chip_smoke.FLEET_LOCKS``, which the card run holds its own
results to.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import arch as RA  # noqa: E402
from repro.core import flow as RF  # noqa: E402
from repro.core import ir as RI  # noqa: E402
from repro.core import metrics as RM  # noqa: E402
from repro_torch.core import arch as TA  # noqa: E402
from repro_torch.core import errors as TE  # noqa: E402
from repro_torch.core import flow as TF  # noqa: E402
from repro_torch.core import ir as TI  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INF = float("inf")
# benchmarks/bench_shard.py's smoke grid (48 points) and full grid (2,560).
SMOKE = dict(f1s=(2, 4), f2s=(2, 4), f3s=(2, 4), f4s=(2, 4), bus_widths=(2, 4),
             sram_splits=("unified",))
GRIDS = {"smoke": SMOKE, "full": {}}
CASES = [("smoke", "pool"), ("smoke", "search"), ("full", "pool")]
WORKLOADS = ("resnet18", "residual_block", "vgg16", "encoder_decoder")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _works(I):
    """bench_shard's four co-search workloads, in either package."""
    return [I.resnet18_ir(), I.residual_block_ir(),
            I.as_graph(I.vgg16_ir(pool_mode="separate")), I.encoder_decoder_ir()]


def _fleet(F, A, I, grid, groupings, **kw):
    kw.setdefault("constraints", A.Constraints(*[INF] * 4))
    if F is TF:
        kw.setdefault("device", "cpu")
    return F.run_fleet(_works(I), config_space=A.config_space_grid(**GRIDS[grid]),
                       groupings=groupings, pareto=True, **kw)


def _metrics(m) -> tuple:
    return (m.bandwidth_words, m.latency_cycles, m.energy_nj, m.area_um2)


def assert_same_flow(port, ref):
    """Bit-identity of two FlowResults' answers (not their timings)."""
    assert np.array_equal(port.best_hw.as_row(), ref.best_hw.as_row())
    assert port.best_hw.describe() == ref.best_hw.describe()
    assert np.array_equal(port.best_cuts, ref.best_cuts)
    assert port.best_cuts.dtype == ref.best_cuts.dtype
    assert _metrics(port.best_metrics) == _metrics(ref.best_metrics)
    assert (port.group_sizes, port.n_candidates, port.n_feasible, port.n_pruned,
            port.search_engine) == (ref.group_sizes, ref.n_candidates,
                                    ref.n_feasible, ref.n_pruned, ref.search_engine)
    fp, fr = port.pareto, ref.pareto
    assert (fp is None) == (fr is None)
    if fp is not None:
        for f in ("metrics", "hw_indices", "cut_indices", "cuts"):
            assert np.array_equal(getattr(fp, f), getattr(fr, f)), f
        assert fp.n_feasible == fr.n_feasible and fp.search_engine == fr.search_engine
        assert [c.describe() for c in fp.configs] == [c.describe() for c in fr.configs]


def assert_same_fleet(port, ref):
    assert (port.n_graphs, port.n_candidates) == (ref.n_graphs, ref.n_candidates)
    for p, r in zip(port.results, ref.results):
        assert_same_flow(p, r)


@pytest.fixture(scope="module")
def ref_fleets():
    """The reference's co-search results, computed once per module."""
    return {case: _fleet(RF, RA, RI, *case) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_run_fleet_matches_reference_on_the_co_search(ref_fleets, case):
    port = _fleet(TF, TA, TI, *case)
    assert_same_fleet(port, ref_fleets[case])
    assert port.device_count == 1 and port.chunks_computed == 1
    assert port.quarantine is None and not port.mesh_degraded


def test_fleet_locks_are_the_reference_and_the_ports_digests(ref_fleets):
    cs = _chip_smoke()
    port = _fleet(TF, TA, TI, "full", "pool")
    for name, r, p in zip(WORKLOADS, ref_fleets["full", "pool"].results, port.results):
        n_cand, n_feas, n_front, digest = cs.FLEET_LOCKS[name]
        assert (r.n_candidates, r.n_feasible, r.pareto.size) == (n_cand, n_feas, n_front)
        assert cs.flow_digest(r) == digest, name
        assert cs.flow_digest(p) == digest, name


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("grid", ["smoke", "full"])
def test_split_over_k_devices_equals_the_single_device_sweep(ref_fleets, grid, k):
    """48 and 2,560 hardware rows: k = 3 pads H (2,560 = 3 x 853 + 1) with
    copies of config 0, sliced off before composition."""
    split = _fleet(TF, TA, TI, grid, "pool", devices=("cpu",) * k)
    assert split.device_count == k
    assert ("hardware mesh" in split.describe()) == (k > 1)
    assert_same_fleet(split, ref_fleets[grid, "pool"])


def test_split_over_the_default_space_pads_and_matches_the_reference():
    """320 configurations over 3 devices: two padded rows."""
    gs_r, gs_t = _works(RI)[:2], _works(TI)[:2]
    ref = RF.run_fleet(gs_r, groupings="search", pareto=True)
    port = TF.run_fleet(gs_t, groupings="search", pareto=True,
                        devices=("cpu", "cpu", "cpu"))
    assert port.device_count == 3
    assert_same_fleet(port, ref)


def test_run_fleet_results_equal_run_flow_per_graph():
    space = TA.default_config_space()[::4]
    gs = _works(TI)
    fl = TF.run_fleet(gs, config_space=space, groupings="search", pareto=True,
                      device="cpu")
    for g, r in zip(gs, fl.results):
        assert_same_flow(r, TF.run_flow(g, config_space=space, groupings="search",
                                        pareto=True, device="cpu"))
        assert r.compile_seconds == 0.0


def _batches(mod, gs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for g in gs:
        rows = [np.ones(g.n_edges, bool), np.zeros(g.n_edges, bool)]
        rows += [rng.random(g.n_edges) < 0.5 for _ in range(int(rng.integers(1, 6)))]
        out.append(np.stack(rows))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_per_graph_explicit_batches_match_reference(seed):
    """The service's form: one explicit (C_i, E_i) batch per graph."""
    gs_r = [RI.residual_block_ir(), RI.resnet18_ir(), RI.encoder_decoder_ir()]
    gs_t = [TI.residual_block_ir(), TI.resnet18_ir(), TI.encoder_decoder_ir()]
    batches = _batches(np, gs_t, seed)
    space_r, space_t = RA.paper_config_space(), TA.paper_config_space()
    loose_r, loose_t = RA.Constraints(*[INF] * 4), TA.Constraints(*[INF] * 4)
    ref = RF.run_fleet(gs_r, config_space=space_r, constraints=loose_r,
                       groupings=batches, pareto=True)
    port = TF.run_fleet(gs_t, config_space=space_t, constraints=loose_t,
                        groupings=batches, pareto=True, device="cpu")
    assert_same_fleet(port, ref)
    assert all(r.search_engine == "explicit" for r in port.results)


@pytest.mark.parametrize("budget", [2e6, 4e5, 1.5e5])
def test_sram_prefilter_matches_reference(budget):
    gs_r = [RI.residual_block_ir(), RI.encoder_decoder_ir()]
    gs_t = [TI.residual_block_ir(), TI.encoder_decoder_ir()]
    kw = dict(groupings="search", sram_budget_words=budget)
    loose_r, loose_t = RA.Constraints(*[INF] * 4), TA.Constraints(*[INF] * 4)
    ref = RF.run_fleet(gs_r, config_space=RA.paper_config_space(),
                       constraints=loose_r, **kw)
    port = TF.run_fleet(gs_t, config_space=TA.paper_config_space(),
                        constraints=loose_t, device="cpu", **kw)
    assert_same_fleet(port, ref)


def test_infeasible_budget_names_the_least_workable_budget_like_reference():
    gs_r, gs_t = [RI.residual_block_ir()], [TI.residual_block_ir()]
    fused = np.zeros((1, gs_t[0].n_edges), bool)
    kw = dict(groupings=[fused], sram_budget_words=1000.0)
    with pytest.raises(ValueError) as er:
        RF.run_fleet(gs_r, config_space=RA.paper_config_space(), **kw)
    with pytest.raises(TE.InfeasibleBudgetError) as ep:
        TF.run_fleet(gs_t, config_space=TA.paper_config_space(), device="cpu", **kw)
    assert str(ep.value) == str(er.value)
    assert ep.value.min_feasible_budget_words == er.value.min_feasible_budget_words
    # the reported budget is actionable: retrying with it succeeds
    kw["sram_budget_words"] = ep.value.min_feasible_budget_words
    res = TF.run_fleet(gs_t, config_space=TA.paper_config_space(), device="cpu",
                       constraints=TA.Constraints(*[INF] * 4), **kw)
    assert res.results[0].n_feasible >= 1


def test_infeasible_constraints_name_the_graph_like_reference():
    tight_r = RA.Constraints(1.0, 1.0, 1.0, 1.0)
    tight_t = TA.Constraints(1.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError) as er:
        RF.run_fleet([RI.residual_block_ir()], config_space=RA.paper_config_space(),
                     constraints=tight_r, groupings="pool")
    with pytest.raises(TE.InfeasibleConstraintsError) as ep:
        TF.run_fleet([TI.residual_block_ir()], config_space=TA.paper_config_space(),
                     constraints=tight_t, groupings="pool", device="cpu")
    assert str(ep.value) == str(er.value)


VALIDATION = {  # flow.py's argument checks, in the reference's order
    "empty": (lambda F, g: F.run_fleet([], **_cpu(F)), "empty fleet"),
    "chunk_and_devices": (lambda F, g: F.run_fleet([g], hw_chunk=4, devices=1),
                          "hw_chunk cannot be combined with devices"),
    "chunk_zero": (lambda F, g: F.run_fleet([g], hw_chunk=0, **_cpu(F)),
                   "hw_chunk must be positive, got 0"),
    "chunk_negative": (lambda F, g: F.run_fleet([g], hw_chunk=-3, **_cpu(F)),
                       "hw_chunk must be positive, got -3"),
    "checkpoint_no_chunk": (
        lambda F, g: F.run_fleet([g], checkpoint_dir="/nonexistent", **_cpu(F)),
        "checkpoint_dir requires hw_chunk"),
    "spec_count": (lambda F, g: F.run_fleet(
        [g, g], groupings=[np.ones((1, g.n_edges), bool)], **_cpu(F)),
        "1 grouping specs for 2 graphs"),
    "mixed_area": (lambda F, g: F.run_fleet([g], config_space=_mixed(F), **_cpu(F)),
                   "mixes 2 area-constant calibrations"),
}


def _cpu(F) -> dict:
    return {"device": "cpu"} if F is TF else {}


def _mixed(F):
    A = TA if F is TF else RA
    return [A.DLAConfig("hsiao", 2, 2, 2, 2),
            dataclasses.replace(A.DLAConfig("hsiao", 4, 4, 4, 4), area_controller_um2=1.0)]


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors_match_reference(case):
    call, message = VALIDATION[case]
    with pytest.raises(ValueError) as er:
        call(RF, RI.residual_block_ir())
    with pytest.raises(ValueError) as ep:
        call(TF, TI.residual_block_ir())
    assert type(ep.value).__name__ == type(er.value).__name__
    assert message in str(ep.value) and str(ep.value) == str(er.value)


def test_device_layout_validation():
    g = TI.residual_block_ir()
    with pytest.raises(ValueError, match=">= 1"):
        TF.run_fleet([g], devices=0)
    with pytest.raises(ValueError, match="only"):
        TF.run_fleet([g], devices=4096)
    with pytest.raises(ValueError, match="empty device list"):
        TF.run_fleet([g], devices=())


def test_hardware_mesh_layouts():
    assert TS.hardware_mesh(("cpu", "cpu")) == (torch.device("cpu"),) * 2
    mesh = TS.hardware_mesh(["cpu"])
    assert TS.mesh_fingerprint(mesh) == ("hardware", 1, ("cpu",))
    assert TS.mesh_fingerprint(TS.hardware_mesh(("cpu",) * 3))[:2] == ("hardware", 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            TS.hardware_mesh(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.hardware_mesh(("cuda:0", "cuda:0"))
    with pytest.raises(ValueError, match="unsupported device"):
        TS.hardware_mesh(("meta",))


def test_no_executable_is_cached_for_any_layout():
    """The reference keys compiled programs by device layout; the port
    compiles nothing: ``entries`` stays empty, ``misses`` counts sweeps."""
    TF.clear_sweep_cache()
    gs = [TI.residual_block_ir()]
    space = TA.paper_config_space()
    TF.run_fleet(gs, config_space=space, groupings="pool", device="cpu")
    TF.run_fleet(gs, config_space=space, groupings="pool", devices=("cpu", "cpu"))
    TF.run_fleet(gs, config_space=space, groupings="pool", device="cpu", hw_chunk=3)
    stats = TF.sweep_cache_stats()
    assert stats["entries"] == [] and stats["size"] == 0
    assert (stats["hits"], stats["evictions"]) == (0, 0)
    assert stats["misses"] == 2 + 3  # one sweep each, then 3 chunks of 3


def _fleet_args(I, A, gs, space):
    """The padded fleet argument tuple, built as run_fleet builds it."""
    node_b = I.bucket_size(max(g.n_nodes for g in gs), 32)
    edge_b = I.bucket_size(max(g.n_edges for g in gs), 64)
    pgs = [I.pad_graph(g, n_nodes=node_b, n_edges=edge_b) for g in gs]
    batches = [I.pad_cuts_batch(b, edge_b, 8) for b in _batches(np, gs, 5)]
    return (np.stack([p.feat for p in pgs]), np.stack([p.esrc for p in pgs]),
            np.stack([p.edst for p in pgs]), np.stack([p.ewords for p in pgs]),
            np.stack([p.src_mask for p in pgs]), np.stack([p.sink_mask for p in pgs]),
            np.stack(batches), np.stack([c.as_row() for c in space]),
            TM.area_consts_of_space(space) if A is TA else RM.area_consts_of_space(space),
            np.stack([p.node_mask for p in pgs]), np.stack([p.edge_mask for p in pgs]))


def test_fleet_evaluator_and_split_kernel_match_reference():
    gs_r = [RI.residual_block_ir(), RI.resnet18_ir()]
    gs_t = [TI.residual_block_ir(), TI.resnet18_ir()]
    args_r = _fleet_args(RI, RA, gs_r, RA.paper_config_space())
    args_t = _fleet_args(TI, TA, gs_t, TA.paper_config_space())
    for a, b in zip(args_r, args_t):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    want = RM.evaluate_fleet_graph(*args_r)
    got = TM.evaluate_fleet_graph(*args_t, device="cpu")
    assert got.shape == want.shape == (2, 8, 8, 4)
    assert got.tobytes() == want.tobytes()
    raw = TM._evaluate_fleet_graph(*TM.sweep_tensors(args_t, torch.device("cpu"))).numpy()
    for mesh in (("cpu",), ("cpu", "cpu"), ("cpu",) * 4):
        split = TM.sharded_fleet_kernel(TS.hardware_mesh(mesh))(*args_t)
        assert split.tobytes() == raw.tobytes()
    with pytest.raises(ValueError, match="do not split"):
        TM.sharded_fleet_kernel(("cpu",) * 3)(*args_t)


def test_chain_evaluator_matches_reference():
    g_r, g_t = RI.vgg16_ir(), TI.vgg16_ir()
    feat = TI.as_graph(g_t).node_features()
    space_r, space_t = RA.paper_config_space(), TA.paper_config_space()
    cuts = np.random.default_rng(0).random((6, feat.shape[0] - 1)) < 0.5
    for a, b in zip(RM.chain_edge_arrays(feat), TM.chain_edge_arrays(feat)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    hw_r = np.stack([c.as_row() for c in space_r])
    # The reference's chain wrapper converts with jnp.asarray, float32
    # outside an x64 scope; the port sweeps in float64 always.
    from jax.experimental import enable_x64

    with enable_x64():
        want = np.asarray(RM.evaluate_batch(feat, cuts, hw_r,
                                            RM.area_consts_of_space(space_r)))
    got = TM.evaluate_batch(feat, cuts, np.stack([c.as_row() for c in space_t]),
                            TM.area_consts_of_space(space_t), device="cpu")
    assert got.tobytes() == want.tobytes()
    assert RI.as_graph(g_r).node_features().tobytes() == feat.tobytes()
