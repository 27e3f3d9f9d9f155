"""The port's spans and counters (``repro_torch.runtime.spans``) on the CPU.

* Tracing off: ``span`` hands back the shared null context, ``count``
  records nothing, and a profiler over a training step sees no
  ``repro_torch.*`` range.
* Tracing on: a training step records its spans in order, nested in
  ``train.step``; the MoE layer's counters equal the claims, kept claims,
  slots and expert rows worked out by hand for a router rigged to send
  every token to the same two experts, drops included, on the capacity
  path and on the sorted one (patched in: it runs on the card alone), and
  the rule that picks the sorted path.
* The training step's parameters, the prefill's logits and the sorted
  MoE path's output are the same bits with tracing on and off.
* A Jamba prefill (``JambaConfig``, its time chunk cut so that every
  Mamba layer scans in several calls) records each Mamba layer's spans
  inside ``prefill.step`` in the mixer's order, and counts the layers'
  tokens and scan calls as the shapes give them.

On the CPU the backward runs on the caller's thread, so the backward span
nests in the step there; on CUDA tensors it runs on the autograd engine's
thread (tests/test_torch_on_card.py).
"""
import contextlib
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import moe, ssm
from repro_torch.runtime import spans
from repro_torch.runtime.steps import make_init, make_prefill_step, make_train_step

PREFIX = "repro_torch."


@pytest.fixture(autouse=True)
def clean_counters():
    spans.reset()
    yield
    spans.reset()


def _ranges(prof) -> list:
    """[(name, start, end)] of the port's spans in ``prof``, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PREFIX)]
    return sorted(out, key=lambda r: r[1])


def _setup(arch: str, microbatches: int = 2):
    cfg = configs.scaled_down(configs.resolve(arch))
    rc = configs.RunConfig(microbatches=microbatches, remat="full", flash_vjp=True)
    params, opt = make_init(cfg, rc, device="cpu")(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    return cfg, rc, params, opt, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _train(arch: str, on: bool, microbatches: int = 2, prof: bool = False):
    cfg, rc, params, opt, batch = _setup(arch, microbatches)
    step = make_train_step(cfg, rc)
    with spans.enabled() if on else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU]) if prof else contextlib.nullcontext() as p:
            params, opt, met = step(params, opt, batch)
    return params, opt, met, p


def _prefill(arch: str, on: bool):
    cfg, rc, params, _opt, batch = _setup(arch)
    step = make_prefill_step(cfg, configs.RunConfig(remat="none"))
    cache = M.init_cache(cfg, 2, 32, device="cpu")
    with torch.inference_mode(), spans.enabled() if on else contextlib.nullcontext():
        logits, _cache = step(params, cache, {"tokens": batch["tokens"]})
    return logits


@pytest.mark.parametrize("what", ["span", "count", "profile"])
def test_tracing_off_records_nothing(what):
    if what == "span":
        assert spans.span(spans.TRAIN_STEP) is spans.span(spans.ADAMW) is spans._NULL
        with spans.enabled():
            assert spans.span(spans.TRAIN_STEP) is not spans._NULL
        assert spans.span(spans.TRAIN_STEP) is spans._NULL
    elif what == "count":
        spans.count("moe.claims", 7)
        spans.count("moe.kept", torch.ones(3, dtype=torch.bfloat16))
        assert spans.counters() == {}
        with spans.enabled():
            spans.count("moe.claims", 7)
        assert spans.counters() == {"moe.claims": 7}
    else:
        *_, prof = _train("qwen3", on=False, prof=True)
        assert _ranges(prof) == []


@pytest.mark.parametrize("microbatches, order", [
    (1, [spans.TRAIN_FORWARD, spans.TRAIN_BACKWARD, spans.ADAMW]),
    (2, [spans.GRAD_ACCUM, spans.TRAIN_FORWARD, spans.TRAIN_BACKWARD, spans.GRAD_ACCUM,
         spans.TRAIN_FORWARD, spans.TRAIN_BACKWARD, spans.GRAD_ACCUM, spans.GRAD_ACCUM,
         spans.ADAMW]),
])
def test_a_training_step_records_its_spans_in_order(microbatches, order):
    *_, prof = _train("qwen3", on=True, microbatches=microbatches, prof=True)
    ranges = _ranges(prof)
    assert set(r[0] for r in ranges) <= set(spans.NAMES)
    (step, a, b), *inner = ranges
    assert step == spans.TRAIN_STEP
    assert [r[0] for r in inner] == order
    assert all(a <= s <= e <= b for _, s, e in inner)
    assert all(e1 <= s2 for (_, _, e1), (_, s2, _) in zip(inner, inner[1:]))


CAPACITY = [  # (capacity_factor, C, claims, kept, slots) of 2 x 32 tokens: G 4, Sg 16, E 4, K 2
    (0.25, 2, 128, 16, 32),  # each of the two experts keeps its first 2 claims a group
    (1.0, 8, 128, 64, 128),  # ... its first 8
    (2.0, 16, 128, 128, 256),  # no claim dropped
]


def _rigged(cf: float, dtype):
    """(cfg, params, x) of one MoE layer whose router sends every token to
    experts 0 and 1, in that order, at capacity factor ``cf``."""
    cfg = dataclasses.replace(configs.scaled_down(configs.resolve("mixtral")), capacity_factor=cf)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_group_size) == (4, 2, 16)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, dtype)
    # every token's logits are (3, 2, 0, 0): experts 0 and 1, in that order
    params["router"] = torch.zeros(cfg.d_model, 4)
    params["router"][:, 0] = 3.0 / cfg.d_model
    params["router"][:, 1] = 2.0 / cfg.d_model
    return cfg, params, torch.ones(2, 32, cfg.d_model, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cf, C, claims, kept, slots", CAPACITY)
def test_moe_counters_match_the_rigged_routes(cf, C, claims, kept, slots, dtype):
    cfg, params, x = _rigged(cf, dtype)
    assert moe._capacity(cfg, 16) == C
    with spans.enabled():
        moe.moe_block(params, x, cfg)
    # a CPU call takes the capacity path: its products run on every slot
    assert spans.counters() == {"moe.claims": claims, "moe.kept": kept, "moe.slots": slots,
                                "moe.rows": slots}
    spans.reset()
    assert spans.counters() == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cf, C, claims, kept, slots", CAPACITY)
def test_moe_sorted_path_counts_the_kept_rows_and_traces_bit_identically(
        cf, C, claims, kept, slots, dtype, monkeypatch):
    """The sorted path, patched in on the CPU: its products run on the kept
    claims alone, and tracing on leaves its results the same bits."""
    cfg, params, x = _rigged(cf, dtype)
    x = x + torch.rand(x.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    monkeypatch.setattr(moe, "_sorted", lambda *a: True)
    off = moe.moe_block(params, x, cfg)
    assert spans.counters() == {}
    with spans.enabled():
        on = moe.moe_block(params, x, cfg)
    assert spans.counters() == {"moe.claims": claims, "moe.kept": kept, "moe.slots": slots,
                                "moe.rows": kept}
    assert all(torch.equal(a, b) for a, b in zip(off, on))


@pytest.mark.parametrize("on_card, split, rows, sorted_path", [
    (False, False, 2048, False),  # a CPU call: the path compared with the JAX package
    (True, False, 4, False),  # mixtral's decode step of 8 tokens: G * C 4
    (True, False, moe.SORTED_MIN_ROWS - 1, False),
    (True, False, moe.SORTED_MIN_ROWS, True),
    (True, False, 2048, True),  # mixtral's prefill of 4096 tokens: G 8, C 256
    (True, False, 64, False),  # llama4's prefill of 4096 tokens: G 8, C 8
    (True, False, 1024, True),  # jamba's prefill of 4096 tokens: G 8, C 128
    (True, True, 2048, False),  # the experts split over a mesh's model axis
])
def test_the_sorted_path_runs_on_the_card_once_the_products_are_compute_bound(
        on_card, split, rows, sorted_path):
    x = types.SimpleNamespace(is_cuda=True) if on_card else torch.zeros(1)
    assert moe._sorted(x, split, rows) is sorted_path


@pytest.mark.parametrize("arch, path, counted", [
    ("qwen3", "train", None),
    # 2 MoE layers, top-2, groups of 16 of 4 experts of 16 slots: 2 x 32
    # tokens prefilled are 256 claims and 8 groups' 512 slots; training
    # counts each layer's forward twice (remat "full" recomputes it)
    ("mixtral", "train", (512, 1024)),
    ("mixtral", "prefill", (256, 512)),
])
def test_tracing_leaves_the_results_bit_identical(arch, path, counted):
    if path == "train":
        off, on = (_train(arch, on)[:3] for on in (False, True))
        for a, b in zip(pytree.tree_leaves(off), pytree.tree_leaves(on)):
            assert torch.equal(a, b)
    else:
        assert torch.equal(_prefill(arch, False), _prefill(arch, True))
    got = spans.counters()
    if counted is None:
        assert got == {}
    else:
        assert (got["moe.claims"], got["moe.slots"]) == counted
        assert 0 < got["moe.kept"] <= got["moe.claims"]


def _jamba_prefill(on: bool, chunk: int, monkeypatch):
    """(logits, profile) of a prefill of 2 x 32 tokens through a reduced
    Jamba (16 layers: 14 Mamba mixers), each mixer's time chunk ``chunk``."""
    cfg = configs.JambaConfig(**dataclasses.asdict(configs.scaled_down(configs.resolve("jamba"))))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(ssm, "SCAN_BUDGET_BYTES", chunk * 2 * 4 * 2 * cfg.d_inner * cfg.ssm_state)
    assert ssm.time_chunk(2, cfg.d_inner, cfg.ssm_state) == chunk
    step = make_prefill_step(cfg, configs.RunConfig(remat="none"))
    cache = M.init_cache(cfg, 2, 32, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), spans.enabled() if on else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU]) if on else contextlib.nullcontext() as p:
            logits, _cache = step(params, cache, {"tokens": tok})
    return cfg, logits, p


@pytest.mark.parametrize("chunk, scans", [(32, 1), (12, 3), (5, 7)])
def test_mamba_spans_nest_in_the_prefill_and_count_the_shapes(chunk, scans, monkeypatch):
    cfg, logits, prof = _jamba_prefill(True, chunk, monkeypatch)
    n_mamba = sum(cfg.mixer_of(i) == "mamba" for i in range(cfg.n_layers))
    assert n_mamba == 14
    ranges = _ranges(prof)
    (step, a, b), *inner = ranges
    assert step == spans.PREFILL_STEP and all(a <= s <= e <= b for _, s, e in inner)
    assert set(r[0] for r in ranges) <= set(spans.NAMES + spans.MAMBA_NAMES)
    mixer = [r[0] for r in inner if r[0] in spans.MAMBA_NAMES]
    one = [spans.MAMBA_IN, spans.MAMBA_DISCRETIZE] + [spans.MAMBA_DISCRETIZE,
                                                     spans.MAMBA_SCAN] * scans + [spans.MAMBA_OUT]
    assert mixer == one * n_mamba
    got = spans.counters()
    assert (got["mamba.tokens"], got["mamba.scans"]) == (n_mamba * 2 * 32, n_mamba * scans)
    assert torch.equal(logits, _jamba_prefill(False, chunk, monkeypatch)[1])
