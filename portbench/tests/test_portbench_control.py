"""The check's control and its faults, at a size a test run holds (the tiny
cells, bfloat16 as the real ones, with limits read the same way at this
size in ``data/limits``).

The control, the plain reference computed in float8 in the program's
place, has to fail one of each cell's numbers while the program passes
them.  Then each run is driven with the timed path broken underneath, once
for each fault the cell can have, and ``correct`` has to come out false.
"""
import contextlib
import dataclasses
from unittest import mock

import pytest
import torch

from portbench import calibrate, harness, program as P


@pytest.mark.parametrize("name", ["tiny-train", "tiny-prefill"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_control_fails_and_the_program_passes(tiny_cell, name, seed):
    cell = tiny_cell(name)
    numbers, _ = calibrate.control(cell, seed)
    assert any(numbers[k] > limit for k, limit in cell.limits.items() if k in numbers), numbers
    assert harness.run_cell(cell, seed, 0.0, False, harness.Clock())["correct"]


@contextlib.contextmanager
def state_unchanged():
    """AdamW returns the parameters and moments as they were."""
    from repro_torch.runtime import steps

    real = steps.adamw_update

    def unchanged(grads, opt_state, params, **kw):
        return params, {**opt_state, "step": opt_state["step"] + 1}, torch.zeros(())

    steps.adamw_update = unchanged
    try:
        yield
    finally:
        steps.adamw_update = real


@contextlib.contextmanager
def loss_altered():
    """The step reports each loss 1 % high: an answer altered where it is
    produced."""
    from repro_torch.runtime import steps

    real = steps.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def altered(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            return params, opt_state, {**metrics, "loss": metrics["loss"] * 1.01}

        return altered

    steps.make_train_step = make
    try:
        yield
    finally:
        steps.make_train_step = real


@contextlib.contextmanager
def prefill_fault(kind: str):
    """The port's prefill broken: ``half`` computes the first half of the
    batch and answers the other half with its rows; ``unwritten`` leaves
    the cache as it was given; ``altered`` answers every request with its
    logits 5 % high, altered where they are produced; ``tail`` has the
    attention leave out the last 8 positions of the longest prompts, as a
    kernel that mishandles a ragged last tile would."""
    from repro_torch.models import model as M

    real = M.prefill
    if kind == "tail":
        inner = P.SERVE_KERNELS.attention

        def attention(q, k, v, **kw):
            out = inner(q, k, v, **kw)
            if q.shape[1] == 48:
                out = out.clone()
                out[:, -8:] = 0
            return out

        kernels = dataclasses.replace(P.SERVE_KERNELS, attention=attention)
        with mock.patch.object(P, "SERVE_KERNELS", kernels):
            yield
        return

    def broken(params, cfg, rc, batch, cache, **kw):
        if kind == "altered":
            logits, cache = real(params, cfg, rc, batch, cache, **kw)
            return logits * 1.05, cache
        if kind == "unwritten":
            fresh = M.init_cache(cfg, batch["tokens"].shape[0], batch["tokens"].shape[1],
                                 device=batch["tokens"].device)
            logits, _ = real(params, cfg, rc, batch, fresh, **kw)
            return logits, cache
        h = batch["tokens"].shape[0] // 2
        half = {"segments": [[{k: {"k": e["k"][:h], "v": e["v"][:h]} for k, e in layer.items()}
                              for layer in seg] for seg in cache["segments"]], "len": 0}
        logits, _ = real(params, cfg, rc, {"tokens": batch["tokens"][:h]}, half, **kw)
        return torch.cat([logits, logits]), cache

    M.prefill = broken
    try:
        yield
    finally:
        M.prefill = real


@pytest.mark.parametrize("name, fault", [
    ("tiny-train", state_unchanged),
    ("tiny-train", calibrate.half_batch),
    ("tiny-train", loss_altered),
    ("tiny-prefill", lambda: prefill_fault("half")),
    ("tiny-prefill", lambda: prefill_fault("unwritten")),
    ("tiny-prefill", lambda: prefill_fault("altered")),
    ("tiny-prefill", lambda: prefill_fault("tail")),
])
def test_a_broken_timed_path_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name)
    with fault():
        result = harness.run_cell(cell, 9, 0.0, False, harness.Clock())
    assert not result["correct"], result["checks"]
