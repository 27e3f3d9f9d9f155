"""The plain reference against the port's CPU path at a tiny size in
float32, where the two must agree to rounding: training (dense) and
prefill (a mixture of experts with sliding-window attention), with tokens
dropped over capacity or not."""
import pytest

from portbench import harness


def _float32(cell, **changes):
    cell.config = {**cell.config, "dtype": "float32", **changes}
    return cell


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
def test_training_reference_follows_the_port(tiny_cell, seed):
    cell = _float32(tiny_cell("tiny-train"))
    result = harness.run_cell(cell, seed, 0.0, False, harness.Clock())
    for name in ("loss_gap", "grad_gap", "update_gap"):
        assert result["checks"][name]["value"] < 1e-5, (name, result["checks"])


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_prefill_reference_follows_the_port(tiny_cell, capacity_factor):
    """At capacity factor 0.5 each expert takes at most 8 of a group's 64
    claims: the reference must drop the same ones."""
    cell = _float32(tiny_cell("tiny-prefill"), capacity_factor=capacity_factor)
    result = harness.run_cell(cell, 5, 0.0, False, harness.Clock())
    for name in ("kv_err", "logit_err"):
        assert result["checks"][name]["value"] < 1e-5, (name, result["checks"])


def test_the_reference_drops_claims_over_capacity():
    import torch

    from portbench.reference import transformer as R

    cfg = {"n_experts": 2, "top_k": 1, "moe_group_size": 4, "capacity_factor": 1.0}
    d = 2
    # every token's router logits favour expert 0: capacity ceil(1 x 4 / 2) = 2
    w = {"router": torch.tensor([[4.0, 0.0], [4.0, 0.0]]),
         "w1": torch.ones(2, d, 3), "w3": torch.ones(2, d, 3), "w2": torch.ones(2, 3, d)}
    h = torch.ones(1, 4, d)
    y, _ = R.moe(h, w, cfg, R.Arith("fp32"))
    kept = (y.abs().sum(-1) > 0)[0].tolist()
    assert kept == [True, True, False, False]
