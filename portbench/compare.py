"""The numbers that decide ``correct``: what the program produced against
what the plain reference computes from the same inputs.

Training (the first steps of the very step object the window drives):
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``, the
worst leaf's gap between the norms of the first step's clipped gradient
(the program's read from its first moment after one step); ``update_gap``,
the worst leaf's gap between the norms of the stored parameters' change
over the checked steps.  A leaf's gap is measured against the reference's
norm of that leaf or of the median leaf, whichever is larger; leaves whose
reference gradient is under a thousandth of the median leaf's are left out.

Prefill (a sample of the window's batches): ``kv_err``, over the layers,
K and V and the rows of each batch, the worst relative error of a row's
whole cache as the program wrote it (all its tokens and heads as one
vector), divided by the layer's depth (1 for the first layer): rounding in
bfloat16 adds up layer by layer, so the error a sound run reaches grows
with depth.  ``logit_err``, over the batches, the worst lower quartile of
the relative errors of its requests' logits of the last position: the last
layer, the final norm and the head, which no cache shows.  Every request of
a batch has the batch's length, so a fault that goes with the length moves
the whole batch, while a route near a tie that flips moves a request or
two.  ``logit_gap``, the widest gap by which the logit of a served token
(the argmax of the program's last position) lies below the reference's
best, is printed beside them.
"""
from __future__ import annotations

import statistics

import torch

LEAF_FLOOR = 1e-3


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    g_med = statistics.median(ref_grad.values())
    keep = [k for k in ref if ref_grad[k] >= LEAF_FLOOR * g_med]
    med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers compared, what else to print) of a program's and a
    reference's {"loss", "grad", "delta"}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    grad_gap, grad_leaf = leaf_gap(prog["grad"], ref["grad"], ref["grad"])
    update_gap, update_leaf = leaf_gap(prog["delta"], ref["delta"], ref["grad"])
    g_med = statistics.median(ref["grad"].values())
    left_out = sorted(k for k, g in ref["grad"].items() if g < LEAF_FLOOR * g_med)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap},
            {"grad_leaf": grad_leaf, "update_leaf": update_leaf, "left_out": left_out,
             "loss": prog["loss"], "loss_ref": ref["loss"]})


def kv_error(test: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(the worst row's relative error, the largest relative error of one
    token) of ``test`` against ``ref``, both (B, S, heads, hd): a row's
    keys (or values) of all its tokens and heads are one vector, and so
    are a token's."""
    diff = (test.float() - ref.float()).flatten(2).norm(dim=-1)
    size = ref.float().flatten(2).norm(dim=-1)
    rows = diff.norm(dim=1) / size.norm(dim=1).clamp_min(1e-30)
    return float(rows.max()), float((diff / size.clamp_min(1e-30)).max())


def logit_errors(test: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per request (row of the (B, V) last-position logits), the relative
    error of ``test``'s logits against ``ref``'s."""
    ref = ref.float()
    diff = (test.float().to(ref.device) - ref).norm(dim=-1)
    return diff / ref.norm(dim=-1).clamp_min(1e-30)


def logit_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per request, the reference's best logit minus its logit of the
    served token."""
    ref_logits = ref_logits.float()
    picked = ref_logits.gather(-1, served.reshape(-1, 1).to(ref_logits.device).long())[:, 0]
    return ref_logits.max(dim=-1).values - picked
