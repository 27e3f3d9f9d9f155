"""The traffic generators: what each driver feeds the program, made from the
run's seed and the mix's parameters (``workloads/<traffic>.json``).

Training: a pool of ``batches`` batches of ``batch`` sequences of ``seq``
random tokens (labels: the next token), drawn on the device in one call;
step ``i`` takes batch ``i`` of the pool, cycling, so the first steps' rows
all differ.

Prefill: batches of ``batch`` prompts, each prompt of its batch's length.
The lengths come in groups: each group is the mix's ``lengths`` list in an
order shuffled by the seed, so every seed sends the same multiset of
lengths, in another order.  A batch's tokens are drawn, on the device, from
a generator of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .seeds import derive


def train_pool(traffic: dict, vocab: int, seed: int, device) -> list[dict]:
    """The pool of training batches: {"tokens", "labels"} (B, S) int64."""
    B, S, n = traffic["batch"], traffic["seq"], traffic["batches"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "train-data"))
    rows = torch.randint(0, vocab, (n, B, S + 1), generator=gen, device=device)
    return [{"tokens": rows[i, :, :-1].contiguous(), "labels": rows[i, :, 1:].contiguous()}
            for i in range(n)]


def prefill_lengths(traffic: dict, seed: int) -> list[int]:
    """The length of each batch the window sends, in order: ``groups``
    groups, each the ``lengths`` list shuffled."""
    rng = np.random.default_rng(derive(seed, "prefill-order"))
    out: list[int] = []
    for _ in range(traffic["groups"]):
        out += [int(x) for x in rng.permutation(traffic["lengths"])]
    return out


def prefill_tokens(traffic: dict, vocab: int, length: int, seed: int, tag,
                   device) -> torch.Tensor:
    """The (batch, length) prompt tokens of the batch named by ``tag``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "prompt", tag))
    return torch.randint(0, vocab, (traffic["batch"], length), generator=gen,
                         device=device)


def prefill_sample(lengths: list[int], traffic: dict, seed: int) -> list[int]:
    """The batches whose answers and caches the check compares: in the first
    group, one batch of each distinct length (the longest among them),
    chosen by the seed."""
    rng = np.random.default_rng(derive(seed, "prefill-sample"))
    first = lengths[:len(traffic["lengths"])]
    picks = []
    for length in sorted(set(first)):
        where = [i for i, x in enumerate(first) if x == length]
        picks.append(int(where[rng.integers(len(where))]))
    return sorted(picks)
