"""The few device calls the drivers share; on the CPU (the harness's own
tests) they do nothing or report nothing."""
from __future__ import annotations

import gc

import torch


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    """The peak of memory allocated on the card since the process started."""
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else device


def settle() -> None:
    """The end of set-up: collect what set-up left, and keep what survives
    (the weights, the state, the program's modules) out of every later
    collection, so that the window's collections scan only what its own
    steps allocate."""
    gc.collect()
    gc.freeze()


def release(device: str) -> None:
    """Hand back what was freed, so that the reference finds the card empty."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
