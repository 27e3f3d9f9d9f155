"""PyTorch/CUDA port of the pre-RTL DNN hardware evaluator.

A second package beside the JAX reference (``repro``), mirroring its
relative module paths so each counterpart is easy to find:

* ``core``    — the layer/graph IR, Eq. (1)-(4) (scalar oracles and the
  batched float64 sweep, run as torch tensor code on the device), the
  chain fusion search and the hardware x grouping flow;
* ``kernels`` — the fused conv3x3 + bias + ReLU (+ 2x2 max-pool) group as a
  hand-written CUDA kernel for Hopper (``sm_90a``), its plain PyTorch
  version, and the dispatch wrappers;
* ``models``  — VGG-16, whose forward runs through the fused kernel.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of silently falling back.
The package imports ``torch`` and ``numpy`` only — never JAX, never
``repro``.
"""
