"""PyTorch/CUDA port of the pre-RTL DNN hardware evaluator.

A second package beside the JAX reference (``repro``), mirroring its
relative module paths so each counterpart is easy to find:

* ``core``    — the layer/graph IR, Eq. (1)-(4) (scalar oracles and the
  batched float64 sweep, run as torch tensor code on the device), the
  chain fusion search, the hardware x grouping flow and the kernel planner;
* ``configs`` — the model registry (a copy of the reference's);
* ``kernels`` — hand-written CUDA kernels for Hopper (``sm_90a``): the
  fused conv3x3 + bias + ReLU (+ 2x2 max-pool) group, flash attention and
  the fused MLP, their plain PyTorch versions, and the dispatch wrappers;
* ``models``  — VGG-16 and the decoder-only transformers, whose fusion
  groups run through those kernels;
* ``runtime``, ``launch`` — the prefill/decode steps and the serving entry
  point (``python -m repro_torch.launch.serve``).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA they raise instead of silently falling back.
The package imports ``torch`` and ``numpy`` only — never JAX, never
``repro``.
"""
