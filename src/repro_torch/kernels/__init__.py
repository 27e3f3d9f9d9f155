"""Hand-written Hopper kernels for the fusion groups the evaluator prices.

Each kernel keeps a fusion group's intermediate tensors on chip (the GPU
analogue of the paper's on-chip SRAM): the conv3x3 pre-pool frame
(``fused_conv``, K1), attention's score frame (``fused_attention``, K2),
the MLP's hidden frame (``fused_mlp``, K3) and the SSM's state sequence
(``mamba_scan``, K4) never reach device memory.

Each of those modules holds its kernel's wrapper, sizing and launch (the
CUDA sources are under ``csrc/``); ``builder`` compiles them, ``ref`` holds
the plain PyTorch version every kernel is held against, and ``ops`` the
dispatch wrappers the models call (``ops.KERNELS`` / ``ops.PLAIN``, the
fusion groups a model runs through).  Nothing is compiled at import time: a
kernel builds with ``nvcc`` on its first launch.
"""
