"""Hand-written Hopper kernels for the fusion groups the evaluator prices.

Each kernel keeps a fusion group's intermediate tensors on chip (the GPU
analogue of the paper's on-chip SRAM); here the conv3x3 pre-pool frame
never reaches device memory.

``fused_conv`` holds the kernel's wrapper, build and launch geometry (the
CUDA source is ``csrc/fused_conv3x3.cu``), ``ref`` the plain PyTorch
version every kernel is held against, and ``ops`` the dispatch wrappers the
models call.  Nothing is compiled at import time: the kernel builds with
``nvcc`` on its first launch.
"""
