"""Hand-written CUDA kernels for Hopper (``csrc/``), one package per kernel.

masked_matmul    — the paper's FAP operator: GEMM with the periodic fault
                   mask applied on chip
flash_attention  — blocked online-softmax attention (causal/SWA/GQA)

Each package's ``ops.py`` holds the wrapper (kernel on CUDA tensors, launch
count), the plain PyTorch version (CPU tensors, and the reference the card's
parity checks hold the kernel to) and a note on the TPU kernel it replaces.
``common.py`` builds the sources with nvcc and holds the tolerance table.
"""
