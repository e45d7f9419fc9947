"""Hand-written CUDA kernels for Hopper (``csrc/``), one package per kernel.

masked_matmul    — the paper's FAP operator: GEMM with the periodic fault
                   mask applied on chip
flash_attention  — blocked online-softmax attention (causal/SWA/GQA)
mamba_scan       — the Mamba-1 selective scan (prefill and forward of the
                   ssm and hybrid families)
decode_attention — one-token attention over an int8 KV cache, dense and
                   paged (the kernel autotuner's path)

Each package's ``ops.py`` holds the wrapper (kernel on CUDA tensors, launch
count), the plain PyTorch version (CPU tensors, and the reference the card's
parity checks hold the kernel to) and a note on the TPU kernel it replaces.
``common.py`` builds the sources with nvcc, holds the tolerance table and
the card's shared-memory limit, and is the ``tuned_block`` seam to the
tuning cache (``repro_torch.tune``).
"""
