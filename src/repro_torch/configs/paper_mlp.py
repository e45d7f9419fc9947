"""paper-mlp — the paper-faithful classifier used for the eFAT
resilience/grouping experiments (stands in for VGG11-CIFAR10 etc., which need
offline datasets; the eFAT machinery is identical).

A small MLP classifier whose hidden matmuls run through the systolic
fault-mapping, trained on a synthetic cluster-classification task where
steps-to-accuracy is measurable in seconds.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="paper-mlp",
        family="classifier",
        num_layers=4,
        d_model=128,  # input dim = d_model // 4
        d_ff=48,  # narrow+deep => fault-fragile like the paper's Fig. 2 regime
        vocab_size=16,  # num classes
        array_rows=32,
        array_cols=32,
        dtype="float32",
        param_dtype="float32",
        activation="gelu",
        source="paper SIV (VGG11/ResNet18/MobileNetV2 stand-in)",
    )
)
