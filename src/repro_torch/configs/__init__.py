from repro_torch.configs.base import ArchConfig, get_arch, reduce_config, register

__all__ = ["ArchConfig", "get_arch", "reduce_config", "register"]
