from repro_torch.configs.base import FRONTEND_DIMS, ArchConfig, get_arch, list_archs, reduce_config, register

__all__ = ["ArchConfig", "FRONTEND_DIMS", "get_arch", "list_archs", "reduce_config", "register"]
