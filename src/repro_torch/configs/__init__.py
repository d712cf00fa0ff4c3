from repro_torch.configs.base import ArchConfig, get, get_smoke

__all__ = ["ArchConfig", "get", "get_smoke"]
