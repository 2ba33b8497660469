"""Config for yi-34b (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "yi-34b"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
