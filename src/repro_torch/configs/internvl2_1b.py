"""Config for internvl2-1b (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "internvl2-1b"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
