"""Config for grok-1-314b (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "grok-1-314b"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
