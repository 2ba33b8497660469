"""Config for jamba-v0.1-52b (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "jamba-v0.1-52b"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
