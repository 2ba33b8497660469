"""Config for whisper-tiny (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "whisper-tiny"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
