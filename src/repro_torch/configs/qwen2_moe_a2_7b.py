"""Config for qwen2-moe-a2.7b (see all_archs.py for the authoritative numbers)."""
from repro_torch.configs.base import get_config

ARCH_ID = "qwen2-moe-a2.7b"


def config(**overrides):
    return get_config(ARCH_ID, **overrides)
