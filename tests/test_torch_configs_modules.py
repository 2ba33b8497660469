"""The port's ten per-arch config modules (``repro_torch.configs.<arch>``)
against the registry and against the JAX package's modules: each
``config()`` equals ``get_config(ARCH_ID)``, field by field equals the
reference module's ``config()``, and passes an override through."""
import dataclasses
import importlib

import pytest

from _jax_caches import cleared_jax_caches  # noqa: F401  (autouse)
from repro_torch.configs import get_config, list_archs

MODULES = ["qwen2_5_3b", "qwen2_moe_a2_7b", "jamba_v0_1_52b", "xlstm_1_3b", "whisper_tiny",
           "internvl2_1b", "starcoder2_3b", "codeqwen1_5_7b", "yi_34b", "grok_1_314b"]


def test_one_module_per_registered_arch():
    ids = {importlib.import_module(f"repro_torch.configs.{m}").ARCH_ID for m in MODULES}
    assert ids == set(list_archs())


@pytest.mark.parametrize("name", MODULES)
def test_module_config_equals_the_registry_and_the_reference(name):
    port = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    assert port.ARCH_ID == ref.ARCH_ID
    assert port.config() == get_config(port.ARCH_ID)
    assert dataclasses.asdict(port.config()) == dataclasses.asdict(ref.config())
    over = dict(n_layers=2 * len(port.config().block_pattern), param_dtype="bfloat16")
    got = port.config(**over)
    assert (got.n_layers, got.param_dtype) == (over["n_layers"], "bfloat16")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref.config(**over))
