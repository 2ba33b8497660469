"""Architecture configurations: a copy of the JAX package's registry."""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, get_config, list_archs, shape_applicable  # noqa: F401
from repro_torch.configs.all_archs import smoke_config  # noqa: F401
