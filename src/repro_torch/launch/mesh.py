"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions only, never module-level meshes: importing this module touches
no process group and no device.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices behind it: what the
    rule table (dist/sharding.py) reads, for meshes larger than the
    machine (the production shapes)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's 16x16 single pod or 2x16x16 two-pod mesh, as axis
    names and sizes.

    Axis roles: 'pod' — data-parallel across pods; 'data' — data parallel /
    ZeRO / FSDP axis; 'model' — tensor parallel."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh(n_data: int = 2, n_model: int = 2, *, device=None):
    """A ``DeviceMesh`` of shape (n_data, n_model) with axes ('data',
    'model') over the current process group (``torch.distributed`` must be
    up, with ``n_data * n_model`` ranks), on the CUDA cards unless
    ``device`` names the CPU."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    kind = torch.device(device).type if device is not None else "cuda"
    return init_device_mesh(kind, (n_data, n_model), mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    """The composite data-parallel axes of a mesh (pod folds into data)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))


def host_mesh(device):
    """The launchers' ``--mesh host``: a ('data', 'model') mesh of shape
    (W // nm, nm), nm = 2 when the world size W is even (the reference's
    layout), over the process group.  With no group up, one is started
    from the ``torch.distributed`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card):
    NCCL on the card, gloo on the CPU.  None on one rank."""
    import torch
    import torch.distributed as dist
    device = torch.device(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) < 2:
            return None
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    world = dist.get_world_size()
    if world < 2:
        return None
    nm = 2 if world % 2 == 0 else 1
    return make_host_mesh(world // nm, nm, device=device)
