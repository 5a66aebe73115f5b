"""Process-group start-up and mesh construction (port of
``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches
no process-group state.  Single pod: 16 x 16 = 256 ranks (data, model).
Multi-pod: 2 x 16 x 16 = 512 (pod, data, model), the ``pod`` axis pure
data parallelism.  Under ``torchrun`` one rank drives one card:

    torchrun --nproc-per-node 4 my_script.py   # calls init_distributed()
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import DATA, MODEL, POD


def init_distributed(device=None) -> torch.device:
    """Start the default process group from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``LOCAL_RANK`` picks the card): ``nccl`` on the card, the default, or
    ``gloo`` when ``device="cpu"``.  The counterpart of the reference's
    implicit ``jax.distributed`` start-up.  Returns this rank's device."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass device='cpu' for gloo)")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device


def _mesh(shape, names) -> DeviceMesh:
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over the initialized process group: (16, 16)
    as (data, model), or (2, 16, 16) as (pod, data, model); raises
    ``ValueError`` when the world size differs."""
    if multi_pod:
        return _mesh((2, 16, 16), (POD, DATA, MODEL))
    return _mesh((16, 16), (DATA, MODEL))


def make_host_mesh() -> DeviceMesh:
    """Whatever ranks exist: (data=1, model=world)."""
    return _mesh((1, dist.get_world_size()), (DATA, MODEL))
