"""Production mesh construction, and the hardware constants of one NVIDIA
H100 SXM (the roofline denominators), from NVIDIA's data sheet: dense
rates without sparsity, at the full 700 W power limit.

The factories are functions, so importing this module touches no process
group.  A mesh spans the process group of the job, which the caller
initialises first (``torchrun`` sets its rank and size; the dry run uses a
``fake`` group of 256 or 512 ranks); a world of the wrong size raises, as
``jax.make_mesh`` does for the wrong device count.
"""
from __future__ import annotations

import math

PEAK_FLOPS_BF16 = 989e12          # per card, bf16 on the tensor cores (dense)
HBM_BW = 3.35e12                  # bytes/s per card, HBM3
# NVLink 4 between the cards of a host: 900 GB/s per card both ways, 450
# GB/s each way.  It plays the part of the reference's per-link ICI rate.
NVLINK_BW = 450e9                 # bytes/s per card, one direction


def _make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
               device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first (e.g. under torchrun)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh {names} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, data: int | None = None,
                   device_type: str = "cuda"):
    """A ("data", "model") mesh over the whole process group (tests, one
    host); ``data`` defaults to the world size over ``model``."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data or n // model
    return _make_mesh((data, model), ("data", "model"), device_type)
