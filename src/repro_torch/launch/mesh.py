"""Mesh construction (port of ``repro.launch.mesh``).

Defined as FUNCTIONS (not module constants), so importing this module never
touches a device or a process group. Each returns a
:class:`torch.distributed.device_mesh.DeviceMesh` whose axes are named as the
JAX package's: ``data`` and ``model``, led by ``pod`` on a multi-pod mesh.
Ranks fill the mesh row-major, as ``jax.make_mesh`` lays devices out: rank
``r`` of a (data, model) mesh sits at ``(r // n_model, r % n_model)``.

The device and the backend are explicit. The backend defaults to ``nccl``
for a CUDA device and ``gloo`` for the CPU; a caller whose ranks share one
card passes ``backend="gloo"`` itself (NCCL refuses two ranks on one
device), and nothing switches on its own. The default process group is
started here from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) unless the caller started it already.

:class:`MeshShape` is a mesh's shape and axis names without devices or
ranks: the sharding rules (:mod:`repro_torch.parallel.sharding`) read only
that, so they run on any mesh size in one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names, without devices (``DeviceMesh``'s
    ``shape`` and ``mesh_dim_names``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _shape(n_data: int, n_model: int, pods: int):
    if pods:
        return (pods, n_data, n_model), ("pod", "data", "model")
    return (n_data, n_model), ("data", "model")


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape: (data=16, model=16), or (pod=2,
    data=16, model=16) across two pods (the pod axis the outer
    data-parallel axis)."""
    return MeshShape(*_shape(16, 16, 2 if multi_pod else 0))


def debug_shape(n_data: int = 2, n_model: int = 2, pods: int = 0
                ) -> MeshShape:
    return MeshShape(*_shape(n_data, n_model, pods))


def init_distributed(device: Union[str, torch.device],
                     backend: Optional[str] = None, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     store=None) -> str:
    """Start the default process group if it is not running; returns its
    backend. ``rank``/``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` (or a ``store``) to the ``env://``
    rendezvous of ``MASTER_ADDR``/``MASTER_PORT``."""
    import torch.distributed as dist

    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        return dist.get_backend()
    missing = [k for k, v in (("RANK", rank), ("WORLD_SIZE", world_size))
               if v is None and k not in os.environ]
    if missing or (init_method is None and store is None and any(
            k not in os.environ for k in ("MASTER_ADDR", "MASTER_PORT"))):
        raise RuntimeError(
            "a distributed run reads torchrun's environment (RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT): start it with torchrun, "
            "or set them")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl" and device.type == "cuda":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return backend


def _device_mesh(shape: MeshShape, device: Union[str, torch.device],
                 backend: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    init_distributed(device, backend)
    if dist.get_world_size() != shape.size:
        raise ValueError(f"a {shape.shape} mesh needs {shape.size} ranks, "
                         f"the process group has {dist.get_world_size()}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ranks = torch.arange(shape.size).reshape(shape.shape)
    return DeviceMesh(device.type, ranks, mesh_dim_names=shape.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda",
                         backend: Optional[str] = None):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the pod axis is the outer
    data-parallel (inter-pod network) axis."""
    return _device_mesh(production_shape(multi_pod=multi_pod), device,
                        backend)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0, *,
                    device: Union[str, torch.device] = "cuda",
                    backend: Optional[str] = None):
    """A small mesh for tests and one-host runs (a handful of ranks)."""
    return _device_mesh(debug_shape(n_data, n_model, pods), device, backend)
