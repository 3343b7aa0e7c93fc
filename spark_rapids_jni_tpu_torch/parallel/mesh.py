"""The (data, model) device mesh over ``torch.distributed`` (PyTorch port of
``parallel/mesh.py``).

- ``data``: partition parallelism; each rank owns a slice of a batch's rows.
- ``model``: sharded auxiliary structures, such as a bloom filter's bits.

The caller initialises the process group (NCCL for the card, gloo for the
CPU) and :func:`make_mesh` lays the ranks out as the JAX package lays out its
devices: rank ``d * mp + m`` sits at data index ``d`` and model index ``m``,
rows are sharded over ``data`` and replicated over ``model``.  There is no
``shard_map``: each rank runs the body once, on its own shard, and the
collectives run over the groups of :func:`axis_group`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from spark_rapids_jni_tpu_torch import device as _device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape: Optional[Tuple[int, int]] = None, *,
              device: _device.DeviceLike = None) -> DeviceMesh:
    """A 2-D (data, model) mesh over every rank of the initialised process
    group, on the card unless ``device="cpu"``.  With no ``shape``, all ranks
    go on ``data``: (world, 1).  Raises when no group is initialised, when the
    shape does not cover the world, when the group's backend is not the
    device's (NCCL for the card, gloo for the CPU), or, on the card, when
    ``LOCAL_RANK`` is set and the current CUDA device is another card: the
    caller pins each rank to its card (``torch.cuda.set_device``) first."""
    dev = _device.resolve(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group is "
                           "initialised; call init_process_group first")
    world = dist.get_world_size()
    dp, mp = (world, 1) if shape is None else shape
    if dp * mp != world:
        raise ValueError(f"mesh shape {(dp, mp)} != world size {world}")
    check_mesh_device(dev)
    return init_device_mesh(dev.type, (dp, mp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh_device(dev: torch.device) -> None:
    """Raise unless the initialised group's backend is ``dev``'s (NCCL for the
    card, gloo for the CPU) and, on the card with ``LOCAL_RANK`` set, the
    current CUDA device is that card."""
    backend = str(dist.get_backend())
    if _BACKEND.get(dev.type) != backend:
        raise RuntimeError(f"make_mesh: a {dev.type} mesh needs the "
                           f"{_BACKEND.get(dev.type)} backend, the group runs {backend}")
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and local_rank is not None \
            and torch.cuda.current_device() != int(local_rank):
        raise RuntimeError(f"make_mesh: LOCAL_RANK is {local_rank} but the current CUDA "
                           f"device is cuda:{torch.cuda.current_device()}; call "
                           f"torch.cuda.set_device({local_rank}) first")


@contextlib.contextmanager
def one_rank_mesh(device: _device.DeviceLike = None) -> Iterator[DeviceMesh]:
    """A (1, 1) mesh over a one-rank process group made here (a FileStore in
    a temporary directory, no ports) and taken down on exit: NCCL on the
    card (the current CUDA device, bootstrapped on loopback), gloo on the
    CPU.  No group may be initialised already."""
    dev = _device.resolve(device)
    if dist.is_initialized():
        raise RuntimeError("one_rank_mesh makes its own one-rank process group: "
                           "call it with none initialised")
    if dev.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(_BACKEND[dev.type],
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield make_mesh((1, 1), device=dev)
        finally:
            dist.destroy_process_group()


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along axis ``name``."""
    return mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh, name: str) -> dist.ProcessGroup:
    """The group of the ranks that share this rank's other coordinate: the
    ranks a collective over axis ``name`` spans.  A collective over both axes
    spans the whole group that :func:`make_mesh` was built over."""
    return mesh.get_group(name)

