"""Multi-host runtime: process-group init and a host-aware mesh (PyTorch port
of ``parallel/multihost.py``).

The JAX package joins the JAX distributed runtime, after which
``jax.devices()`` spans every host and the same ``shard_map`` programs run
across them.  The port's counterpart is ``torch.distributed``: every rank
process calls :func:`initialize` once, after which the default process group
spans every rank of the job, and the same per-rank programs (shuffles, query
steps, plans) run over a mesh of them.  NCCL takes one rank per card, so a
rank is a process and a card; on the CPU the ranks run gloo.

A launcher starts the ranks and tells each where it is::

    torchrun --nproc_per_node 4 -m spark_rapids_jni_tpu_torch.models.nds_harness --sf 10

``torchrun`` and Slurm set ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize` with no arguments
reads them.  Explicit arguments (a ``host:port`` coordinator, the number of
processes and this one's id) serve launches without a launcher, and tests.

Mesh layout decides which links the collectives ride: :func:`make_pod_mesh`
puts hosts outermost on ``data`` (the torch counterpart of
``create_hybrid_device_mesh``), so a host's ranks hold neighbouring data
indices and no ``model`` group straddles two hosts.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, check_mesh_device

__all__ = ["initialize", "is_multihost", "make_pod_mesh", "process_summary"]

#: seconds a rendezvous waits for every rank before :func:`initialize` raises
INIT_TIMEOUT_S = 600.0

_initialized = False
# (node, local rank) of every rank of the group :func:`initialize` made, in
# rank order; None until then
_layout: Optional[List[Tuple[tuple, int]]] = None

# env markers of a multi-process launch: they decide whether a group of the
# wrong size is fatal or benign (WORLD_SIZE > 1, and RANK with MASTER_ADDR,
# count too)
_CLUSTER_ENV_MARKERS = (
    "TORCHELASTIC_RUN_ID",
    "SLURM_JOB_ID",
    "OMPI_MCA_orte_hnp_uri",
)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def _cluster_env_present() -> bool:
    """True when the environment names a launch: a torch launcher's marker,
    Slurm, OpenMPI, ``WORLD_SIZE`` above 1, or a rank and its rendezvous
    (``RANK`` and ``MASTER_ADDR``, as a launcher of one rank sets them)."""
    if any(m in os.environ for m in _CLUSTER_ENV_MARKERS):
        return True
    if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        return True
    return (_env_int("WORLD_SIZE") or 1) > 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: _device.DeviceLike = None,
) -> None:
    """Join the job's process group (idempotent): NCCL on the card, pinned
    first to the card ``LOCAL_RANK`` names; gloo with ``device="cpu"``.

    With no arguments it reads a launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    explicit arguments map to a ``tcp://coordinator_address`` rendezvous.
    With neither a cluster environment nor arguments -- the plain
    single-process case -- it is a no-op and is not latched, so a later
    explicit call works.  A group already up with the expected world size
    is accepted.  It raises when a group of another size is up while a
    cluster environment or explicit arguments are present, and when the
    rendezvous of more than one rank fails within :data:`INIT_TIMEOUT_S`:
    it never degrades silently to per-host partial results.
    """
    global _initialized, _layout
    if _initialized and dist.is_initialized():
        return
    explicit = any(a is not None for a in
                   (coordinator_address, num_processes, process_id))
    cluster = explicit or _cluster_env_present()
    world = num_processes if num_processes is not None else (_env_int("WORLD_SIZE") or 1)
    if dist.is_initialized():
        have = dist.get_world_size()
        if cluster and have != world:
            raise RuntimeError(
                f"initialize: a process group of {have} ranks is already up, "
                f"but this launch asks for {world}")
        return  # the caller's group: accepted, not latched
    if not cluster:
        return  # single process: not latched
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if rank is None or coordinator_address is None:
        if world > 1 or explicit:
            raise ValueError(
                f"initialize: a launch of {world} ranks needs RANK and "
                "MASTER_ADDR/MASTER_PORT (or explicit arguments)")
        return  # a one-process job under a scheduler: nothing to join
    dev = _device.resolve(device)
    local_rank = _env_int("LOCAL_RANK")
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = rank % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    # the launcher's store when it hosts one (torchrun), else a TCPStore on
    # the coordinator that waits for every rank within the timeout
    url = "env://" if not explicit and os.environ.get(
        "TORCHELASTIC_USE_AGENT_STORE") == "True" else f"tcp://{coordinator_address}"
    store, rank, world = next(dist.rendezvous(url, rank=rank, world_size=world,
                                              timeout=timeout))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world, timeout=timeout)
    _layout = _gather_layout()
    _initialized = True


def _node_key() -> tuple:
    """This rank's node: ``GROUP_RANK`` where a launcher sets it, else the
    host name."""
    group = _env_int("GROUP_RANK")
    return ("group", group) if group is not None else ("host", socket.gethostname())


def _gather_layout() -> List[Tuple[tuple, int]]:
    """(node, local rank) of every rank of the default group, in rank order,
    from one all-gather.  A rank without ``LOCAL_RANK`` takes its place among
    its node's ranks by global rank."""
    world = dist.get_world_size()
    got: List = [None] * world
    dist.all_gather_object(got, (_node_key(), _env_int("LOCAL_RANK")))
    layout, seen = [], {}
    for node, local in got:
        layout.append((node, seen.get(node, 0) if local is None else local))
        seen[node] = seen.get(node, 0) + 1
    by_node = {}
    for r, (node, local) in enumerate(layout):
        if local in by_node.setdefault(node, {}):
            raise RuntimeError(f"ranks {by_node[node][local]} and {r} share local rank "
                               f"{local} on node {node[1]!r}")
        by_node[node][local] = r
    return layout


def is_multihost() -> bool:
    """True when the process group spans more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_pod_mesh(
    mp: int = 1,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    *,
    device: _device.DeviceLike = None,
) -> DeviceMesh:
    """A (data, model) mesh over every rank of the process group, hosts
    outermost on ``data``: ranks ordered by node (``GROUP_RANK`` where a
    launcher sets it, else the host name in the order of its lowest rank),
    then by ``LOCAL_RANK``, laid out row by row.  A host's ranks hold
    neighbouring data indices and each ``model`` group lies within one host,
    so ``mp`` must divide every host's rank count as well as the world.

    A rank's data index is its place in its data group, which torch numbers
    by global rank: it equals the mesh coordinate wherever the launcher
    numbers ranks host by host (torchrun, Slurm).  Which ranks share a group
    is the layout's either way.

    Collective over the default group (one all-gather of each rank's node).
    Raises as ``make_mesh`` does with no group initialised; a single-process
    caller keeps ``one_rank_mesh``."""
    dev = _device.resolve(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_pod_mesh: no torch.distributed process group is "
                           "initialised; call initialize (or init_process_group) first")
    world = dist.get_world_size()
    if mp < 1 or world % mp:
        raise ValueError(f"model parallelism {mp} does not divide {world} devices")
    check_mesh_device(dev)
    layout = _gather_layout()
    nodes = {}
    for r, (node, local) in enumerate(layout):
        nodes.setdefault(node, []).append((local, r))
    if all(kind == "group" for kind, _ in nodes):
        order = sorted(nodes)
    else:
        order = sorted(nodes, key=lambda n: min(r for _, r in nodes[n]))
    ranks: List[int] = []
    for node in order:
        members = sorted(nodes[node])
        if len(members) % mp:
            raise ValueError(f"model parallelism {mp} does not divide the {len(members)} "
                             f"ranks of node {node[1]!r}: a model group would straddle hosts")
        ranks.extend(r for _, r in members)
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(world // mp, mp)
    return DeviceMesh(dev.type, mesh, mesh_dim_names=tuple(axis_names))


def process_summary() -> dict:
    """Small diagnostic dict (for logs and the harness's header), with the
    JAX package's keys.  One departure: ``local_devices`` counts the ranks on
    this node (NCCL takes one card per rank), from the launcher's
    ``LOCAL_WORLD_SIZE``, else from the layout :func:`initialize` gathered,
    else 1; ``global_devices`` is the world size."""
    up = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if up else 0
    world = dist.get_world_size() if up else 1
    local = _env_int("LOCAL_WORLD_SIZE")
    if local is None:
        if up and _layout is not None and len(_layout) == world:
            node = _layout[rank][0]
            local = sum(1 for n, _ in _layout if n == node)
        else:
            local = 1
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": local,
        "global_devices": world,
    }
