"""Process groups for data-parallel training (port of
rspnet_tpu/parallel/mesh.py).

The JAX package drives every chip from one process through a device mesh.
The port runs one process per card, as the reference did (reference:
pretrain.py:278-283, framework/utils/distributed.py): ``--ws N`` starts N
ranks (``parallel/launch.py``), each binds ``cuda:LOCAL_RANK`` and joins
one ``torch.distributed`` group (NCCL on ``cuda``, gloo on ``cpu``). A
``Mesh`` names the groups a step needs: the world (cross-replica BN, the
gradient mean, the key gather, the metric mean) and, in the 2-D ``data x
model`` layout, this rank's model group (the K-sharded queue,
``moco/sharded_queue.py``). Rank ``r`` is the flat replica ``d * model +
m`` of the JAX 2-D mesh (mesh.py:61-78), so per-replica draws line up.

One process with no group is the single-card path: ``Mesh()`` has no
group, and no step takes a collective.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather_rows

logger = logging.getLogger(__name__)


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def init_distributed(device: str = "cpu") -> None:
    """Join the group that the environment describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``: what
    ``parallel/launch.py`` and ``torchrun`` set), the counterpart of
    ``JAX_COORDINATOR_ADDRESS`` at rspnet_tpu/parallel/mesh.py:19-39. On
    ``cuda`` the rank first binds ``cuda:LOCAL_RANK``. The backend is
    NCCL on ``cuda`` and gloo on ``cpu``. A world of one, or a group
    already up, is left as it is."""
    if dist.is_initialized() or _env_world() <= 1:
        return
    if device == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend="nccl" if device == "cuda" else "gloo",
        init_method="env://", world_size=_env_world(),
        rank=int(os.environ["RANK"]))
    logger.info("rank %d of %d (%s)", get_rank(), world_size(),
                dist.get_backend())


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """The groups of one layout. ``group`` holds every rank of the mesh;
    ``model_group`` this rank's ``model`` ranks ``d * model + [0, model)``
    (2-D only). Without a group (one process) no step takes a
    collective."""
    data: int = 1
    model: int = 1
    rank: int = 0
    group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def is_2d(self) -> bool:
        return self.model > 1

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def create_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the group's ranks; raises when the group does not
    have ``n_devices`` of them (a silently shrunk mesh would let a
    multi-card test pass on one, rspnet_tpu/parallel/mesh.py:42)."""
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"requested a {n_devices}-device mesh but {n} rank(s) run; "
            f"launch with --ws {n_devices}")
    if n == 1:
        return Mesh()
    return Mesh(data=n, rank=get_rank(), group=dist.group.WORLD)


def create_mesh_2d(data: int, model: int) -> Mesh:
    """2-D ``data x model`` mesh: rank ``d * model + m`` (row-major, the
    JAX mesh's flat order). Every rank creates every model group, in one
    order, as ``new_group`` requires."""
    n = data * model
    if world_size() != n:
        raise ValueError(
            f"requested a {data}x{model} mesh but {world_size()} rank(s) "
            f"run; launch with --ws {n}")
    rank = get_rank()
    mine = None
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if d == rank // model:
            mine = g
    return Mesh(data=data, model=model, rank=rank, group=dist.group.WORLD,
                model_group=mine)


def mesh_for_args(args) -> Mesh:
    """The 1-D data mesh over every rank (rspnet_tpu/parallel/mesh.py:82):
    the launcher already capped ``--ws`` at the cards (``launch.py``)."""
    return create_mesh(world_size())


def mesh_for_config(cfg, args) -> Mesh:
    """The mesh of the config's ``parallel`` block (mesh.py:92-137):
    ``parallel: {data: D, model: M}`` builds the 2-D mesh of the K-sharded
    queue (``data`` may be omitted: D = ranks / M); without the block, the
    1-D data mesh. Deviation: a mesh must use every rank (JAX leaves the
    devices past ``D * M`` idle; here each rank is a process that would
    wait in the first collective)."""
    model = int(cfg.get("parallel.model", 1) or 1)
    data = cfg.get("parallel.data", None)
    avail = world_size()
    ws = getattr(args, "world_size", None)
    if model <= 1:
        if data is not None:
            if int(data) > avail:
                raise ValueError(
                    f"parallel.data={data} exceeds the {avail} usable "
                    f"device(s) (--ws={ws})")
            return create_mesh(int(data))
        return mesh_for_args(args)
    if data is None:
        if avail % model:
            raise ValueError(
                f"parallel.model={model} does not divide the {avail} "
                f"available device(s); set parallel.data explicitly")
        data = avail // model
    if int(data) * model > avail:
        raise ValueError(
            f"parallel: {{data: {data}, model: {model}}} needs "
            f"{int(data) * model} devices but only {avail} are usable "
            f"(--ws={ws})")
    return create_mesh_2d(int(data), model)


def fetch_global(x, mesh: Mesh) -> np.ndarray:
    """The global array of a batch-sharded one, on every rank: rank r's
    rows at [r * B, (r + 1) * B) (mesh.py:168-176; every rank holds the
    same B). One process returns its own array."""
    if mesh.group is None:
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    if dist.get_backend(mesh.group) == "nccl":
        t = t.cuda()
    dtype = t.dtype
    if dtype == torch.bool:
        t = t.to(torch.uint8)
    return all_gather_rows(t, mesh.group).to(dtype).cpu().numpy()
