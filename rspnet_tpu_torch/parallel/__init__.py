"""Distributed runtime of the port: process groups, the mesh of a layout,
the collectives of the steps and the ``--ws`` launcher (port of
rspnet_tpu/parallel/)."""
from .collectives import (all_gather_rows, all_reduce_mean, all_reduce_sum,
                          broadcast_, combine_grads)
from .launch import launch, spawn
from .mesh import (Mesh, barrier, create_mesh, create_mesh_2d, fetch_global,
                   fetch_scalar, get_rank, init_distributed, local_rank,
                   mesh_for_args, mesh_for_config, time_enqueued,
                   world_size)

__all__ = ["Mesh", "all_gather_rows", "all_reduce_mean", "all_reduce_sum",
           "barrier", "broadcast_", "combine_grads", "create_mesh",
           "create_mesh_2d", "fetch_global", "fetch_scalar", "get_rank",
           "init_distributed", "launch", "local_rank", "mesh_for_args",
           "mesh_for_config", "spawn", "time_enqueued", "world_size"]
