"""Process mesh and data layouts for the multi-device routes.

Mesh axes:
  "batch"  data-parallel over independent LP instances (config 5)
  "row"    the large dimension of each LP: the columns of A for the
           normal-matrix assembly, row panels of the normal matrix for the
           distributed factor (``linsys/schur.py``; config 4, and config 5
           with row > 1)

One process drives one device.  Ranks join through
:func:`init_distributed` (``torch.distributed`` over TCP: NCCL between
GPUs, gloo between CPU processes), after which :func:`make_mesh` lays the
ranks out as a (batch, row) grid.  Without a process group the mesh is the
one process itself.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
ROW_AXIS = "row"

# every collective of a process group fails after this long instead of
# waiting for a rank that will never come
TIMEOUT = datetime.timedelta(seconds=120)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (batch, row) grid of ranks.  ``shape`` and ``coords`` map an axis
    name to its size and to this rank's index along it; ``groups`` maps it
    to the process group of the ranks that share this rank's other
    coordinate (None in a one-process mesh, where no collective runs)."""
    shape: dict
    coords: dict
    groups: dict


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join ``num_processes`` processes into one process group.

    A no-op for one process.  ``coordinator_address`` is ``host:port`` (or
    a ``tcp://`` URL) of rank 0; None reads ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment.  The backend is NCCL when this
    process sees a GPU (it then drives GPU ``process_id`` modulo the count)
    and gloo otherwise.  Every collective of the group gives up after
    ``timeout``.
    """
    if num_processes is None or num_processes <= 1:
        return
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    else:
        backend = "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def make_mesh(batch: int = 1, row: int = 1) -> Mesh:
    """A (batch, row) mesh over every rank of the default process group, or
    the one-process mesh when there is no group.  ``batch * row`` must be the
    number of ranks; fewer ranks than that raise ``ValueError``, as ``ipx``
    raises for too few devices."""
    need = batch * row
    if not (dist.is_available() and dist.is_initialized()):
        if need != 1:
            raise ValueError(f"need {need} ranks for mesh ({batch}x{row}), "
                             "have 1 (no process group)")
        return Mesh(shape={BATCH_AXIS: 1, ROW_AXIS: 1},
                    coords={BATCH_AXIS: 0, ROW_AXIS: 0},
                    groups={BATCH_AXIS: None, ROW_AXIS: None})
    world = dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} ranks for mesh ({batch}x{row}), "
                         f"have {world}")
    if world != need:
        raise ValueError(f"a mesh spans every rank: {batch}x{row} = {need} "
                         f"of {world}")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (batch, row),
                          mesh_dim_names=(BATCH_AXIS, ROW_AXIS))
    axes = (BATCH_AXIS, ROW_AXIS)
    return Mesh(shape={BATCH_AXIS: batch, ROW_AXIS: row},
                coords={a: dm.get_local_rank(a) for a in axes},
                groups={a: dm.get_group(a) for a in axes})


def large_lp_sharding(mesh: Mesh, n: int) -> dict:
    """What this rank holds of one large LP (config 4), as an index per
    field: A's column block over ROW_AXIS; c, b and the offset whole.  ``ipx``
    shards c (and the iterates x and s) with A's columns; here every
    n-vector is replicated, so that every rank runs the same elementwise
    work and reaches the same scalars bit for bit."""
    p = mesh.shape[ROW_AXIS]
    nl = n // p
    lo = mesh.coords[ROW_AXIS] * nl
    return dict(c=slice(None), A=(slice(None), slice(lo, lo + nl)),
                b=slice(None), obj_offset=())


def batch_lp_sharding(mesh: Mesh, batch: int, n: Optional[int] = None
                      ) -> dict:
    """What this rank holds of a batch of LPs (config 5), as an index per
    field: its share of the instances over BATCH_AXIS; with a "row" axis
    of p > 1, each A's column block over ROW_AXIS as
    :func:`large_lp_sharding` gives it (c, b and the offset whole per lane),
    which ``solve_batch(share, mesh=mesh)`` solves on the sharded Schur
    route.  ``ipx`` places each A's rows on ROW_AXIS instead, a placement
    hint to GSPMD; here A is constant over a solve and every n-vector whole
    on every rank, so the ranks of a row group hold columns and agree bit
    for bit.  ``n`` (A's columns) is needed when p > 1."""
    q = mesh.shape[BATCH_AXIS]
    if batch % q:
        raise ValueError(f"batch {batch} is not divisible by the mesh's "
                         f"{q} batch shards")
    lo = mesh.coords[BATCH_AXIS] * (batch // q)
    lanes = slice(lo, lo + batch // q)
    A = lanes
    p = mesh.shape[ROW_AXIS]
    if p > 1:
        if n is None or n % p:
            raise ValueError(f"n={n} is not divisible by the mesh's {p} row "
                             "shards")
        A = (lanes,) + large_lp_sharding(mesh, n)["A"]
    return dict(c=lanes, A=A, b=lanes, obj_offset=lanes)
