"""Device mesh construction and level-array sharding policy.

The replacement for the reference's MPI domain decomposition
(LoadBalance box->rank assignment, SetGrids.cpp:57,126): each dense AMR
level array is sharded over a 1-D device mesh along x (the slowest axis),
turning the reference's box-granular rank placement into slab partitioning
with XLA-inserted halo exchange. Levels too small to shard profitably are
replicated — the analogue of Chombo's implicit gather of coarse MG levels
onto few ranks.

For several hosts, call `distributed.initialize(...)` before building
the mesh (the MPI_Init replacement, Main_PoissonSolver.cpp:261-263).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mg_ic_code_tpu.grid.geometry import HierarchyGeom

AXIS = "x"
AXIS_Y = "y"
AXIS_Z = "z"
AXES = (AXIS, AXIS_Y, AXIS_Z)

# below this many cells per device along an axis, sharding a level costs
# more in halo latency than it saves in compute: replicate instead
MIN_LOCAL_NX = 8


def make_mesh(devices=None, shape: tuple[int, ...] | None = None) -> Mesh:
    """Device mesh: 1-D over x-slabs by default, 2-D (x, y) pencils or 3-D
    (x, y, z) blocks when `shape` has two or three entries (the
    counterpart of the reference's 3-D domainSplit box decomposition,
    SetGrids.cpp:54)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None or len(shape) == 1:
        return Mesh(devices, (AXIS,))
    assert len(shape) in (2, 3) and math.prod(shape) == devices.size
    return Mesh(devices.reshape(shape), AXES[: len(shape)])


def patch_axis(mesh: Mesh, nparts: int) -> str | None:
    """Mesh axis to shard a stacked sibling-patch axis over (the
    LoadBalance boxes->ranks role, SetGrids.cpp:57,126): prefer y (keeping
    x free for interior slab sharding); the axis size must divide the
    patch count so the NamedSharding is valid. None = no usable axis
    (patches stay replicated but still batch into one launch)."""
    for name in (AXIS_Y, AXIS):
        sz = mesh.shape.get(name, 1)
        if sz > 1 and nparts % sz == 0:
            return name
    return None


def level_spec(
    geom: HierarchyGeom, level: int, mesh: Mesh, min_local: int = MIN_LOCAL_NX
) -> P:
    """PartitionSpec for a level array: shard each mesh axis over the
    matching array axis when it divides evenly and leaves enough local
    cells; otherwise leave that axis replicated."""
    parts: list = [None, None, None]
    for array_axis, name in enumerate(AXES):
        ndev = mesh.shape.get(name, 1)
        n = geom.shape(level)[array_axis]
        if ndev > 1 and n % ndev == 0 and n // ndev >= min_local:
            parts[array_axis] = name
    return P(*parts)


def level_sharding(
    geom: HierarchyGeom, level: int, mesh: Mesh, min_local: int = MIN_LOCAL_NX
) -> NamedSharding:
    return NamedSharding(mesh, level_spec(geom, level, mesh, min_local))


def shard_level_list(
    u_list, geom: HierarchyGeom, mesh: Mesh, min_local: int = MIN_LOCAL_NX
):
    """device_put every level array with its sharding; jit then propagates
    these shardings through the whole solve (GSPMD inserts the halo
    collectives where stencil shifts cross shard boundaries)."""
    return [
        jax.device_put(u, level_sharding(geom, l, mesh, min_local))
        for l, u in enumerate(u_list)
    ]


def shard_fields(
    fields_list, geom: HierarchyGeom, mesh: Mesh, min_local: int = MIN_LOCAL_NX
):
    """Shard the static physics fields dict-per-level like the state."""
    out = []
    for l, fields in enumerate(fields_list):
        sh = level_sharding(geom, l, mesh, min_local)
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
        out.append(
            {
                k: ({kk: put(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else put(v))
                for k, v in fields.items()
            }
        )
    return out
