"""Sharded trajectory I/O for JAX arrays over device meshes.

The JAX replacement for the reference's MPI-rank parallelism
(reference: pgsd/pgsd/pgsd.c MPI_File_* + MPI_Allgather offset protocol):

* devices replace ranks: a ``jax.Array`` sharded over axis 0 carries its
  own partition map; per-shard file offsets come from the sharding, so the
  ``MPI_Allgather`` of sizes (reference: pgsd/pgsd/pgsd.c:1121-1152) becomes
  a lookup - and for dynamic sizes, ``jax.lax.all_gather``.
* one controller process commits metadata (index/namelist/header),
  replacing rank-0 logic (reference: pgsd/pgsd/pgsd.c:1531-1607).
* every host pwrites only its addressable shards at disjoint offsets into
  the shared file - the role of ``MPI_File_write_at``.

JAX is imported lazily so the core file layers stay importable without it.
"""

from .shard_io import (  # noqa: F401
    ShardedFrameWriter,
    ShardedTrajectoryReader,
    array_shards,
    read_sharded_chunk,
    write_sharded_chunk,
)
from .comm import JaxProcessComm, SingleComm, default_comm  # noqa: F401
from .fs import direct_write_policy, filesystem_kind  # noqa: F401
from .compose_io import ComposedFrameWriter, compose  # noqa: F401
from .mesh import (  # noqa: F401
    make_mesh,
    make_mesh2d,
    make_mesh3d,
    pad_rows,
    row_sharding,
    shard_rows,
)
