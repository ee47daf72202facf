"""Async trajectory dump runtime: overlap device compute with host I/O.

The reference has no equivalent - its host simulation blocks in
``MPI_File_write_at`` every chunk (reference: pgsd/pgsd/pgsd.c:2225-2237).
On an accelerator the step dispatch is asynchronous, so the dump pipeline is:

    device:   step N          | step N+1            | ...
    host:     D2H frame N-1   | D2H frame N         | ...
    writer:   pwrite frame N-2| pwrite frame N-1    | ...

``jax.Array`` values are immutable, so holding a reference to frame N-1
while step N runs is race-free by construction - no donated-buffer
hazard, no explicit double buffer.
"""

from .dump import AsyncDumpRunner, DumpStats, run_dump_loop
from .jit_dump import JitDumpChannel, scan_simulate, scan_simulate_adaptive
from .slab_dump import SlabDumpChannel

__all__ = [
    "AsyncDumpRunner",
    "DumpStats",
    "JitDumpChannel",
    "SlabDumpChannel",
    "run_dump_loop",
    "scan_simulate",
    "scan_simulate_adaptive",
]
