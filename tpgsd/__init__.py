"""tpgsd - parallel GSD trajectory I/O for JAX device arrays.

A ground-up rebuild of the capabilities of PGSD (an MPI-parallel fork of the
Glotzer Group's GSD library for SPH trajectory output) designed for
single-controller JAX accelerator systems:

* ``tpgsd.format``  - bit-exact GSD v1/v2 on-disk codec (numpy structured
  dtypes; no JAX dependency).
* ``tpgsd.fl``      - full read/write file layer (modes w/r/r+/x/a, chunk
  write buffering, index growth, crash-consistent commit ordering).
* ``tpgsd.pypgsd``  - pure-Python read-only file layer over any file-like
  object (drop-in interchangeable with ``tpgsd.fl`` for reads).
* ``tpgsd.hoomd``   - HOOMD schema layer with SPH extension fields and a
  *working* parallel ``append()``.
* ``tpgsd.parallel`` - sharded writer/reader: per-device particle partitions
  of ``jax.Array`` objects stream to precomputed file offsets; offsets derive
  from an all-gather of per-shard sizes over the device interconnect (the
  equivalent of the reference's ``MPI_Allgather`` offset protocol,
  reference: pgsd/pgsd/pgsd.c:1108-1201).
* ``tpgsd.sph``     - JAX/Pallas SPH stepper (cell-list neighbor search,
  kernel-weighted density, Tait EOS, symplectic integrator) as the live
  frame producer.
* ``tpgsd.io_runtime`` - double-buffered async dump overlapping device
  compute with host file writes.

The core file layers (format/fl/pypgsd/hoomd) import only numpy so they run
anywhere; JAX is imported only by the parallel/sph/io_runtime subpackages.
"""

import signal
import sys

from .version import version  # noqa: F401

__version__ = version


def _sigterm_handler(signum, frame):
    # Exit cleanly on SIGTERM so open files flush their buffers
    # (reference behavior: pgsd/pgsd/__init__.py:23-26).
    sys.exit(1)


try:
    signal.signal(signal.SIGTERM, _sigterm_handler)
except ValueError:
    # Not in the main thread of the main interpreter; skip installing the
    # handler (e.g. when imported from a worker thread).
    pass
