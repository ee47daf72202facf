"""Host-process communicators for multi-host coordination.

The file layer (``tpgsd.fl``) takes a communicator with this small
interface; ``SingleComm`` covers the single-controller case (one process,
any number of devices), ``JaxProcessComm`` covers multi-host JAX
(``jax.distributed``) where every process owns a slice of the devices and
writes its own shards - the structural equivalent of the reference's MPI
ranks (reference: pgsd/pgsd/pgsd.c:106-172 Bcast helpers and
pgsd.c:1121-1152 Allgather offset protocol).
"""


class SingleComm:
    """Single-process communicator: every collective is the identity."""

    rank = 0
    size = 1

    def allgather(self, value):
        return [value]

    def bcast(self, value, root=0):
        return value

    def barrier(self):
        pass

    def allreduce_sum(self, value):
        return value

    def allreduce_max(self, value):
        return value


class JaxProcessComm:
    """Multi-host communicator over JAX collectives.

    Uses ``jax.experimental.multihost_utils``; requires
    ``jax.distributed.initialize()`` to have been called.  Values must be
    small scalars/objects - this path carries metadata only, the data bytes
    go straight from each host to the file.
    """

    def __init__(self):
        import jax

        self._jax = jax
        self.rank = jax.process_index()
        self.size = jax.process_count()

    def allgather(self, value):
        import numpy
        from jax.experimental import multihost_utils

        arr = multihost_utils.process_allgather(numpy.asarray(value))
        return [arr[i] for i in range(self.size)]

    def bcast(self, value, root=0):
        """Broadcast an arbitrary picklable value from ``root``.

        ``broadcast_one_to_all`` needs identically-shaped array pytrees
        on every process, but the file layer broadcasts Python objects
        (name lists, updated scalars) with ``None`` placeholders on
        non-root processes.  Two phases fix the shape problem: first the
        pickled length (fixed-shape int64), then the padded bytes.
        """
        import pickle

        import numpy
        from jax.experimental import multihost_utils

        is_source = self.rank == root
        payload = pickle.dumps(value) if is_source else b""
        n = multihost_utils.broadcast_one_to_all(
            numpy.int64(len(payload)), is_source=is_source
        )
        n = int(n)
        buf = numpy.frombuffer(payload.ljust(n, b"\x00"), numpy.uint8) if is_source \
            else numpy.zeros(n, numpy.uint8)
        out = multihost_utils.broadcast_one_to_all(buf, is_source=is_source)
        return pickle.loads(numpy.asarray(out).tobytes())

    def barrier(self):
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("tpgsd-barrier")

    def allreduce_sum(self, value):
        return sum(self.allgather(value))

    def allreduce_max(self, value):
        return max(self.allgather(value))


def default_comm():
    """The right communicator for this runtime: multi-host if JAX runs
    with more than one process, else single-process."""
    try:
        import jax

        if jax.process_count() > 1:
            return JaxProcessComm()
    except Exception:
        pass
    return SingleComm()
