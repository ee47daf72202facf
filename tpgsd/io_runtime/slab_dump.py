"""Pipelined frame dumps from INSIDE the slab-sequential step.

The whole-frame dump at >HBM scale serializes: the slab scan finishes
the full step, then a multi-GB device->host transfer runs with the
device idle.
:class:`SlabDumpChannel` is the host side of
``make_slab_step_fn(..., slab_emit=...)``: each slab's window of FINAL
integrated rows streams through an ordered ``io_callback`` while later
slabs are still computing, so the frame's D2H rides the compute.  The
channel scatters every window by global particle id into a
frame-shaped host buffer (ordered emission makes a later slab's
overlap rows overwrite an earlier slab's halo values - exactly the
"last writer wins" contract of the device-side compaction), counts
slabs, and hands the completed frame to the async writer thread.

This is the north-star dump shape (BASELINE.md): device computes slab
s+1 while slab s's rows cross the link and slab s-1's bytes hit disk.

Example:
    chan = SlabDumpChannel(
        ShardedFrameWriter(path), n=db.n, n_slabs=32,
        keys=("position", "velocity", "density"),
    )
    step = jax.jit(
        make_slab_step_fn(grid, params, n_slabs=32,
                          slab_emit=chan.slab_emit),
        donate_argnums=0,
    )
    state, aux = step(state, chan.dump(i))       # emitting step
    state, aux = step(state, chan.no_dump())     # silent step
    ...
    jax.block_until_ready(state.x); chan.close()
"""

import numpy

import jax

from .dump import AsyncDumpRunner


#: payload column layout emitted by ``make_slab_step_fn``'s slab_emit
#: hook: x(3), v(3), rho(1), p(1)
_COLS = {
    "position": ("particles/position", slice(0, 3)),
    "velocity": ("particles/velocity", slice(3, 6)),
    "density": ("particles/density", slice(6, 7)),
    "pressure": ("particles/pressure", slice(7, 8)),
}


class SlabDumpChannel:
    """Assemble per-slab emissions into frames and write them async.

    Args:
        writer: :class:`tpgsd.parallel.ShardedFrameWriter` (or
            compatible); owned by default.
        n: global particle count (frame buffer rows).
        n_slabs: emissions per frame (one per slab) - the frame is
            submitted to the writer thread when the last slab arrives.
        keys: any of ``position, velocity, density, pressure``.
        depth: async writer queue depth (frames in flight).
    """

    def __init__(
        self,
        writer,
        n,
        n_slabs,
        keys=("position", "velocity", "density"),
        depth=2,
        own_writer=True,
    ):
        bad = [k for k in keys if k not in _COLS]
        if bad:
            raise ValueError(
                "unknown dump keys %r (valid: %s)" % (bad, sorted(_COLS))
            )
        self._runner = AsyncDumpRunner(writer, depth=depth, own_writer=own_writer)
        self._n = int(n)
        self._n_slabs = int(n_slabs)
        self._keys = tuple(keys)
        self._frame = None   # dict name -> (n, cols) buffer being filled
        self._step = None
        self._slabs_seen = 0
        self._frame_gap = 0
        #: cumulative never-emitted (window-overflow) rows across all
        #: frames - nonzero means written frames hold zero rows
        self.gap_rows = 0

    # -- device side ---------------------------------------------------- #

    def dump(self, step):
        """The ``dump`` argument that makes this step emit a frame."""
        import jax.numpy as jnp

        return (jnp.int32(1), jnp.int32(step))

    def no_dump(self):
        """The ``dump`` argument for a silent step."""
        import jax.numpy as jnp

        return (jnp.int32(0), jnp.int32(0))

    # -- host side (called by the ordered io_callback) ------------------- #

    def slab_emit(self, step, slab, p0, rows, pids, payload):
        """Scatter one slab's window into the frame buffer.

        ``pids[w]`` are global particle ids (-1 past the particle
        count); ``payload[w, 8]`` is ``x(3), v(3), rho, p`` - already
        integrated, so rows equal the post-step state exactly.
        ``rows`` is the slab's TRUE sorted-row count: when it exceeds
        the emission window ``w`` (the step's counted window overflow,
        ``aux[3]``), the excess rows appear in no emission and stay
        zero in the written frame - detected here, warned at frame
        completion, and counted in :attr:`gap_rows`.
        """
        step = int(numpy.asarray(step))
        slab = int(numpy.asarray(slab))
        if not 0 <= slab < self._n_slabs:
            raise ValueError(
                "slab index %d outside this channel's n_slabs=%d - the "
                "channel and make_slab_step_fn were built with "
                "different slab counts" % (slab, self._n_slabs)
            )
        if self._frame is None or self._step != step:
            # first slab of a new frame
            self._begin_frame(step)
        pids = numpy.asarray(pids)
        payload = numpy.asarray(payload)
        self._frame_gap += max(int(numpy.asarray(rows)) - pids.shape[0], 0)
        live = pids >= 0
        ids = pids[live]
        if ids.size and int(ids.max()) >= self._n:
            raise ValueError(
                "emitted particle id %d outside this channel's n=%d - "
                "the channel and the step were built for different "
                "particle counts" % (int(ids.max()), self._n)
            )
        for key in self._keys:
            _name, cols = _COLS[key]
            buf = self._frame[key]
            if buf.ndim == 1:
                buf[ids] = payload[live, cols][:, 0]
            else:
                buf[ids] = payload[live, cols]
        self._slabs_seen += 1
        if self._slabs_seen == self._n_slabs:
            self._finish_frame()

    def _begin_frame(self, step):
        if self._frame is not None:
            # ordered emission makes this reachable only when the step
            # emits MORE slabs per frame than the channel expects
            import warnings

            warnings.warn(
                "dropping incomplete frame for step %s: saw %d of the "
                "expected %d slab emissions before step %s began - "
                "channel n_slabs mismatch?"
                % (self._step, self._slabs_seen, self._n_slabs, step),
                RuntimeWarning,
            )
        self._step = step
        self._slabs_seen = 0
        self._frame_gap = 0
        self._frame = {}
        for key in self._keys:
            _name, cols = _COLS[key]
            w = cols.stop - cols.start
            shape = (self._n,) if w == 1 else (self._n, w)
            self._frame[key] = numpy.zeros(shape, numpy.float32)

    def _finish_frame(self):
        if self._frame_gap:
            import warnings

            self.gap_rows += self._frame_gap
            warnings.warn(
                "window overflow: %d particle rows of step %s were "
                "never emitted and are ZERO in the written frame "
                "(the step's aux[3] counts the same overflow) - "
                "rebuild with a wider window" % (self._frame_gap, self._step),
                RuntimeWarning,
            )
        chunks = {_COLS[k][0]: self._frame[k] for k in self._keys}
        step = self._step
        self._frame = None
        self._step = None
        self._slabs_seen = 0
        self._frame_gap = 0
        self._runner.submit(chunks, step=step)

    # -- lifecycle ------------------------------------------------------- #

    @property
    def stats(self):
        return self._runner.stats

    @property
    def writer(self):
        return self._runner._writer

    def _warn_if_incomplete(self):
        if self._frame is not None:
            import warnings

            warnings.warn(
                "dropping incomplete frame for step %s at flush/close: "
                "saw %d of the expected %d slab emissions - channel "
                "n_slabs mismatch?"
                % (self._step, self._slabs_seen, self._n_slabs),
                RuntimeWarning,
            )
            self._frame = None
            self._step = None
            self._slabs_seen = 0
            self._frame_gap = 0

    def flush(self):
        """Wait for in-flight emissions (effects barrier), then drain
        the writer queue."""
        jax.effects_barrier()
        self._warn_if_incomplete()
        self._runner.flush()

    def close(self):
        """Drain and close.  Call only after ``jax.block_until_ready``
        on the last emitting step's outputs - ordered callbacks may
        still be in flight until then."""
        jax.effects_barrier()
        self._warn_if_incomplete()
        self._runner.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        try:
            self.close()
        except Exception:
            if exc_type is None:
                raise
