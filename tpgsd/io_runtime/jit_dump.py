"""Frame dumps from INSIDE jitted code: ``jax.experimental.io_callback``.

The plain dump loop leaves jit every step (Python drives the loop and
submits frames).  For long rollouts the jit-native shape is one
``lax.scan`` over the whole simulation - a single compiled program -
with the dump embedded as an ordered host callback: the device pushes
each selected frame's arrays to the host, where the async runner queues
them for the writer thread, while the scan keeps running.

This is the "clean boundary between device sizes and host file offsets"
design point (SURVEY.md section 7, hard parts): shapes are static, so
offsets are computed host-side per frame; nothing about the file
protocol lives on the device.

Example:
    emit = JitDumpChannel(ShardedFrameWriter(path),
                          ["particles/position", "particles/velocity"])
    def body(state, i):
        state, (rho, p, _) = step(state)
        emit.maybe_emit(i, every=10, arrays=[state.x, state.v], step=i)
        return state, None
    final, _ = jax.lax.scan(body, state0, jnp.arange(1000))
    emit.close()   # after jax.block_until_ready(final)
"""

import jax
import jax.numpy as jnp
import numpy

from .dump import AsyncDumpRunner


class JitDumpChannel:
    """Host-side sink for frames emitted from jitted code.

    Args:
        writer: ShardedFrameWriter (or compatible); owned by default.
        names: chunk names, positionally matching the ``arrays`` passed
            to :meth:`emit` / :meth:`maybe_emit`.
        depth: async queue depth (frames in flight).
    """

    def __init__(self, writer, names, depth=2, own_writer=True):
        self._runner = AsyncDumpRunner(writer, depth=depth, own_writer=own_writer)
        self._names = list(names)

    # -- host side ----------------------------------------------------- #

    def _host_emit(self, step, *arrays):
        step = int(numpy.asarray(step))
        chunks = {
            name: numpy.asarray(a) for name, a in zip(self._names, arrays)
        }
        self._runner.submit(chunks, step=step)

    # -- device side --------------------------------------------------- #

    def emit(self, arrays, step):
        """Unconditionally emit one frame (call inside jit).

        ``ordered=True`` keeps frame order deterministic under the
        scan; the callback ships the arrays device->host and returns
        immediately to the compiled loop.
        """
        jax.experimental.io_callback(
            self._host_emit,
            None,
            jnp.asarray(step, jnp.int64)
            if jax.config.jax_enable_x64
            else jnp.asarray(step, jnp.int32),
            *arrays,
            ordered=True,
        )

    def maybe_emit(self, i, every, arrays, step=None):
        """Emit when ``i % every == 0`` (static-shape-friendly cond)."""
        step = i if step is None else step

        def do(args):
            self.emit(args, step)
            return 0

        def skip(args):
            return 0

        jax.lax.cond(jnp.asarray(i) % every == 0, do, skip, arrays)

    # -- lifecycle ----------------------------------------------------- #

    @property
    def stats(self):
        return self._runner.stats

    def flush(self):
        self._runner.flush()

    def close(self):
        """Drain and close.  Call only after the jitted computation has
        completed (``jax.block_until_ready`` on its outputs) - ordered
        callbacks may still be in flight until then."""
        self._runner.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except Exception:
                pass


def scan_simulate(step_fn, state, n_steps, channel, frame_of, every=1):
    """One fully-jitted ``lax.scan`` rollout with embedded dumps.

    Args:
        step_fn: ``state -> (state, aux)``.
        state: initial state pytree.
        n_steps: total steps (static).
        channel: :class:`JitDumpChannel` whose names match ``frame_of``.
        frame_of: ``(state, aux) -> list of arrays`` (positional, in
            channel-name order).
        every: dump cadence.

    Returns:
        final state (after ``block_until_ready``); the channel is
        flushed but left open.
    """

    def body(carry, i):
        new_state, aux = step_fn(carry)
        channel.maybe_emit(i, every, frame_of(new_state, aux), step=i)
        return new_state, None

    final, _ = jax.lax.scan(body, state, jnp.arange(n_steps))
    final = jax.block_until_ready(final)
    channel.flush()
    return final


def scan_simulate_adaptive(
    step_fn, state, dt0, n_steps, channel, frame_of, every=1
):
    """Adaptive-dt ``lax.scan`` rollout with embedded dumps.

    The adaptive analogue of :func:`scan_simulate`: the carry is
    ``(state, dt, t)`` as in :func:`tpgsd.sph.run_adaptive`, and every
    ``every``-th step emits a frame through the ordered host callback
    while the compiled loop keeps running.  Works with any controller
    step built by ``make_adaptive_step_fn`` /
    ``make_adaptive_distributed_step_fn`` /
    ``make_adaptive_distributed2d_step_fn`` /
    ``make_adaptive_distributed3d_step_fn`` (state pytrees compose).

    Args:
        step_fn: adaptive step ``(state, dt) -> (state, aux, dt_next)``.
        state: initial state pytree.
        dt0: first step's dt (e.g. ``params.dt``).
        n_steps: total steps (static trip count).
        channel: :class:`JitDumpChannel` whose names match ``frame_of``.
        frame_of: ``(state, aux) -> list of arrays``.
        every: dump cadence (in steps - with variable dt the frames are
            equally spaced in step count, not simulated time).

    Returns:
        ``(state, dt_next, t)`` after ``block_until_ready``; the
        channel is flushed but left open.
    """

    def body(carry, i):
        s, dt, t = carry
        new_state, aux, dt_next = step_fn(s, dt)
        channel.maybe_emit(i, every, frame_of(new_state, aux), step=i)
        return (new_state, dt_next, t + dt), None

    (final, dt, t), _ = jax.lax.scan(
        body,
        (state, jnp.float32(dt0), jnp.float32(0.0)),
        jnp.arange(n_steps),
    )
    final = jax.block_until_ready(final)
    channel.flush()
    return final, dt, t
