"""Pipelined per-slab frame dumps (make_slab_step_fn slab_emit +
SlabDumpChannel).

The emitted windows must reassemble to EXACTLY the post-step state -
the emission uses the same integration helper as the full-array
epilogue, and ordered overlap overwrites make "last writer wins" hold
host-side as it does device-side.  This is the overlapped dump shape
of the BASELINE.md north star: D2H of slab s rides the compute of
slab s+1 instead of serializing a whole-frame transfer after the step.
"""

import jax
import numpy
import numpy.testing
import pytest

import tpgsd.pypgsd
from tpgsd.io_runtime import SlabDumpChannel
from tpgsd.parallel import ShardedFrameWriter
from tpgsd.sph import dam_break, hydrostatic_tank, make_slab_step_fn


def _roundtrip(tmp_path, db, n_slabs, steps=3, dump_every=2, n_fixed=0, **kw):
    path = str(tmp_path / "slabdump.gsd")
    chan = SlabDumpChannel(
        ShardedFrameWriter(path),
        n=db.n,
        n_slabs=n_slabs,
        keys=("position", "velocity", "density", "pressure"),
    )
    step = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=n_slabs, n_fixed=n_fixed,
            slab_emit=chan.slab_emit, **kw
        )
    )
    ref_step = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=n_slabs, n_fixed=n_fixed, **kw
        )
    )

    state, sref = db.state, db.state
    expected = []  # (frame_index_in_file, ref state, rho, p)
    for i in range(steps):
        emitting = i % dump_every == 0
        dump = chan.dump(i) if emitting else chan.no_dump()
        state, _aux = step(state, dump)
        sref, (rho, p, _o, _w) = ref_step(sref)
        if emitting:
            expected.append((i, sref, rho, p))
    jax.block_until_ready(state.x)
    # the emitting and silent paths stay in lockstep with the plain step
    numpy.testing.assert_array_equal(
        numpy.asarray(state.x), numpy.asarray(sref.x)
    )
    chan.close()

    with tpgsd.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == len(expected), f.nframes
        for frame, (step_i, s, rho, p) in enumerate(expected):
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "particles/position"), numpy.asarray(s.x)
            )
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "particles/velocity"), numpy.asarray(s.v)
            )
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "particles/density"), numpy.asarray(rho)
            )
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "particles/pressure"), numpy.asarray(p)
            )
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "configuration/step"), [step_i]
            )
    with open(path, "rb") as fh:
        report = tpgsd.pypgsd.verify(fh, deep=True)
    assert report["ok"], report["errors"]


def test_slab_dump_frames_equal_post_step_state(tmp_path):
    """Every streamed frame is bit-identical to the post-step state."""
    db = dam_break(n_side=10)
    assert db.grid.dims[0] % 3 == 0, db.grid.dims
    _roundtrip(tmp_path, db, n_slabs=3)


def test_slab_dump_with_fixed_boundary(tmp_path):
    """n_fixed boundary rows keep their positions and zero velocity in
    the streamed frames (the where-masked twin of the epilogue's
    concatenate)."""
    db = hydrostatic_tank(n_side=8)
    S = 2 if db.grid.dims[0] % 2 == 0 else 1
    _roundtrip(tmp_path, db, n_slabs=S, n_fixed=db.n_fixed)


def test_slab_dump_pallas_interpret(tmp_path):
    """The emission composes with the Triton pair kernels (interpret
    mode on CPU) in the continuity slab step."""
    from tpgsd.sph import init_density

    db = dam_break(n_side=10)
    db = db._replace(state=init_density(db.state, db.grid, db.params))
    assert db.grid.dims[0] % 3 == 0, db.grid.dims
    _roundtrip(
        tmp_path, db, n_slabs=3, steps=2, dump_every=1,
        density_mode="continuity", use_pallas=True, pallas_interpret=True,
    )


def test_slab_dump_continuity(tmp_path):
    """Pipelined dumps in continuity mode: the emitted density is the
    UPDATED carried density (rho_cur from the feature window +
    dt * drho), bit-identical to the post-step state."""
    from tpgsd.sph import init_density

    db = dam_break(n_side=10)
    st0 = init_density(db.state, db.grid, db.params)
    db = db._replace(state=st0)
    _roundtrip(tmp_path, db, n_slabs=3, density_mode="continuity",
               use_pallas=False)


def test_slab_dump_resume_roundtrip(tmp_path):
    """A pipelined-dump file resumes like a plain-dump file."""
    from tpgsd.sph import resume

    db = dam_break(n_side=10)
    path = str(tmp_path / "res.gsd")
    chan = SlabDumpChannel(
        ShardedFrameWriter(path), n=db.n, n_slabs=3,
        keys=("position", "velocity", "density"),
    )
    step = jax.jit(
        make_slab_step_fn(db.grid, db.params, n_slabs=3,
                          slab_emit=chan.slab_emit)
    )
    state = db.state
    for i in range(2):
        state, _aux = step(state, chan.dump(i))
    jax.block_until_ready(state.x)
    chan.close()

    state2, last_step, writer, _extra = resume(path)
    try:
        assert int(last_step) == 1
        numpy.testing.assert_array_equal(
            numpy.asarray(state2.x), numpy.asarray(state.x)
        )
    finally:
        writer.close()


def test_slab_dump_bad_key_raises(tmp_path):
    db = dam_break(n_side=6)
    with pytest.raises(ValueError, match="unknown dump keys"):
        SlabDumpChannel(
            ShardedFrameWriter(str(tmp_path / "x.gsd")),
            n=db.n, n_slabs=2, keys=("position", "entropy"),
        )


def test_slab_dump_window_overflow_gap_warns(tmp_path):
    """Rows past a slab's emission window appear in NO emission (the
    step counts them as aux[3] window overflow); the channel must
    surface the gap loudly instead of silently writing zero rows."""
    db = dam_break(n_side=9)
    assert db.grid.dims[0] % 2 == 0, db.grid.dims
    path = str(tmp_path / "gap.gsd")
    # the dam block concentrates nearly all particles in low-x slabs:
    # a window far below n forces rows_s > w_rows on the dense slab
    chan = SlabDumpChannel(
        ShardedFrameWriter(path), n=db.n, n_slabs=2,
        keys=("position",),
    )
    step = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=2, window=db.n // 3,
            slab_emit=chan.slab_emit,
        )
    )
    with pytest.warns(RuntimeWarning, match="window overflow"):
        state, (_rho, _p, _co, wo) = step(db.state, chan.dump(0))
        jax.block_until_ready(state.x)
        chan.flush()
    assert int(wo) > 0  # the step counted the same overflow
    assert chan.gap_rows == int(wo)
    chan.close()
    # the frame is still written (everything but the gap is valid)
    with tpgsd.pypgsd.PGSDFile(open(path, "rb")) as f:
        assert f.nframes == 1


def test_slab_dump_channel_mismatch_errors():
    """Host-side validation of the channel/step contract."""
    import tpgsd.fl
    import os
    import tempfile

    d = tempfile.mkdtemp()
    chan = SlabDumpChannel(
        ShardedFrameWriter(os.path.join(d, "m.gsd")), n=100, n_slabs=2,
        keys=("position",),
    )
    pids = numpy.arange(4, dtype=numpy.int32)
    payload = numpy.zeros((4, 8), numpy.float32)
    with pytest.raises(ValueError, match="n_slabs"):
        chan.slab_emit(0, 5, 0, 4, pids, payload)      # slab index >= 2
    with pytest.raises(ValueError, match="particle id"):
        chan.slab_emit(0, 0, 0, 4, pids + 200, payload)  # pid >= n
    # channel expecting MORE slabs than the step emits: the frame never
    # completes -> warned and dropped at close, not silently half-written
    with pytest.warns(RuntimeWarning, match="incomplete frame"):
        chan.close()


def test_slab_step_missing_dump_arg_raises():
    db = dam_break(n_side=9)
    chan_emit = lambda *a: None  # noqa: E731
    step = make_slab_step_fn(
        db.grid, db.params, n_slabs=2, slab_emit=chan_emit
    )
    with pytest.raises(TypeError, match="chan.dump"):
        step(db.state)
