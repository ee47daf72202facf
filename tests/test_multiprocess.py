"""REAL multi-process file-layer tests over jax.distributed.

2/4/8 OS processes coordinate through ``JaxProcessComm``
(multihost_utils over the Gloo CPU backend): collective open, the
striped offset protocol, controller-only buffered chunks, name/index
replication for in-session reads, the compose-on-commit writer, and a
kill-one-process-mid-frame recovery test proving the data-before-index
promise under real process death.  This is the closest local stand-in
for a multi-host accelerator cluster; the threading harness in test_multirank.py
covers the same protocol in-process.  (Reference never automated any
multi-rank test — CHANGELOG.md:172-194 reports manual 1/2/4/8-rank
benchmark runs; INSTALLING.rst:178-183 states the open-ranks
constraint.)
"""

import pathlib
import signal
import socket
import subprocess
import sys
import textwrap

import numpy
import numpy.testing
import pytest

import tpgsd.pypgsd

_REPO = str(pathlib.Path(__file__).resolve().parent.parent)

# Preamble shared by every worker: argv = pid nprocs fname port
_PREAMBLE = textwrap.dedent(
    """
    import sys
    pid = int(sys.argv[1]); nprocs = int(sys.argv[2])
    fname = sys.argv[3]; port = sys.argv[4]; repo = %r
    import os
    # the test session forces 8 virtual CPU devices; worker processes
    # model one device per host process (the pod shape)
    os.environ["XLA_FLAGS"] = " ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count")
    )
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.distributed.initialize(
        coordinator_address="localhost:" + port,
        num_processes=nprocs, process_id=pid)
    sys.path.insert(0, repo)
    import numpy
    import tpgsd.fl
    from tpgsd.parallel.comm import JaxProcessComm

    comm = JaxProcessComm()
    assert comm.size == nprocs and comm.rank == pid
    """
    % _REPO
)

STRIPED_WORKER = _PREAMBLE + textwrap.dedent(
    """
    # uneven partition: rank r owns 3 + r rows (remainder-spread pattern,
    # reference: benchmark-write.cc:33-37)
    counts = numpy.array([3 + r for r in range(nprocs)], dtype=numpy.uint64)
    lo = int(counts[:pid].sum())
    data = numpy.arange(int(counts.sum()), dtype=numpy.float64)

    f = tpgsd.fl.PGSDFile(fname, "w", application="mp", schema="none",
                          schema_version=(1, 0), comm=comm)
    for frame in range(2):
        f.write_chunk("step", numpy.array([frame], numpy.uint64),
                      write_all=False)
        f.write_chunk("d", data[lo:lo + int(counts[pid])] + frame,
                      offset=counts, rank=pid, write_all=True)
        f.end_frame()
    # in-session reads on every process need the replication at flush
    assert f.chunk_exists(0, "d")
    numpy.testing.assert_array_equal(f.read_chunk(1, "d"), data + 1)
    f.close()
    print("proc", pid, "OK")
    """
)

COMPOSED_WORKER = _PREAMBLE + textwrap.dedent(
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from tpgsd.parallel.compose_io import ComposedFrameWriter

    # Build a REAL cross-process sharded jax.Array (the pod pattern):
    # each process contributes its single CPU device's shard; the
    # global row indices come from the sharding, exactly as they would
    # from per-host addressable shards on a multi-host cluster.
    mesh = Mesh(numpy.array(jax.devices()), ("x",))
    sharding = NamedSharding(mesh, PartitionSpec("x"))
    rows = 4
    total = rows * nprocs

    w = ComposedFrameWriter(fname, schema="none", schema_version=(1, 0),
                            comm=comm)
    for frame in range(3):
        local = (numpy.arange(rows, dtype=numpy.float64) + rows * pid) * 10
        buf = jax.device_put(local + frame, jax.local_devices()[0])
        garr = jax.make_array_from_single_device_arrays(
            (total,), sharding, [buf])
        w.write_frame({"log/d": garr}, step=frame)
    w.close()
    print("proc", pid, "OK")
    """
)

# Rank 0 (the controller, which owns ALL metadata commits) is SIGKILLed
# mid-frame after 3 committed frames; survivors exit without flushing.
KILL_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import os, time
    counts = numpy.array([4] * nprocs, dtype=numpy.uint64)
    lo = 4 * pid
    data = numpy.arange(4 * nprocs, dtype=numpy.float64)

    f = tpgsd.fl.PGSDFile(fname, "w", application="mp", schema="none",
                          schema_version=(1, 0), comm=comm)
    for frame in range(3):
        f.write_chunk("d", data[lo:lo + 4] + frame,
                      offset=counts, rank=pid, write_all=True)
        f.end_frame()
    f.flush()  # frames 0-2 durably indexed

    # frame 3: data bytes land in the file (direct striped write),
    # then the controller dies before the index is ever committed
    f.write_chunk("d", data[lo:lo + 4] + 99.0,
                  offset=counts, rank=pid, write_all=True)
    comm.barrier()  # every rank's frame-3 bytes are issued
    if pid == 0:
        os.kill(os.getpid(), 9)
    # survivors: simulate job teardown after detecting peer death --
    # exit WITHOUT end_frame/close so no flush path runs
    time.sleep(1.0)
    os._exit(0)
    """
)

# Distributed SPH slab step across REAL OS processes: the mesh spans
# one CPU device per process, so every ppermute halo/migration hop and
# the distribute_state device_put cross a process boundary (Gloo) --
# the local stand-in for a multi-host cluster running the stepper.
# The in-process 8-device tests (test_distributed.py) prove the math;
# this proves the cross-process plumbing end to end.
SPH_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import numpy.testing
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from tpgsd.parallel import make_mesh
    from tpgsd.sph import SPHState, dam_break, make_step_fn
    from tpgsd.sph.cells import CellGrid
    from tpgsd.sph.distributed import distribute_state, make_distributed_step_fn

    db = dam_break(n_side=8, box=(4.0, 0.5, 0.5), fill=(0.4, 1.0, 1.0))
    grid, state = db.grid, db.state
    nx = grid.dims[0]
    if nx % nprocs != 0:  # shrink the box in x to land on a multiple
        nxp = (nx // nprocs) * nprocs
        keep = numpy.asarray(state.x)[:, 0] < nxp * grid.cell_size * 0.95
        x = numpy.asarray(state.x)[keep]
        grid = CellGrid(lo=grid.lo, cell_size=grid.cell_size,
                        dims=(nxp, grid.dims[1], grid.dims[2]),
                        capacity=grid.capacity)
        state = SPHState(x=jnp.asarray(x), v=jnp.zeros_like(jnp.asarray(x)))
    n = state.x.shape[0]

    # serial reference, replicated on every process's own device
    step_ref = jax.jit(make_step_fn(grid, db.params))
    s_ref = state
    for _ in range(3):
        s_ref, _aux = step_ref(s_ref)

    mesh = make_mesh()  # spans all processes: one device each
    assert mesh.devices.size == nprocs
    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(grid, db.params, mesh, capacity=cap)
    for _ in range(3):
        dist, aux = step_d(dist)

    # global arrays are not fully addressable here; gather to host
    movf = multihost_utils.process_allgather(aux.migrate_overflow, tiled=True)
    covf = multihost_utils.process_allgather(aux.cell_overflow, tiled=True)
    assert movf.sum() == 0 and covf.sum() == 0
    xg = multihost_utils.process_allgather(dist.x, tiled=True)
    vg = multihost_utils.process_allgather(dist.v, tiled=True)
    pidg = multihost_utils.process_allgather(dist.pid, tiled=True)
    alive = pidg >= 0
    assert alive.sum() == n and len(set(pidg[alive].tolist())) == n
    out_x = numpy.zeros((n, 3), numpy.float32)
    out_v = numpy.zeros((n, 3), numpy.float32)
    out_x[pidg[alive]] = xg[alive]
    out_v[pidg[alive]] = vg[alive]
    numpy.testing.assert_allclose(
        out_x, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5)
    numpy.testing.assert_allclose(
        out_v, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3)
    print("proc", pid, "OK")
    """
)


# 2-D block-decomposed SPH step across a (2, 2) mesh of REAL OS
# processes: both mesh axes span process boundaries, so every
# dimension-ordered halo exchange (y then x) and both hops of the
# two-phase migration ride Gloo.  The in-process (4,2)/(2,2) tests
# (test_distributed2d.py) prove the math; this proves the 2-D
# cross-process plumbing end to end.
SPH2D_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import numpy.testing
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from tpgsd.parallel import make_mesh2d
    from tpgsd.sph import (
        SPHParams,
        SPHState,
        distribute_state_2d,
        make_distributed2d_step_fn,
        make_step_fn,
    )
    from tpgsd.sph.cells import CellGrid

    # the test_distributed2d.py cloud: (8, 4, 4) cells over a 2 x 1 x 1
    # box, divisible by the (2, 2) mesh on both decomposed axes
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                    capacity=16)
    rng = numpy.random.RandomState(7)
    n = 160
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= 2.0
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    params = SPHParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    state = SPHState(x=jnp.asarray(x), v=jnp.asarray(v))

    # serial reference, replicated on every process's own device
    step_ref = jax.jit(make_step_fn(grid, params))
    s_ref = state
    for _ in range(3):
        s_ref, _aux = step_ref(s_ref)

    mesh = make_mesh2d(shape=(2, 2))
    assert mesh.devices.size == nprocs
    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_distributed2d_step_fn(grid, params, mesh, capacity=cap)
    for _ in range(3):
        dist, aux = step_d(dist)

    movf = multihost_utils.process_allgather(aux.migrate_overflow, tiled=True)
    covf = multihost_utils.process_allgather(aux.cell_overflow, tiled=True)
    assert movf.sum() == 0 and covf.sum() == 0
    xg = multihost_utils.process_allgather(dist.x, tiled=True)
    vg = multihost_utils.process_allgather(dist.v, tiled=True)
    pidg = multihost_utils.process_allgather(dist.pid, tiled=True)
    alive = pidg >= 0
    assert alive.sum() == n and len(set(pidg[alive].tolist())) == n
    out_x = numpy.zeros((n, 3), numpy.float32)
    out_v = numpy.zeros((n, 3), numpy.float32)
    out_x[pidg[alive]] = xg[alive]
    out_v[pidg[alive]] = vg[alive]
    numpy.testing.assert_allclose(
        out_x, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5)
    numpy.testing.assert_allclose(
        out_v, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3)
    print("proc", pid, "OK")
    """
)


# Production dump cycle across REAL OS processes: the 2-D block SPH
# step produces cross-process-sharded DistState arrays, and
# ShardedFrameWriter streams them - each process pwrites only its
# addressable shards at their sharding-derived offsets while the
# controller commits the metadata.  This is the full simulate+dump
# loop a multi-host cluster would run.
SPH_DUMP_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import jax.numpy as jnp
    from tpgsd.parallel import ShardedFrameWriter, make_mesh2d
    from tpgsd.sph import (
        SPHParams,
        SPHState,
        distribute_state_2d,
        make_distributed2d_step_fn,
    )
    from tpgsd.sph.cells import CellGrid

    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                    capacity=16)
    rng = numpy.random.RandomState(7)
    n = 160
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= 2.0
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    params = SPHParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    mesh = make_mesh2d(shape=(2, 2))
    dist, cap = distribute_state_2d(
        SPHState(x=jnp.asarray(x), v=jnp.asarray(v)), grid, mesh)
    step = make_distributed2d_step_fn(grid, params, mesh, capacity=cap)

    w = ShardedFrameWriter(fname, comm=comm)
    for s in range(2):
        dist, aux = step(dist)
        w.write_frame(
            {
                "particles/position": dist.x,
                "particles/velocity": dist.v,
                "log/pid": dist.pid,
            },
            step=s,
        )
    # in-session reads on every process (committed-entry replication)
    got = w.file.read_chunk(1, "log/pid")
    assert got.shape[0] == dist.pid.shape[0]
    assert (got >= -1).all()
    w.close()
    print("proc", pid, "CAP", cap, "OK")
    """
)


# 3-D block-decomposed SPH step across a (2, 2, 2) mesh of REAL OS
# processes: ALL THREE mesh axes span process boundaries, so every
# hop of the z/y/x-ordered halo exchange and all three migration
# phases ride Gloo.
SPH3D_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import numpy.testing
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from tpgsd.parallel import make_mesh3d
    from tpgsd.sph import (
        SPHParams,
        SPHState,
        distribute_state_3d,
        make_distributed3d_step_fn,
        make_step_fn,
    )
    from tpgsd.sph.cells import CellGrid

    # the test_distributed3d.py cloud: (4, 4, 4) cells over a unit box,
    # divisible by the (2, 2, 2) mesh on every decomposed axis
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(4, 4, 4),
                    capacity=16)
    rng = numpy.random.RandomState(7)
    n = 160
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    params = SPHParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    state = SPHState(x=jnp.asarray(x), v=jnp.asarray(v))

    # serial reference, replicated on every process's own device
    step_ref = jax.jit(make_step_fn(grid, params))
    s_ref = state
    for _ in range(3):
        s_ref, _aux = step_ref(s_ref)

    mesh = make_mesh3d(shape=(2, 2, 2))
    assert mesh.devices.size == nprocs
    dist, cap = distribute_state_3d(state, grid, mesh)
    step_d = make_distributed3d_step_fn(grid, params, mesh, capacity=cap)
    for _ in range(3):
        dist, aux = step_d(dist)

    movf = multihost_utils.process_allgather(aux.migrate_overflow, tiled=True)
    covf = multihost_utils.process_allgather(aux.cell_overflow, tiled=True)
    assert movf.sum() == 0 and covf.sum() == 0
    xg = multihost_utils.process_allgather(dist.x, tiled=True)
    vg = multihost_utils.process_allgather(dist.v, tiled=True)
    pidg = multihost_utils.process_allgather(dist.pid, tiled=True)
    alive = pidg >= 0
    assert alive.sum() == n and len(set(pidg[alive].tolist())) == n
    out_x = numpy.zeros((n, 3), numpy.float32)
    out_v = numpy.zeros((n, 3), numpy.float32)
    out_x[pidg[alive]] = xg[alive]
    out_v[pidg[alive]] = vg[alive]
    numpy.testing.assert_allclose(
        out_x, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5)
    numpy.testing.assert_allclose(
        out_v, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3)
    print("proc", pid, "OK")
    """
)


# The Triton pair kernels (interpret mode, in both density
# formulations) across a REAL process boundary: the slab mesh spans one
# CPU device per process, so the ext-grid halo the kernels read crosses
# Gloo.  The in-process 8-device tests prove the math; this proves the
# kernel-in-shard_map contract where jax.distributed actually places
# process boundaries.  Density mode is derived from the file name
# ("continuity" substring).
KERNEL_WORKER = _PREAMBLE + textwrap.dedent(
    """
    import numpy.testing
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from tpgsd.parallel import make_mesh
    from tpgsd.sph import (
        SPHParams,
        SPHState,
        distribute_state,
        init_density,
        make_distributed_step_fn,
        make_step_fn,
    )
    from tpgsd.sph.cells import CellGrid, build_cells

    mode = "continuity" if "continuity" in fname else "summation"

    # a cloud with a dense corner (max occupancy < 48, so nothing
    # overflows); the (8, 4, 4) grid divides the 2-process slab mesh
    rng = numpy.random.default_rng(3)
    n = 2400
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(numpy.float32)
    x[:, 0] *= 2.0
    x[:140, 0] = rng.uniform(0.02, 0.51, 140)
    x[:140, 1] = rng.uniform(0.02, 0.51, 140)
    x[:140, 2] = rng.uniform(0.02, 0.51, 140)
    v = (rng.normal(size=(n, 3)) * 0.05).astype(numpy.float32)
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                    capacity=48)
    params = SPHParams(mass=0.8, h=0.12, dt=1e-4, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))

    occ = numpy.bincount(
        numpy.asarray(build_cells(jnp.asarray(x), grid).cid),
        minlength=grid.n_cells,
    )
    assert occ.max() <= 44, occ.max()

    state = SPHState(x=jnp.asarray(x), v=jnp.asarray(v))
    kw = {}
    if mode == "continuity":
        state = init_density(state, grid, params)
        kw["density_mode"] = "continuity"

    # serial jnp reference, replicated on every process's own device
    step_ref = jax.jit(make_step_fn(grid, params, use_pallas=False, **kw))
    s_ref = state
    for _ in range(2):
        s_ref, aux_ref = step_ref(s_ref)

    mesh = make_mesh()  # spans all processes: one device each
    assert mesh.devices.size == nprocs
    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, use_pallas=True,
        pallas_interpret=True, **kw)
    for _ in range(2):
        dist, aux = step_d(dist)

    movf = multihost_utils.process_allgather(aux.migrate_overflow, tiled=True)
    covf = multihost_utils.process_allgather(aux.cell_overflow, tiled=True)
    assert movf.sum() == 0 and covf.sum() == 0
    xg = multihost_utils.process_allgather(dist.x, tiled=True)
    vg = multihost_utils.process_allgather(dist.v, tiled=True)
    pidg = multihost_utils.process_allgather(dist.pid, tiled=True)
    alive = pidg >= 0
    assert alive.sum() == n and len(set(pidg[alive].tolist())) == n
    out_x = numpy.zeros((n, 3), numpy.float32)
    out_v = numpy.zeros((n, 3), numpy.float32)
    out_x[pidg[alive]] = xg[alive]
    out_v[pidg[alive]] = vg[alive]
    numpy.testing.assert_allclose(
        out_x, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5)
    numpy.testing.assert_allclose(
        out_v, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3)
    if mode == "continuity":
        rg = multihost_utils.process_allgather(dist.rho, tiled=True)
        out_r = numpy.zeros((n,), numpy.float32)
        out_r[pidg[alive]] = rg[alive]
        numpy.testing.assert_allclose(
            out_r, numpy.asarray(s_ref.rho), rtol=5e-4)
    print("proc", pid, "OK")
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp_path, worker_src, nprocs, fname):
    worker = tmp_path / "worker.py"
    worker.write_text(worker_src)
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(nprocs), fname, port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nprocs)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outputs.append(out)
    return procs, outputs


@pytest.mark.parametrize("nprocs", [2, 4, 8])
def test_striped_write(tmp_path, nprocs):
    """N processes stripe uneven row partitions into one shared file."""
    fname = str(tmp_path / "mp.gsd")
    procs, outputs = _launch(tmp_path, STRIPED_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]

    total = sum(3 + r for r in range(nprocs))
    with tpgsd.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.nframes == 2
        numpy.testing.assert_array_equal(
            f.read_chunk(1, "d"), numpy.arange(total, dtype=numpy.float64) + 1
        )
        assert f.read_chunk(1, "step")[0] == 1


@pytest.mark.parametrize("nprocs", [4])
def test_composed_writer_multiprocess(tmp_path, nprocs):
    """ComposedFrameWriter: per-process sequential spills -> one GSD file."""
    fname = str(tmp_path / "composed.gsd")
    procs, outputs = _launch(tmp_path, COMPOSED_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]

    total = 4 * nprocs
    expected0 = numpy.arange(total, dtype=numpy.float64) * 10
    with tpgsd.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.nframes == 3
        for frame in range(3):
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "log/d"), expected0 + frame
            )
    with open(fname, "rb") as fobj:
        report = tpgsd.pypgsd.verify(fobj, deep=True)
    assert report["ok"], report["errors"]


def test_kill_controller_mid_frame(tmp_path):
    """Process death mid-frame: the reopened file exposes only complete frames.

    The controller process (sole owner of index/namelist commits) is
    SIGKILLed after writing its frame-3 data bytes but before any
    index commit; the survivors exit without flushing.  Data-before-
    index ordering means the torn frame's bytes are dead bytes and the
    file reopens cleanly at exactly 3 frames.
    """
    nprocs = 4
    fname = str(tmp_path / "killed.gsd")
    procs, outputs = _launch(tmp_path, KILL_WORKER, nprocs, fname)
    assert procs[0].returncode == -signal.SIGKILL, outputs[0][-2000:]
    # Survivors either win the race to _exit(0) or are hard-aborted by
    # the JAX coordination service noticing the coordinator died --
    # both are real teardown paths; the property under test is the FILE.
    for p in procs[1:]:
        assert p.returncode is not None

    data = numpy.arange(4 * nprocs, dtype=numpy.float64)
    with tpgsd.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.nframes == 3  # frame 3 was torn: never indexed
        for frame in range(3):
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "d"), data + frame
            )
        assert not f.chunk_exists(3, "d")
    with open(fname, "rb") as fobj:
        report = tpgsd.pypgsd.verify(fobj, deep=True)
    assert report["ok"], report["errors"]


@pytest.mark.parametrize("nprocs", [2])
def test_distributed_sph_multiprocess(tmp_path, nprocs):
    """Slab-decomposed SPH step over a mesh spanning real OS processes.

    Every halo ppermute and particle migration crosses a process
    boundary; the collected 3-step trajectory must match the serial
    single-device step at the in-process parity tolerances."""
    fname = str(tmp_path / "unused.gsd")
    procs, outputs = _launch(tmp_path, SPH_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out


@pytest.mark.parametrize("nprocs", [4])
def test_distributed2d_sph_multiprocess(tmp_path, nprocs):
    """2-D block-decomposed SPH step over a (2, 2) mesh of OS processes.

    Both decomposed axes cross process boundaries: every
    dimension-ordered halo exchange and both hops of the two-phase
    migration ride the Gloo backend; the collected 3-step trajectory
    must match the serial single-device step at the in-process parity
    tolerances."""
    fname = str(tmp_path / "unused.gsd")
    procs, outputs = _launch(tmp_path, SPH2D_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out


@pytest.mark.parametrize("nprocs", [4])
def test_sph_dump_cycle_multiprocess(tmp_path, nprocs):
    """Simulate + dump across processes: the 2-D block step's sharded
    slot arrays stream through ShardedFrameWriter - every process
    pwrites only its addressable shards, the controller commits the
    index - and the closed file is fsck-clean with a full particle
    census."""
    n = 160
    fname = str(tmp_path / "cycle.gsd")
    procs, outputs = _launch(tmp_path, SPH_DUMP_WORKER, nprocs, fname)
    cap = None
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out
        cap = int(out.split("CAP")[1].split()[0])

    with tpgsd.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.nframes == 2
        for frame in range(2):
            pos = f.read_chunk(frame, "particles/position")
            pid = f.read_chunk(frame, "log/pid")
            assert pos.shape == (nprocs * cap, 3)
            alive = pid >= 0
            # every particle present exactly once, dead slots zeroed
            assert alive.sum() == n
            assert sorted(pid[alive].tolist()) == list(range(n))
            assert numpy.isfinite(pos[alive]).all()
    with open(fname, "rb") as fobj:
        report = tpgsd.pypgsd.verify(fobj, deep=True)
    assert report["ok"], report["errors"]


@pytest.mark.parametrize("mode", ["summation", "continuity"])
def test_kernel_slab_multiprocess(tmp_path, mode):
    """The Triton pair kernels across a REAL process boundary, both
    density formulations.

    The slab-decomposed step runs its kernels in interpret mode inside
    shard_map over a 2-process mesh: the ext-grid halo crosses Gloo, and
    the collected 2-step trajectory must match the serial jnp step."""
    fname = str(tmp_path / ("kernel_%s.gsd" % mode))
    procs, outputs = _launch(tmp_path, KERNEL_WORKER, 2, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out


@pytest.mark.parametrize("nprocs", [8])
def test_distributed3d_sph_multiprocess(tmp_path, nprocs):
    """3-D block-decomposed SPH step over a (2, 2, 2) mesh of OS
    processes - one device per process, so ALL THREE mesh axes cross
    process boundaries: every hop of the z/y/x-ordered halo exchange
    and all three migration phases ride the Gloo backend; the
    collected 3-step trajectory must match the serial single-device
    step at the in-process parity tolerances."""
    fname = str(tmp_path / "unused.gsd")
    procs, outputs = _launch(tmp_path, SPH3D_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out


# Pod-shape preamble: each worker process models a HOST with FOUR local
# devices (a multi-device host), so the global mesh spans processes
# AND local devices at once - the regime where the addressable-shards
# dedup, the JaxProcessComm offset protocol, and ShardedFrameWriter all
# have to compose (the reference's open-ranks constraint governs
# exactly this regime, reference: pgsd/INSTALLING.rst:178-183).
_PREAMBLE_POD = _PREAMBLE.replace(
    'jax.config.update("jax_num_cpu_devices", 1)',
    'jax.config.update("jax_num_cpu_devices", 4)',
)

POD_WORKER = _PREAMBLE_POD + textwrap.dedent(
    """
    import jax.numpy as jnp
    import numpy.testing
    import tpgsd.fl
    from tpgsd.parallel import ShardedFrameWriter, make_mesh
    from tpgsd.parallel.mesh import row_sharding
    from tpgsd.parallel.shard_io import read_sharded_chunk

    assert len(jax.devices()) == 4 * nprocs
    assert len(jax.local_devices()) == 4

    mesh = make_mesh()  # global: nprocs * 4 devices
    sharding = row_sharding(mesh)
    rows = 5
    total = rows * 4 * nprocs
    data = numpy.arange(total * 2, dtype=numpy.float64).reshape(total, 2)

    # build the cross-process sharded array from per-device local shards
    idxmap = sharding.addressable_devices_indices_map((total, 2))
    bufs = [jax.device_put(data[idx], d) for d, idx in idxmap.items()]
    garr = jax.make_array_from_single_device_arrays(
        (total, 2), sharding, bufs)

    # ---- striped writes: each PROCESS pwrites its 4 devices' rows ----
    w = ShardedFrameWriter(fname, schema="none", schema_version=(1, 0),
                           comm=comm)
    for frame in range(2):
        w.write_frame({"log/d": garr + float(frame)}, step=frame)
    # in-session read (metadata replication across processes)
    numpy.testing.assert_array_equal(
        w.file.read_chunk(1, "log/d"), data + 1.0)
    w.close()

    # ---- sharded read-back: per-device stripe preads reassemble the
    # global array with the writer's partitioning ----
    f = tpgsd.fl.open(fname, "r")
    back = read_sharded_chunk(f, 0, "log/d", sharding)
    assert back.sharding.is_equivalent_to(sharding, back.ndim)
    for shard in back.addressable_shards:
        numpy.testing.assert_array_equal(
            numpy.asarray(shard.data), data[shard.index])
    f.close()

    # ---- distributed slab SPH step over the pod mesh + dump cycle ----
    from jax.experimental import multihost_utils
    from tpgsd.sph import SPHParams, SPHState, distribute_state
    from tpgsd.sph import make_distributed_step_fn, make_step_fn
    from tpgsd.sph.cells import CellGrid

    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25,
                    dims=(4 * nprocs, 4, 4), capacity=16)
    rng = numpy.random.RandomState(7)
    n = 40 * nprocs
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= nprocs
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    params = SPHParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    state = SPHState(x=jnp.asarray(x), v=jnp.asarray(v))

    step_ref = jax.jit(make_step_fn(grid, params))
    s_ref = state
    for _ in range(2):
        s_ref, _aux = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(grid, params, mesh, capacity=cap)
    wri = ShardedFrameWriter(fname + ".traj", comm=comm)
    for s in range(2):
        dist, aux = step_d(dist)
        wri.write_frame(
            {"particles/position": dist.x, "log/pid": dist.pid}, step=s)
    wri.close()

    movf = multihost_utils.process_allgather(aux.migrate_overflow, tiled=True)
    covf = multihost_utils.process_allgather(aux.cell_overflow, tiled=True)
    assert movf.sum() == 0 and covf.sum() == 0
    xg = multihost_utils.process_allgather(dist.x, tiled=True)
    pidg = multihost_utils.process_allgather(dist.pid, tiled=True)
    alive = pidg >= 0
    assert alive.sum() == n and len(set(pidg[alive].tolist())) == n
    out_x = numpy.zeros((n, 3), numpy.float32)
    out_x[pidg[alive]] = xg[alive]
    numpy.testing.assert_allclose(
        out_x, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5)
    print("proc", pid, "CAP", cap, "OK")
    """
)


@pytest.mark.parametrize("nprocs", [2])
def test_pod_shape_write_read_sph(tmp_path, nprocs):
    """Pod shape: 2 processes x 4 local devices each.  One global mesh
    spans both; each process writes ONLY its addressable shards at
    their sharding-derived offsets while the controller commits the
    metadata; the sharded read-back reassembles the partitioning; and
    the slab SPH step + dump cycle runs over the same mesh - the full
    multi-host composition in one worker."""
    n = 40 * nprocs
    fname = str(tmp_path / "pod.gsd")
    procs, outputs = _launch(tmp_path, POD_WORKER, nprocs, fname)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-2000:]
        assert "OK" in out

    with tpgsd.pypgsd.PGSDFile(open(fname, "rb")) as f:
        assert f.nframes == 2
        total = 5 * 4 * nprocs
        data = numpy.arange(total * 2, dtype=numpy.float64).reshape(total, 2)
        for frame in range(2):
            numpy.testing.assert_array_equal(
                f.read_chunk(frame, "log/d"), data + frame)
    with tpgsd.pypgsd.PGSDFile(open(fname + ".traj", "rb")) as f:
        assert f.nframes == 2
        pid = f.read_chunk(1, "log/pid")
        alive = pid >= 0
        assert alive.sum() == n
        assert sorted(pid[alive].tolist()) == list(range(n))
    with open(fname, "rb") as fobj:
        report = tpgsd.pypgsd.verify(fobj, deep=True)
    assert report["ok"], report["errors"]
