"""Distributed (slab + halo exchange) SPH vs the single-device step.

Runs on the 8-device virtual CPU mesh; the same code paths drive real
multi-device meshes (ppermute between devices).
"""

import numpy
import numpy.testing
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpgsd.parallel import make_mesh  # noqa: E402
from tpgsd.sph import SPHParams, SPHState, dam_break, make_step_fn  # noqa: E402
from tpgsd.sph.cells import make_grid  # noqa: E402
from tpgsd.sph.distributed import (  # noqa: E402
    collect_state,
    distribute_state,
    make_distributed_step_fn,
)


@pytest.fixture(scope="module")
def setup():
    # grid with nx divisible by 8: dam break in a long box
    db = dam_break(n_side=6, box=(4.0, 0.5, 0.5), fill=(0.5, 1.0, 1.0))
    grid = db.grid
    if grid.dims[0] % 8 != 0:
        # rebuild with nx forced to a multiple of 8
        support = 2.0 * db.params.h
        nx = (grid.dims[0] // 8 + 1) * 8
        cell = 4.0 / nx
        assert cell >= 0  # geometry sanity
        grid = make_grid((0, 0, 0), (4.0, 0.5, 0.5), support, grid.capacity)
    return db, grid


def test_grid_divisibility_guard(setup):
    db, grid = setup
    mesh = make_mesh()
    if grid.dims[0] % 8 != 0:
        with pytest.raises(ValueError, match="multiple of the mesh"):
            make_distributed_step_fn(grid, db.params, mesh, capacity=64)
        pytest.skip("grid nx not divisible; guard verified")


def _divisible_setup():
    """Dam break whose grid has nx divisible by 8."""
    db = dam_break(n_side=8, box=(4.0, 0.5, 0.5), fill=(0.4, 1.0, 1.0))
    grid = db.grid
    nx = grid.dims[0]
    if nx % 8 != 0:
        # shrink the box in x so nx lands on a multiple of 8
        nx8 = (nx // 8) * 8
        assert nx8 >= 8
        new_lx = nx8 * grid.cell_size
        keep = numpy.asarray(db.state.x)[:, 0] < new_lx * 0.95
        x = numpy.asarray(db.state.x)[keep]
        from tpgsd.sph.cells import CellGrid

        grid = CellGrid(
            lo=grid.lo, cell_size=grid.cell_size,
            dims=(nx8, grid.dims[1], grid.dims[2]), capacity=grid.capacity,
        )
        state = SPHState(x=jnp.asarray(x), v=jnp.zeros_like(jnp.asarray(x)))
        return state, grid, db.params
    return db.state, grid, db.params


def test_distributed_matches_single_device():
    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()

    # reference: single-device global step
    step_ref = jax.jit(make_step_fn(grid, params))
    s_ref = state
    for _ in range(3):
        s_ref, (rho_ref, p_ref, _) = step_ref(s_ref)

    # distributed: slab + halo + migration
    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(grid, params, mesh, capacity=cap)
    for _ in range(3):
        dist, aux = step_d(dist)

    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    # all particles accounted for exactly once
    pid = numpy.asarray(dist.pid)
    alive = pid[pid >= 0]
    assert len(alive) == n
    assert len(set(alive.tolist())) == n

    x_d, v_d, _ = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


def test_migration_across_slabs():
    """A particle pushed across a slab face must arrive at the neighbor
    device with identity intact."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    support = 0.5
    grid = make_grid((0, 0, 0), (8.0, 1.0, 1.0), support, capacity=16)
    assert grid.dims[0] % n_dev == 0
    params = SPHParams(mass=1.0, h=0.25, dt=0.1, gravity=(0.0, 0.0, 0.0))

    # two isolated particles moving right at 1 unit/step*dt
    x = jnp.asarray([[0.95, 0.5, 0.5], [4.05, 0.5, 0.5]], jnp.float32)
    v = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    state = SPHState(x=x, v=v)
    dist, cap = distribute_state(state, grid, mesh, capacity=8)
    step = make_distributed_step_fn(grid, params, mesh, capacity=8)

    for _ in range(2):
        dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, 2)
    # both particles moved right ~0.2 and kept their ids
    numpy.testing.assert_allclose(x_d[0, 0], 0.95 + 0.2, rtol=1e-5)
    numpy.testing.assert_allclose(x_d[1, 0], 4.05 + 0.2, rtol=1e-5)


def test_distributed_boundary_particles():
    """A floor of fixed boundary particles (pid < n_fixed) must act as
    density/pressure sources on every slab but never move or migrate;
    results must match the single-device n_fixed path."""
    mesh = make_mesh()
    n_dev = mesh.devices.size

    dx = 0.1
    h = 1.3 * dx
    support = 2.0 * h
    nx_cells = n_dev * 2  # divisible by the mesh
    lx = nx_cells * support
    ly = 0.2  # thin in y: keeps cell occupancy < 64 (fast compile)
    box = (lx, ly, 0.5)

    # floor: one plane of fixed particles spanning the whole box
    gx, gy = numpy.meshgrid(
        numpy.arange(dx / 2, lx, dx), numpy.arange(dx / 2, ly, dx),
        indexing="ij",
    )
    wall = numpy.stack(
        [gx.ravel(), gy.ravel(), numpy.full(gx.size, dx / 2)], axis=1
    ).astype(numpy.float32)
    # fluid: a small block above the floor, mid-domain
    fx, fy, fz = numpy.meshgrid(
        numpy.arange(lx * 0.3, lx * 0.7, dx),
        numpy.arange(dx / 2, ly, dx),
        numpy.arange(1.5 * dx, 1.5 * dx + 4 * dx, dx),
        indexing="ij",
    )
    fluid = numpy.stack([fx.ravel(), fy.ravel(), fz.ravel()], axis=1).astype(
        numpy.float32
    )
    x0 = numpy.concatenate([wall, fluid])
    n_fixed = wall.shape[0]
    n = x0.shape[0]

    from tpgsd.sph.cells import CellGrid

    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=support,
                    dims=(nx_cells, 1, max(1, int(0.5 / support))),
                    capacity=64)
    params = SPHParams(
        mass=1000.0 * dx**3, h=h, dt=2e-4, c0=30.0, alpha=0.3
    )
    state = SPHState(x=jnp.asarray(x0), v=jnp.zeros_like(jnp.asarray(x0)))

    step_ref = jax.jit(make_step_fn(grid, params, n_fixed=n_fixed))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, n_fixed=n_fixed
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, n)
    # fixed particles exactly where they started, zero velocity
    numpy.testing.assert_array_equal(x_d[:n_fixed], x0[:n_fixed])
    numpy.testing.assert_array_equal(v_d[:n_fixed], 0.0)
    # whole state matches the single-device n_fixed rollout
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


def test_periodic_ring_migration():
    """A particle crossing the global x seam wraps around the ring:
    identity intact, position wrapped, delivered to the far slab."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    support = 0.5
    grid = make_grid((0, 0, 0), (8.0, 1.0, 1.0), support, capacity=16)
    assert grid.dims[0] % n_dev == 0
    params = SPHParams(mass=1.0, h=0.25, dt=0.1, gravity=(0.0, 0.0, 0.0))

    # one particle moving left past x=0, one moving right past x=8;
    # offset in y/z so they are NOT in each other's (seam-wrapped)
    # support radius - this test checks kinematics, not forces
    x = jnp.asarray([[0.05, 0.2, 0.2], [7.95, 0.8, 0.8]], jnp.float32)
    v = jnp.asarray([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    dist, cap = distribute_state(SPHState(x=x, v=v), grid, mesh, capacity=8)
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=8, periodic=True
    )
    dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, 2)
    numpy.testing.assert_allclose(x_d[0, 0], 8.0 - 0.05, rtol=1e-5)
    numpy.testing.assert_allclose(x_d[1, 0], 0.05, rtol=1e-4, atol=1e-5)
    # identities preserved through the ring
    pid = numpy.asarray(dist.pid)
    assert set(pid[pid >= 0].tolist()) == {0, 1}


def test_periodic_distributed_matches_single_device():
    """Periodic Taylor-Green on the slab ring == single-device periodic
    step (the seam pairs flow through the ring halo + min-image)."""
    from tpgsd.sph import taylor_green

    mesh = make_mesh()
    n_dev = mesh.devices.size
    sc = taylor_green(n_side=21)  # dims_x = 8 = mesh size
    assert sc.grid.dims[0] % n_dev == 0, sc.grid.dims

    step_ref = jax.jit(make_step_fn(sc.grid, sc.params, periodic=True))
    s_ref = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    for _ in range(3):
        s_ref, (rho_ref, _, _) = step_ref(s_ref)

    dist, cap = distribute_state(
        SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v)),
        sc.grid,
        mesh,
    )
    step_d = make_distributed_step_fn(
        sc.grid, sc.params, mesh, capacity=cap, periodic=True
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, sc.n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


def test_distributed_energy_matches_single_device():
    """compute_energy=True: the slab step's aux.dudt equals the
    single-device energy_rate of the same (pre-step) configuration."""
    from tpgsd.sph import energy_rate

    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()

    # give the fluid some motion so pressure work is nonzero
    rng = numpy.random.RandomState(4)
    v0 = jnp.asarray(rng.randn(n, 3).astype(numpy.float32) * 0.1)
    state = SPHState(x=state.x, v=v0)

    du_ref = numpy.asarray(energy_rate(state, grid, params))

    dist, cap = distribute_state(state, grid, mesh)
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, compute_energy=True
    )
    dist_after, aux = step(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0

    # map per-slot dudt back to original particle order via the
    # PRE-step pids (dudt describes the configuration entering the step)
    pid = numpy.asarray(dist.pid)
    du = numpy.asarray(aux.dudt)
    out = numpy.zeros(n, numpy.float32)
    alive = pid >= 0
    out[pid[alive]] = du[alive]

    scale = numpy.abs(du_ref).max() or 1.0
    numpy.testing.assert_allclose(
        out / scale, du_ref / scale, rtol=1e-4, atol=1e-4
    )

    # default: no energy pass, dudt stays zero
    step0 = make_distributed_step_fn(grid, params, mesh, capacity=cap)
    _, aux0 = step0(dist)
    assert float(jnp.abs(aux0.dudt).max()) == 0.0


def test_scan_simulate_distributed(tmp_path):
    """Full-stack composition: a lax.scan rollout over the slab-
    decomposed shard_map step with in-jit frame dumps."""
    from tpgsd.io_runtime import JitDumpChannel, scan_simulate
    from tpgsd.parallel import ShardedFrameWriter

    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()
    dist, cap = distribute_state(state, grid, mesh)
    step = make_distributed_step_fn(grid, params, mesh, capacity=cap)

    import tpgsd.hoomd

    path = tmp_path / "dist_scan.gsd"
    channel = JitDumpChannel(
        ShardedFrameWriter(path), ["particles/position", "particles/density"]
    )
    final = scan_simulate(
        step,
        dist,
        n_steps=4,
        channel=channel,
        frame_of=lambda s, aux: [s.x, aux.rho],
        every=2,
    )
    channel.close()

    with tpgsd.hoomd.open(path, mode="r") as traj:
        assert len(traj) == 2
        pos = traj[1].particles.position
        assert pos.shape[0] == final.x.shape[0]
        assert numpy.isfinite(pos).all()
    x_d, v_d, _ = collect_state(final, n)
    assert numpy.isfinite(x_d).all()


def test_insert_compacts_receive_buffer():
    """_insert must rank arriving migrants by order among VALID rows,
    not raw buffer position: a migrant landing in the right-hand
    (from-right) block of the stacked receive buffer still takes the
    first free slot (regression: it used to need dead-slot rank ==
    buffer position, silently dropping it on busy slabs)."""
    from tpgsd.sph.distributed import _insert

    n, mig_cap = 8, 2
    values = jnp.arange(n, dtype=jnp.float32)[:, None] * 0  # zeros [8,1]
    alive = jnp.asarray([True] * 6 + [False] * 2)  # 2 free slots
    # one valid migrant, arriving at position mig_cap (right block)
    recv_vals = jnp.zeros((2 * mig_cap, 1), jnp.float32)
    recv_vals = recv_vals.at[mig_cap, 0].set(42.0)
    recv_valid = jnp.zeros(2 * mig_cap, bool).at[mig_cap].set(True)

    merged, lost = _insert(values, alive, recv_vals, recv_valid)
    assert int(lost) == 0
    assert float(merged[6, 0]) == 42.0  # first dead slot, not dropped

    # and when NO free slot exists the loss is counted, not silent
    merged2, lost2 = _insert(values, jnp.ones(n, bool), recv_vals, recv_valid)
    assert int(lost2) == 1
    numpy.testing.assert_array_equal(numpy.asarray(merged2), numpy.zeros((n, 1)))


def test_left_migration_into_busy_slab():
    """A left-moving migrant (right receive block) must be inserted even
    when the destination slab already holds particles (regression for
    the positional dead-slot indexing bug)."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    support = 0.5
    grid = make_grid((0, 0, 0), (8.0, 1.0, 1.0), support, capacity=16)
    assert grid.dims[0] % n_dev == 0
    params = SPHParams(mass=1.0, h=0.05, dt=0.1, gravity=(0.0, 0.0, 0.0))

    # slab 0 (x in [0,1)) pre-loaded with 6 stationary residents spread
    # in y/z (far apart vs h so forces are nil), plus one particle in
    # slab 1 moving LEFT across the face at x=1
    residents = numpy.stack(
        [
            numpy.full(6, 0.5, numpy.float32),
            numpy.linspace(0.1, 0.9, 6, dtype=numpy.float32),
            numpy.asarray([0.2, 0.8] * 3, numpy.float32),
        ],
        axis=1,
    )
    x = numpy.concatenate([residents, [[1.02, 0.5, 0.5]]]).astype(numpy.float32)
    v = numpy.zeros_like(x)
    v[6, 0] = -1.0
    dist, cap = distribute_state(
        SPHState(x=jnp.asarray(x), v=jnp.asarray(v)), grid, mesh, capacity=8
    )
    step = make_distributed_step_fn(grid, params, mesh, capacity=8)

    dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0
    pid = numpy.asarray(dist.pid)
    # all 7 identities survive; the migrant now lives on device 0
    assert set(pid[pid >= 0].tolist()) == set(range(7))
    assert 6 in pid[:8].tolist()  # device 0's slots hold pid 6 now


def test_y_decomposition_matches_x():
    """Taylor-Green under y-slabs == x-slabs == single device: the
    transposed decomposition (decomp_axis=1) must reproduce the same
    trajectory, including the periodic ring seam along y."""
    from tpgsd.sph import taylor_green

    mesh = make_mesh()
    n_dev = mesh.devices.size
    sc = taylor_green(n_side=21)
    assert sc.grid.dims[1] % n_dev == 0, sc.grid.dims

    step_ref = jax.jit(make_step_fn(sc.grid, sc.params, periodic=True))
    s_ref = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    results = {}
    for axis in (0, 1):
        dist, cap = distribute_state(
            SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v)),
            sc.grid,
            mesh,
            decomp_axis=axis,
        )
        step_d = make_distributed_step_fn(
            sc.grid, sc.params, mesh, capacity=cap, periodic=True,
            decomp_axis=axis,
        )
        for _ in range(3):
            dist, aux = step_d(dist)
        assert int(jnp.sum(aux.cell_overflow)) == 0
        assert int(jnp.sum(aux.migrate_overflow)) == 0
        results[axis] = collect_state(dist, sc.n)

    for axis in (0, 1):
        numpy.testing.assert_allclose(
            results[axis][0], numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
        )
        numpy.testing.assert_allclose(
            results[axis][1], numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
        )
    # x- and y-decomposition agree with each other even tighter
    numpy.testing.assert_allclose(
        results[0][0], results[1][0], rtol=1e-5, atol=1e-6
    )


def test_periodic_distributed_pallas_matches_jnp():
    """Slab step with the Triton kernels (interpret mode on the CPU
    mesh) under a periodic box: y/z wrap by the kernels' minimum image,
    x through the ring - must match the jnp slab step."""
    from tpgsd.sph import taylor_green

    mesh = make_mesh()
    sc = taylor_green(n_side=21)

    def run(**kw):
        dist, cap = distribute_state(
            SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v)),
            sc.grid,
            mesh,
        )
        step_d = make_distributed_step_fn(
            sc.grid, sc.params, mesh, capacity=cap, periodic=True, **kw
        )
        for _ in range(2):
            dist, aux = step_d(dist)
        return collect_state(dist, sc.n)

    x_j, v_j, _ = run()
    x_p, v_p, _ = run(use_pallas=True, pallas_interpret=True)
    numpy.testing.assert_allclose(x_p, x_j, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(v_p, v_j, rtol=5e-4, atol=5e-4)


def test_xsph_distributed_matches_single_device():
    """The slab step's XSPH pass (over halo-exchanged velocities) must
    reproduce the single-device xsph trajectory."""
    mesh = make_mesh()
    db = dam_break(n_side=8, box=(4.0, 0.5, 0.5), fill=(0.4, 1.0, 1.0))

    step_ref = jax.jit(make_step_fn(db.grid, db.params, xsph=0.5))
    s_ref = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state(
        SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v)),
        db.grid, mesh,
    )
    step_d = make_distributed_step_fn(
        db.grid, db.params, mesh, capacity=cap, xsph=0.5
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0
    x_d, v_d, _ = collect_state(dist, db.n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=1e-5
    )


def test_periodic_yz_wrap_commits_to_state():
    """A particle crossing a periodic y boundary must come back wrapped
    in the stored state - retaining raw coordinates (which the x seam
    overflow rule wants on the MIGRATION axis only) would let a y drift
    grow without bound and put the particle in the wrong cell row."""
    from tpgsd.sph import SPHParams
    from tpgsd.sph.cells import CellGrid

    mesh = make_mesh()
    n_dev = mesh.devices.size
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25,
                    dims=(n_dev, 4, 4), capacity=8)
    params = SPHParams(mass=0.01, h=0.12, dt=0.05, gravity=(0.0, 0.0, 0.0),
                       alpha=0.0)

    n = n_dev * 8
    x = numpy.full((n, 3), -1.0, numpy.float32)  # most slots unused
    v = numpy.zeros((n, 3), numpy.float32)
    # one isolated particle per device, moving +y at 1.0
    for dv in range(n_dev):
        x[dv * 8] = [(dv + 0.5) * 0.25, 0.95, 0.5]
        v[dv * 8] = [0.0, 1.0, 0.0]
    pid = numpy.full(n, -1, numpy.int32)
    pid[::8] = numpy.arange(n_dev)

    from tpgsd.sph.distributed import DistState

    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("shard")
    )
    dist = DistState(
        x=jax.device_put(jnp.asarray(x), sharding),
        v=jax.device_put(jnp.asarray(v), sharding),
        pid=jax.device_put(jnp.asarray(pid), sharding),
    )
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=8, periodic=True
    )
    for _ in range(12):
        dist, aux = step(dist)
    ys = numpy.asarray(dist.x)[numpy.asarray(dist.pid) >= 0, 1]
    # 12 steps x dt 0.05 x v 1.0 = 0.6 of travel from y=0.95 -> wraps
    # past 1.0; stored y must be inside the box
    assert (ys >= 0.0).all() and (ys <= 1.0).all(), ys


def test_adaptive_distributed_matches_fixed_at_same_dt():
    """The adaptive distributed step advanced with dt == params.dt must
    reproduce the fixed distributed step exactly - dt is a traced
    operand of the SAME compiled slab physics."""
    from tpgsd.sph.distributed import make_adaptive_distributed_step_fn

    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()

    dist_f, cap = distribute_state(state, grid, mesh)
    dist_a = dist_f
    step_f = make_distributed_step_fn(grid, params, mesh, capacity=cap)
    step_a = make_adaptive_distributed_step_fn(
        grid, params, mesh, capacity=cap
    )

    dt = jnp.float32(params.dt)
    for _ in range(3):
        dist_f, aux_f = step_f(dist_f)
        dist_a, aux_a, _dt_next = step_a(dist_a, dt)

    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.x), numpy.asarray(dist_f.x)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.v), numpy.asarray(dist_f.v)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.pid), numpy.asarray(dist_f.pid)
    )
    x_a, _, _ = collect_state(dist_a, n)
    assert numpy.isfinite(x_a).all()


def test_adaptive_distributed_controller_matches_single_device():
    """The globally-reduced controller must produce (nearly) the same
    dt_next as the single-device adaptive step on the same problem -
    the max-|acc| / max-|v| reductions see identical physics, just
    sharded."""
    from tpgsd.sph import make_adaptive_step_fn
    from tpgsd.sph.distributed import make_adaptive_distributed_step_fn

    state, grid, params = _divisible_setup()
    mesh = make_mesh()

    step_1 = jax.jit(make_adaptive_step_fn(grid, params, cfl=0.3))
    s1, _, dt1 = step_1(state, jnp.float32(params.dt))

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_adaptive_distributed_step_fn(
        grid, params, mesh, capacity=cap, cfl=0.3
    )
    _dist, _aux, dtd = step_d(dist, jnp.float32(params.dt))

    numpy.testing.assert_allclose(float(dtd), float(dt1), rtol=1e-4)


def test_adaptive_distributed_rollout_with_migration():
    """run_adaptive composes with DistState (a pytree): a scan rollout
    long enough for slab crossings stays finite, conserves particle
    identity, and keeps dt within bounds."""
    from tpgsd.sph import run_adaptive
    from tpgsd.sph.distributed import make_adaptive_distributed_step_fn

    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()

    dist, cap = distribute_state(state, grid, mesh)
    step = make_adaptive_distributed_step_fn(
        grid, params, mesh, capacity=cap, cfl=0.3
    )
    dist, dt, t = jax.jit(
        lambda d: run_adaptive(step, d, params.dt, 12)
    )(dist)

    assert 0.0 < float(dt) <= float(jnp.float32(params.dt))
    assert float(t) > 0.0
    pid = numpy.asarray(dist.pid)
    alive = pid[pid >= 0]
    assert len(alive) == n and len(set(alive.tolist())) == n
    x_d, _, _ = collect_state(dist, n)
    assert numpy.isfinite(x_d).all()


def test_adaptive_distributed_y_decomposition():
    """decomp_axis=1 threads the traced dt through the axis-swap
    wrapper; controller output matches the x decomposition."""
    from tpgsd.sph.distributed import make_adaptive_distributed_step_fn

    mesh = make_mesh()
    n_dev = mesh.devices.size

    # wide-y domain, same construction as test_y_decomposition_matches_x
    db = dam_break(n_side=8, box=(0.5, 4.0, 0.5), fill=(1.0, 0.4, 1.0))
    grid = db.grid
    if grid.dims[1] % n_dev != 0:
        pytest.skip("grid ny not divisible by the mesh")
    state = db.state

    dist, cap = distribute_state(state, grid, mesh, decomp_axis=1)
    step = make_adaptive_distributed_step_fn(
        grid, db.params, mesh, capacity=cap, decomp_axis=1, cfl=0.3
    )
    dt = jnp.float32(db.params.dt)
    for _ in range(3):
        dist, aux, dt = step(dist, dt)
    assert 0.0 < float(dt) <= float(jnp.float32(db.params.dt))
    assert int(jnp.sum(aux.cell_overflow)) == 0
    x_d, _, _ = collect_state(dist, state.x.shape[0])
    assert numpy.isfinite(x_d).all()


def test_density_renorm_matches_single_device():
    """density_renorm on the slab mesh matches the single-device renorm
    step: the free-surface floor is applied to owner densities before
    the rho/p plane exchange, so ghost planes carry it too."""
    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()

    step_ref = jax.jit(make_step_fn(grid, params, density_renorm=True))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_renorm=True
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0
    # the floor is ACTIVE here (free surfaces everywhere on the block)
    pid = numpy.asarray(dist.pid)
    rho = numpy.asarray(aux.rho)
    assert (rho[pid >= 0] >= params.rho0 - 1e-3).all()

    x_d, v_d, _ = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


def test_surface_tension_matches_single_device():
    """surface_tension on the slab mesh: normals are owner-exchanged
    like rho/p before the force pass, so the trajectory matches the
    single-device Akinci step."""
    state, grid, params = _divisible_setup()
    n = state.x.shape[0]
    mesh = make_mesh()
    gamma = 0.5

    step_ref = jax.jit(make_step_fn(grid, params, surface_tension=gamma))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, surface_tension=gamma
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


# ---------------------------------------------------------------------------
# continuity-density mode: rho as carried, migrating state
# ---------------------------------------------------------------------------


def test_continuity_distributed_matches_single_device():
    """Continuity mode on slabs: density is carried state, so ghost
    densities are exact by construction - positions, velocities AND the
    evolved density must match the single-device continuity step."""
    from tpgsd.sph import init_density

    state, grid, params = _divisible_setup()
    state = init_density(state, grid, params)
    n = state.x.shape[0]
    mesh = make_mesh()

    step_ref = jax.jit(
        make_step_fn(grid, params, density_mode="continuity")
    )
    s_ref = state
    for _ in range(3):
        s_ref, (rho_ref, p_ref, _) = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    assert dist.rho is not None
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )
    for _ in range(3):
        dist, aux = step_d(dist)

    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, rho_d = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )
    numpy.testing.assert_allclose(
        rho_d, numpy.asarray(s_ref.rho), rtol=1e-4
    )
    # aux rho/p are slot-consistent post-migration: they agree with the
    # carried state exactly
    pid = numpy.asarray(dist.pid)
    alive = pid >= 0
    numpy.testing.assert_array_equal(
        numpy.asarray(aux.rho)[alive], numpy.asarray(dist.rho)[alive]
    )


def test_continuity_distributed_pallas_matches_jnp():
    """Continuity slabs on the fused accel+drho Pallas kernel (interpret
    mode on the CPU mesh) vs the decomposed jnp pair path: same halo
    rounds, same migration - only the pair sweep differs."""
    from tpgsd.sph import init_density

    state, grid, params = _divisible_setup()
    state = init_density(state, grid, params)
    n = state.x.shape[0]
    mesh = make_mesh()

    def run(**kw):
        dist, cap = distribute_state(state, grid, mesh)
        step_d = make_distributed_step_fn(
            grid, params, mesh, capacity=cap, density_mode="continuity",
            **kw,
        )
        for _ in range(2):
            dist, aux = step_d(dist)
        assert int(jnp.sum(aux.migrate_overflow)) == 0
        return collect_state(dist, n)

    x_j, v_j, r_j = run()
    x_p, v_p, r_p = run(use_pallas=True, pallas_interpret=True)
    # x atol is wider than the summation-mode pallas tests': positions
    # integrate a density that itself integrates the noisier drho
    numpy.testing.assert_allclose(x_p, x_j, rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(v_p, v_j, rtol=5e-4, atol=5e-4)
    # carried density integrates the drho column; the kernel sums the
    # 27 neighbour cells in another order than the jnp blocks
    numpy.testing.assert_allclose(r_p, r_j, rtol=5e-4)


def test_continuity_migration_carries_density():
    """A migrating particle's density travels in the migration payload
    and arrives bit-intact (isolated particles: drho/dt == 0)."""
    mesh = make_mesh()
    n_dev = mesh.devices.size
    support = 0.5
    grid = make_grid((0, 0, 0), (8.0, 1.0, 1.0), support, capacity=16)
    assert grid.dims[0] % n_dev == 0
    params = SPHParams(mass=1.0, h=0.25, dt=0.1, gravity=(0.0, 0.0, 0.0))

    x = jnp.asarray([[0.95, 0.5, 0.5], [4.05, 0.5, 0.5]], jnp.float32)
    v = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    # distinctive carried densities (well above the 0.1*rho0 floor)
    rho = jnp.asarray([1234.5, 987.25], jnp.float32)
    state = SPHState(x=x, v=v, rho=rho)
    dist, cap = distribute_state(state, grid, mesh, capacity=8)
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=8, density_mode="continuity",
        delta_sph=0.0,
    )

    for _ in range(2):
        dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, rho_d = collect_state(dist, 2)
    numpy.testing.assert_allclose(x_d[0, 0], 0.95 + 0.2, rtol=1e-5)
    numpy.testing.assert_allclose(x_d[1, 0], 4.05 + 0.2, rtol=1e-5)
    # isolated particles: the kernel support never overlaps, drho = 0,
    # the carried density crosses the slab face unchanged
    numpy.testing.assert_array_equal(
        rho_d, numpy.asarray([1234.5, 987.25], numpy.float32)
    )


def test_continuity_periodic_both_axes_matches_single_device():
    """Continuity mode under a periodic box, on x- AND y-slabs: the
    fused x|v|rho|p|mask halo rides the ring seam too."""
    from tpgsd.sph import init_density, taylor_green

    mesh = make_mesh()
    n_dev = mesh.devices.size
    sc = taylor_green(n_side=21)
    assert sc.grid.dims[1] % n_dev == 0, sc.grid.dims

    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    state = init_density(state, sc.grid, sc.params, periodic=True)

    step_ref = jax.jit(
        make_step_fn(
            sc.grid, sc.params, periodic=True, density_mode="continuity"
        )
    )
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    results = {}
    for axis in (0, 1):
        dist, cap = distribute_state(state, sc.grid, mesh, decomp_axis=axis)
        step_d = make_distributed_step_fn(
            sc.grid, sc.params, mesh, capacity=cap, periodic=True,
            decomp_axis=axis, density_mode="continuity",
        )
        for _ in range(3):
            dist, aux = step_d(dist)
        assert int(jnp.sum(aux.cell_overflow)) == 0
        assert int(jnp.sum(aux.migrate_overflow)) == 0
        results[axis] = collect_state(dist, sc.n)

    for axis in (0, 1):
        x_d, v_d, rho_d = results[axis]
        numpy.testing.assert_allclose(
            x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
        )
        numpy.testing.assert_allclose(
            v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
        )
        numpy.testing.assert_allclose(
            rho_d, numpy.asarray(s_ref.rho), rtol=1e-4
        )
    numpy.testing.assert_allclose(
        results[0][2], results[1][2], rtol=1e-5
    )


def test_continuity_adaptive_matches_fixed_at_same_dt():
    """Adaptive continuity slab step at dt == params.dt reproduces the
    fixed continuity step exactly (dt is a traced operand)."""
    from tpgsd.sph import init_density
    from tpgsd.sph.distributed import make_adaptive_distributed_step_fn

    state, grid, params = _divisible_setup()
    state = init_density(state, grid, params)
    mesh = make_mesh()

    dist_f, cap = distribute_state(state, grid, mesh)
    dist_a = dist_f
    step_f = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )
    step_a = make_adaptive_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )

    dt = jnp.float32(params.dt)
    for _ in range(3):
        dist_f, aux_f = step_f(dist_f)
        dist_a, aux_a, _dt_next = step_a(dist_a, dt)

    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.x), numpy.asarray(dist_f.x)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.rho), numpy.asarray(dist_f.rho)
    )


def test_continuity_distributed_guards():
    """Composition guards match the single-device builder's."""
    state, grid, params = _divisible_setup()
    mesh = make_mesh()
    with pytest.raises(ValueError, match="density_renorm"):
        make_distributed_step_fn(
            grid, params, mesh, capacity=64, density_mode="continuity",
            density_renorm=True,
        )
    # continuity + the Triton kernels: the builder constructs with the
    # fused accel_drho kernel on the ext grid
    make_distributed_step_fn(
        grid, params, mesh, capacity=64, density_mode="continuity",
        use_pallas=True,
    )
    with pytest.raises(ValueError, match="density_mode"):
        make_distributed_step_fn(
            grid, params, mesh, capacity=64, density_mode="bogus"
        )
    # a continuity step without a seeded rho fails loudly
    dist, cap = distribute_state(state, grid, mesh)
    step = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )
    with pytest.raises(ValueError, match="init_density"):
        step(dist)


def test_continuity_distributed_composes_xsph_st_energy():
    """Continuity slabs with XSPH + surface tension match the
    single-device continuity step built the same way; compute_energy
    rides along and produces finite, active du/dt."""
    from tpgsd.sph import init_density

    state, grid, params = _divisible_setup()
    state = init_density(state, grid, params)
    n = state.x.shape[0]
    mesh = make_mesh()

    step_ref = jax.jit(
        make_step_fn(
            grid, params, density_mode="continuity", xsph=0.3,
            surface_tension=0.05,
        )
    )
    s_ref = state
    for _ in range(2):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state(state, grid, mesh)
    step_d = make_distributed_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity",
        xsph=0.3, surface_tension=0.05, compute_energy=True,
    )
    for _ in range(2):
        dist, aux = step_d(dist)

    x_d, v_d, rho_d = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )
    numpy.testing.assert_allclose(
        rho_d, numpy.asarray(s_ref.rho), rtol=2e-4
    )
    dudt = numpy.asarray(aux.dudt)
    assert numpy.isfinite(dudt).all()
    assert numpy.abs(dudt).max() > 0.0
