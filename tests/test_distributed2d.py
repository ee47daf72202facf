"""2-D block-decomposed distributed SPH vs the single-device and 1-D
slab steps.

Runs on the 8-device virtual CPU mesh reshaped to (4, 2) / (2, 2) /
(8, 1) grids; the same code paths drive a real 2-D device mesh.
"""

import numpy
import numpy.testing
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpgsd.parallel import make_mesh, make_mesh2d  # noqa: E402
from tpgsd.sph import (  # noqa: E402
    SPHParams,
    SPHState,
    collect_state,
    distribute_state,
    distribute_state_2d,
    make_distributed_step_fn,
    make_distributed2d_step_fn,
    make_step_fn,
    taylor_green,
)
from tpgsd.sph.cells import CellGrid  # noqa: E402


def _cloud_setup(seed=0, n=160):
    """Random particle cloud on a (8, 4, 4)-cell grid divisible by a
    (4, 2) mesh; physics parity does not need a physical scenario."""
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 4, 4),
                    capacity=16)
    rng = numpy.random.RandomState(seed)
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(numpy.float32)
    x[:, 0] *= 2.0  # box is 2 x 1 x 1
    v = (rng.randn(n, 3) * 0.05).astype(numpy.float32)
    params = SPHParams(mass=2.0, h=0.12, dt=1e-3, c0=20.0,
                       gravity=(0.0, 0.0, -9.81))
    state = SPHState(x=jnp.asarray(x), v=jnp.asarray(v))
    return state, grid, params


def test_mesh2d_shape_default():
    mesh = make_mesh2d()
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("sx", "sy")


def test_grid_divisibility_guard():
    state, grid, params = _cloud_setup()
    mesh = make_mesh2d(shape=(4, 2))
    bad = CellGrid(lo=grid.lo, cell_size=grid.cell_size, dims=(6, 4, 4),
                   capacity=16)
    with pytest.raises(ValueError, match="multiples of the mesh"):
        make_distributed2d_step_fn(bad, params, mesh, capacity=64)
    with pytest.raises(ValueError, match="2-D mesh"):
        make_distributed2d_step_fn(grid, params, make_mesh(), capacity=64)


def test_2d_matches_single_device():
    state, grid, params = _cloud_setup()
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))

    step_ref = jax.jit(make_step_fn(grid, params))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_distributed2d_step_fn(grid, params, mesh, capacity=cap)
    for _ in range(3):
        dist, aux = step_d(dist)

    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    pid = numpy.asarray(dist.pid)
    alive = pid[pid >= 0]
    assert len(alive) == n and len(set(alive.tolist())) == n

    x_d, v_d, _ = collect_state(dist, n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        v_d, numpy.asarray(s_ref.v), rtol=5e-3, atol=5e-3
    )


def test_2d_migration_x_y_and_diagonal():
    """Particles crossing an x face, a y face, and a corner (both faces
    in one step) must arrive with identity intact; the diagonal mover
    completes both hops in a single step."""
    mesh = make_mesh2d(shape=(2, 2))
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.5, dims=(4, 2, 2),
                    capacity=16)
    params = SPHParams(mass=1.0, h=0.1, dt=0.1, gravity=(0.0, 0.0, 0.0))

    # block faces at x=1.0 and y=0.5; particles isolated (h << spacing)
    x = jnp.asarray(
        [
            [0.95, 0.25, 0.2],  # -> +x across the x face
            [0.30, 0.45, 0.8],  # -> +y across the y face
            [0.98, 0.48, 0.5],  # -> diagonal: +x AND +y in one step
        ],
        jnp.float32,
    )
    v = jnp.asarray(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]], jnp.float32
    )
    dist, cap = distribute_state_2d(SPHState(x=x, v=v), grid, mesh,
                                    capacity=8)
    step = make_distributed2d_step_fn(grid, params, mesh, capacity=8)
    dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, 3)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(x) + 0.1 * numpy.asarray(v), rtol=1e-5
    )
    pid = numpy.asarray(dist.pid)
    assert set(pid[pid >= 0].tolist()) == {0, 1, 2}
    # the diagonal mover now lives on the (1, 1) block = device index 3
    blk = numpy.nonzero(pid == 2)[0][0] // cap
    assert blk == 3


def test_2d_periodic_corner_wrap():
    """A particle crossing BOTH periodic seams in one step wraps to the
    far corner: the x ring delivers the wrapped x, the y ring (same
    step) the wrapped y."""
    mesh = make_mesh2d(shape=(2, 2))
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(4, 4, 1),
                    capacity=16)
    params = SPHParams(mass=1.0, h=0.05, dt=0.1, gravity=(0.0, 0.0, 0.0))

    x = jnp.asarray([[0.04, 0.06, 0.1], [0.5, 0.5, 0.15]], jnp.float32)
    v = jnp.asarray([[-1.0, -1.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    dist, cap = distribute_state_2d(SPHState(x=x, v=v), grid, mesh,
                                    capacity=8)
    step = make_distributed2d_step_fn(grid, params, mesh, capacity=8,
                                      periodic=True)
    dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, _, _ = collect_state(dist, 2)
    numpy.testing.assert_allclose(x_d[0, 0], 0.94, rtol=1e-5)
    numpy.testing.assert_allclose(x_d[0, 1], 0.96, rtol=1e-5)
    pid = numpy.asarray(dist.pid)
    assert set(pid[pid >= 0].tolist()) == {0, 1}
    # it wrapped to the far-corner block (1, 1) = device index 3
    blk = numpy.nonzero(pid == 0)[0][0] // cap
    assert blk == 3


def test_2d_periodic_matches_single_device():
    """Periodic Taylor-Green on the (4, 2) block mesh == single-device
    periodic step: seam pairs (including corners) flow through the
    dimension-ordered ring halos."""
    sc = taylor_green(n_side=21)
    mesh = make_mesh2d(shape=(4, 2))
    assert sc.grid.dims[0] % 4 == 0 and sc.grid.dims[1] % 2 == 0

    step_ref = jax.jit(make_step_fn(sc.grid, sc.params, periodic=True))
    s_ref = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(
        SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v)),
        sc.grid, mesh,
    )
    step_d = make_distributed2d_step_fn(
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


def test_degenerate_mesh_matches_1d_slabs():
    """An (8, 1) block mesh is exactly the 1-D x-slab decomposition;
    the two implementations must agree to float tolerance."""
    state, grid, params = _cloud_setup(seed=3)
    n = state.x.shape[0]

    dist1, cap1 = distribute_state(state, grid, make_mesh())
    step1 = make_distributed_step_fn(grid, params, make_mesh(),
                                     capacity=cap1)
    for _ in range(3):
        dist1, _ = step1(dist1)
    x1, v1, _ = collect_state(dist1, n)

    mesh2 = make_mesh2d(shape=(8, 1))
    dist2, cap2 = distribute_state_2d(state, grid, mesh2, capacity=cap1)
    step2 = make_distributed2d_step_fn(grid, params, mesh2, capacity=cap1)
    for _ in range(3):
        dist2, aux = step2(dist2)
    assert int(jnp.sum(aux.migrate_overflow)) == 0
    x2, v2, _ = collect_state(dist2, n)

    numpy.testing.assert_allclose(x2, x1, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(v2, v1, rtol=1e-4, atol=1e-5)


def test_2d_energy_matches_single_device():
    """compute_energy=True on the block mesh: aux.dudt equals the
    single-device energy_rate of the pre-step configuration."""
    from tpgsd.sph import energy_rate

    state, grid, params = _cloud_setup(seed=7)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))

    du_ref = numpy.asarray(energy_rate(state, grid, params))

    dist, cap = distribute_state_2d(state, grid, mesh)
    step = make_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, compute_energy=True
    )
    dist_after, aux = step(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0

    pid = numpy.asarray(dist.pid)
    du = numpy.asarray(aux.dudt)
    out = numpy.zeros(n, numpy.float32)
    alive = pid >= 0
    out[pid[alive]] = du[alive]

    scale = numpy.abs(du_ref).max() or 1.0
    numpy.testing.assert_allclose(
        out / scale, du_ref / scale, rtol=1e-4, atol=1e-4
    )


def test_2d_fixed_boundary_particles():
    """n_fixed particles act as sources on every block but never move
    or migrate; trajectory matches the single-device n_fixed path."""
    state, grid, params = _cloud_setup(seed=11)
    n = state.x.shape[0]
    n_fixed = 24
    # fixed particles must start at rest to stay truly fixed
    v0 = numpy.array(state.v)
    v0[:n_fixed] = 0.0
    state = SPHState(x=state.x, v=jnp.asarray(v0))
    mesh = make_mesh2d(shape=(4, 2))

    step_ref = jax.jit(make_step_fn(grid, params, n_fixed=n_fixed))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, n_fixed=n_fixed
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, _ = collect_state(dist, n)
    numpy.testing.assert_array_equal(
        x_d[:n_fixed], numpy.asarray(state.x)[:n_fixed]
    )
    numpy.testing.assert_array_equal(v_d[:n_fixed], 0.0)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )


def test_2d_pallas_matches_jnp():
    """2-D block step with the Triton kernels (interpret mode on the
    CPU mesh): the extended-grid contract is the same one the 1-D slabs
    feed, so the kernels must reproduce the jnp block step modulo float
    reassociation."""
    state, grid, params = _cloud_setup(seed=5)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(2, 2))

    def run(**kw):
        dist, cap = distribute_state_2d(state, grid, mesh)
        step_d = make_distributed2d_step_fn(
            grid, params, mesh, capacity=cap, **kw
        )
        for _ in range(2):
            dist, aux = step_d(dist)
        assert int(jnp.sum(aux.migrate_overflow)) == 0
        return collect_state(dist, n)

    x_j, v_j, _ = run()
    x_p, v_p, _ = run(use_pallas=True, pallas_interpret=True)
    numpy.testing.assert_allclose(x_p, x_j, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(v_p, v_j, rtol=5e-4, atol=5e-4)


def test_2d_periodic_pallas_matches_jnp():
    """Periodic 2-D block step with the Triton kernels: x/y wraps ride
    the ring halos (the kernels see pre-shifted true geometry), the z
    wrap is the kernels' minimum image."""
    sc = taylor_green(n_side=21)
    mesh = make_mesh2d(shape=(4, 2))

    def run(**kw):
        dist, cap = distribute_state_2d(
            SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v)),
            sc.grid, mesh,
        )
        step_d = make_distributed2d_step_fn(
            sc.grid, sc.params, mesh, capacity=cap, periodic=True, **kw
        )
        for _ in range(2):
            dist, aux = step_d(dist)
        return collect_state(dist, sc.n)

    x_j, v_j, _ = run()
    x_p, v_p, _ = run(use_pallas=True, pallas_interpret=True)
    numpy.testing.assert_allclose(x_p, x_j, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(v_p, v_j, rtol=5e-4, atol=5e-4)


def test_2d_adaptive_matches_fixed_at_same_dt():
    """The adaptive 2-D block step advanced with dt == params.dt must
    reproduce the fixed 2-D step exactly - dt is a traced operand of
    the SAME compiled block physics."""
    from tpgsd.sph import make_adaptive_distributed2d_step_fn

    state, grid, params = _cloud_setup(seed=11)
    mesh = make_mesh2d(shape=(4, 2))

    dist_f, cap = distribute_state_2d(state, grid, mesh)
    dist_a = dist_f
    step_f = make_distributed2d_step_fn(grid, params, mesh, capacity=cap)
    step_a = make_adaptive_distributed2d_step_fn(
        grid, params, mesh, capacity=cap
    )

    dt = jnp.float32(params.dt)
    for _ in range(3):
        dist_f, _aux_f = step_f(dist_f)
        dist_a, _aux_a, _dt_next = step_a(dist_a, dt)

    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.x), numpy.asarray(dist_f.x)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.v), numpy.asarray(dist_f.v)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.pid), numpy.asarray(dist_f.pid)
    )


def test_2d_adaptive_controller_matches_single_device():
    """The (px, py)-mesh-reduced controller must produce (nearly) the
    same dt_next as the single-device adaptive step on the same
    problem."""
    from tpgsd.sph import (
        make_adaptive_distributed2d_step_fn,
        make_adaptive_step_fn,
    )

    state, grid, params = _cloud_setup(seed=12)
    mesh = make_mesh2d(shape=(4, 2))

    step_1 = jax.jit(make_adaptive_step_fn(grid, params, cfl=0.3))
    _s1, _, dt1 = step_1(state, jnp.float32(params.dt))

    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_adaptive_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, cfl=0.3
    )
    _dist, _aux, dtd = step_d(dist, jnp.float32(params.dt))

    numpy.testing.assert_allclose(float(dtd), float(dt1), rtol=1e-4)


def test_2d_adaptive_rollout():
    """run_adaptive composes with the 2-D DistState pytree: the scan
    rollout stays finite, conserves the particle census, and advances
    simulated time by the sum of the dts actually taken."""
    from tpgsd.sph import make_adaptive_distributed2d_step_fn, run_adaptive

    state, grid, params = _cloud_setup(seed=13)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(2, 2))

    dist, cap = distribute_state_2d(state, grid, mesh)
    step = make_adaptive_distributed2d_step_fn(
        grid, params, mesh, capacity=cap
    )
    out, dt_next, t = run_adaptive(step, dist, params.dt, 8)

    assert float(t) > 0 and numpy.isfinite(float(t))
    assert 0 < float(dt_next) <= params.dt
    pid = numpy.asarray(out.pid)
    alive = pid[pid >= 0]
    assert len(alive) == n and len(set(alive.tolist())) == n
    x, v, _ = collect_state(out, n)
    assert numpy.isfinite(x).all() and numpy.isfinite(v).all()


def test_2d_density_renorm_matches_single_device():
    """density_renorm on the block mesh matches the single-device
    renorm step (the floor lands before the owner rho/p exchange)."""
    state, grid, params = _cloud_setup(seed=9)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))

    step_ref = jax.jit(make_step_fn(grid, params, density_renorm=True))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, density_renorm=True
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


def test_2d_surface_tension_matches_single_device():
    """surface_tension on the block mesh: normals are owner-exchanged
    like rho/p before the force pass, so the trajectory matches the
    single-device Akinci step."""
    state, grid, params = _cloud_setup(seed=15)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))
    gamma = 0.5

    step_ref = jax.jit(make_step_fn(grid, params, surface_tension=gamma))
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(state, grid, mesh)
    step_d = make_distributed2d_step_fn(
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
# continuity-density mode on the 2-D block decomposition
# ---------------------------------------------------------------------------


def test_2d_continuity_matches_single_device():
    """Continuity mode on (4, 2) blocks: positions, velocities AND the
    evolved carried density match the single-device continuity step."""
    from tpgsd.sph import init_density

    state, grid, params = _cloud_setup()
    state = init_density(state, grid, params)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))

    step_ref = jax.jit(
        make_step_fn(grid, params, density_mode="continuity")
    )
    s_ref = state
    for _ in range(3):
        s_ref, _ = step_ref(s_ref)

    dist, cap = distribute_state_2d(state, grid, mesh)
    assert dist.rho is not None
    step_d = make_distributed2d_step_fn(
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


def test_2d_continuity_pallas_matches_jnp():
    """Continuity (4, 2) blocks on the fused accel+drho Triton kernel
    (interpret mode) vs the decomposed jnp pair path."""
    from tpgsd.sph import init_density

    state, grid, params = _cloud_setup(seed=13)
    state = init_density(state, grid, params)
    n = state.x.shape[0]
    mesh = make_mesh2d(shape=(4, 2))

    def run(**kw):
        dist, cap = distribute_state_2d(state, grid, mesh)
        step_d = make_distributed2d_step_fn(
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
    numpy.testing.assert_allclose(r_p, r_j, rtol=5e-4)


def test_2d_continuity_periodic_matches_single_device():
    """Continuity blocks under a fully periodic box: the fused
    x|v|rho|p|mask halo crosses both ring seams."""
    from tpgsd.sph import init_density

    sc = taylor_green(n_side=21)
    mesh = make_mesh2d(shape=(4, 2))
    assert sc.grid.dims[0] % 4 == 0 and sc.grid.dims[1] % 2 == 0

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

    dist, cap = distribute_state_2d(state, sc.grid, mesh)
    step_d = make_distributed2d_step_fn(
        sc.grid, sc.params, mesh, capacity=cap, periodic=True,
        density_mode="continuity",
    )
    for _ in range(3):
        dist, aux = step_d(dist)
    assert int(jnp.sum(aux.cell_overflow)) == 0
    assert int(jnp.sum(aux.migrate_overflow)) == 0

    x_d, v_d, rho_d = collect_state(dist, sc.n)
    numpy.testing.assert_allclose(
        x_d, numpy.asarray(s_ref.x), rtol=5e-4, atol=5e-5
    )
    numpy.testing.assert_allclose(
        rho_d, numpy.asarray(s_ref.rho), rtol=1e-4
    )


def test_2d_continuity_diagonal_migration_carries_density():
    """A diagonal mover completes both hops in one step WITH its
    carried density (isolated particles: drho/dt == 0)."""
    mesh = make_mesh2d(shape=(2, 2))
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(8, 8, 4),
                    capacity=16)
    params = SPHParams(mass=1.0, h=0.12, dt=0.1, gravity=(0.0, 0.0, 0.0))

    # one particle moving diagonally across the (1, 1) block corner
    x = jnp.asarray([[0.95, 0.95, 0.5]], jnp.float32)
    v = jnp.asarray([[1.0, 1.0, 0.0]], jnp.float32)
    rho = jnp.asarray([1111.5], jnp.float32)
    state = SPHState(x=x, v=v, rho=rho)
    dist, cap = distribute_state_2d(state, grid, mesh, capacity=8)
    step = make_distributed2d_step_fn(
        grid, params, mesh, capacity=8, density_mode="continuity",
        delta_sph=0.0,
    )
    dist, aux = step(dist)
    assert int(jnp.sum(aux.migrate_overflow)) == 0
    x_d, v_d, rho_d = collect_state(dist, 1)
    numpy.testing.assert_allclose(x_d[0, :2], [1.05, 1.05], rtol=1e-5)
    numpy.testing.assert_array_equal(
        rho_d, numpy.asarray([1111.5], numpy.float32)
    )


def test_2d_continuity_adaptive_matches_fixed_at_same_dt():
    from tpgsd.sph import init_density
    from tpgsd.sph.distributed2d import make_adaptive_distributed2d_step_fn

    state, grid, params = _cloud_setup()
    state = init_density(state, grid, params)
    mesh = make_mesh2d(shape=(4, 2))

    dist_f, cap = distribute_state_2d(state, grid, mesh)
    dist_a = dist_f
    step_f = make_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )
    step_a = make_adaptive_distributed2d_step_fn(
        grid, params, mesh, capacity=cap, density_mode="continuity"
    )
    dt = jnp.float32(params.dt)
    for _ in range(2):
        dist_f, _ = step_f(dist_f)
        dist_a, _, _dt = step_a(dist_a, dt)
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.x), numpy.asarray(dist_f.x)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(dist_a.rho), numpy.asarray(dist_f.rho)
    )
