"""SPH stepper tests: kernel math, cell-list vs brute force, stability."""

import numpy
import numpy.testing
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpgsd.sph import (  # noqa: E402
    CubicSpline,
    SPHParams,
    SPHState,
    WendlandC2,
    dam_break,
    density_and_pressure,
    make_step_fn,
)
from tpgsd.sph.cells import (  # noqa: E402
    build_cells,
    cell_id,
    gather_from_cells,
    make_grid,
    neighbor_table,
    scatter_to_cells,
)


@pytest.mark.parametrize("kernel", [CubicSpline, WendlandC2])
def test_kernel_normalization(kernel):
    """The smoothing kernel integrates to 1 over its support."""
    h = 0.7
    edge = 2.0 * h
    n = 80
    dx = 2 * edge / n
    axis = numpy.linspace(-edge + dx / 2, edge - dx / 2, n)
    gx, gy, gz = numpy.meshgrid(axis, axis, axis, indexing="ij")
    r = numpy.sqrt(gx**2 + gy**2 + gz**2)
    w = numpy.asarray(kernel.w(jnp.asarray(r, jnp.float32), h))
    integral = w.sum() * dx**3
    assert abs(integral - 1.0) < 2e-2


@pytest.mark.parametrize("kernel", [CubicSpline, WendlandC2])
def test_kernel_gradient_consistency(kernel):
    """dw_over_r matches the numerical derivative of w."""
    h = 0.5
    r = jnp.linspace(0.05, 2 * h * 0.99, 50)
    eps = 1e-4
    dw_num = (kernel.w(r + eps, h) - kernel.w(r - eps, h)) / (2 * eps)
    dw_ana = kernel.dw_over_r(r, h) * r
    numpy.testing.assert_allclose(
        numpy.asarray(dw_num), numpy.asarray(dw_ana), rtol=1e-2, atol=1e-3
    )


def test_kernel_compact_support():
    h = 0.3
    for kernel in (CubicSpline, WendlandC2):
        assert float(kernel.w(jnp.asarray(2.0 * h + 1e-4), h)) == 0.0
        assert float(kernel.w(jnp.asarray(0.0), h)) > 0.0


def test_cell_roundtrip():
    """scatter -> gather over the cell layout is the identity."""
    rng = numpy.random.RandomState(0)
    x = jnp.asarray(rng.rand(500, 3).astype(numpy.float32))
    grid = make_grid((0, 0, 0), (1, 1, 1), support=0.25, capacity=64)
    cells = build_cells(x, grid)
    assert int(cells.overflow) == 0
    dense = scatter_to_cells(x, cells, grid)
    back = gather_from_cells(dense, cells, grid)
    numpy.testing.assert_array_equal(numpy.asarray(back), numpy.asarray(x))


def test_cell_id_bounds():
    grid = make_grid((0, 0, 0), (1, 1, 1), support=0.25, capacity=8)
    x = jnp.asarray([[-5.0, 0.5, 0.5], [5.0, 0.5, 0.5], [0.5, 0.5, 0.5]], jnp.float32)
    cid = cell_id(x, grid)
    assert (numpy.asarray(cid) >= 0).all()
    assert (numpy.asarray(cid) < grid.n_cells).all()


def test_neighbor_table_sentinel():
    grid = make_grid((0, 0, 0), (1, 1, 1), support=0.34, capacity=8)  # 2x2x2 grid
    nbr = numpy.asarray(neighbor_table(grid))
    assert nbr.shape == (8, 27)
    # corner cell: 8 real neighbors (including itself), 19 sentinels
    assert (nbr[0] == grid.n_cells).sum() == 19
    real = sorted(set(nbr[0]) - {grid.n_cells})
    assert real == list(range(8))


def test_density_matches_bruteforce():
    """Cell-list density == O(N^2) brute-force density."""
    rng = numpy.random.RandomState(1)
    n = 200
    x = rng.rand(n, 3).astype(numpy.float32)
    h = 0.12
    params = SPHParams(mass=1.0, h=h, dt=1e-4)
    grid = make_grid((0, 0, 0), (1, 1, 1), support=2 * h, capacity=128)

    rho, p = density_and_pressure(jnp.asarray(x), grid, params)

    diff = x[:, None, :] - x[None, :, :]
    r = numpy.sqrt((diff**2).sum(-1))
    w = numpy.asarray(WendlandC2.w(jnp.asarray(r), h))
    rho_brute = params.mass * w.sum(axis=1)

    numpy.testing.assert_allclose(
        numpy.asarray(rho), rho_brute, rtol=1e-4, atol=1e-4
    )


def test_energy_rate_conserves_pair_energy():
    """The energy equation is the conjugate of the momentum equation:
    for pair-antisymmetric forces, sum_i m du_i/dt == -sum_i m v_i.a_i
    (pair part, no gravity/walls) - total KE + internal energy is
    conserved."""
    from tpgsd.sph import energy_rate
    from tpgsd.sph.cells import build_cells, neighbor_table, scatter_to_cells
    from tpgsd.sph.step import (
        _accel_blocks,
        _density_blocks,
        gather_from_cells,
        tait_pressure,
    )

    rng = numpy.random.RandomState(3)
    n = 150
    x = jnp.asarray(rng.rand(n, 3).astype(numpy.float32))
    v = jnp.asarray(rng.randn(n, 3).astype(numpy.float32) * 0.2)
    h = 0.12
    params = SPHParams(mass=0.8, h=h, dt=1e-4, alpha=0.3)
    grid = make_grid((0, 0, 0), (1, 1, 1), support=2 * h, capacity=128)

    from tpgsd.sph import SPHState

    du = numpy.asarray(energy_rate(SPHState(x=x, v=v), grid, params))

    # pair acceleration via the same dense layout (no gravity/walls)
    cells = build_cells(x, grid)
    nbr = neighbor_table(grid)
    dense_x = scatter_to_cells(x, cells, grid)
    dense_v = scatter_to_cells(v, cells, grid)
    rho_d = _density_blocks(dense_x, cells.mask, nbr, params, WendlandC2, 32)
    rho_d = jnp.concatenate(
        [rho_d, jnp.full((1, grid.capacity), params.rho0, rho_d.dtype)]
    )
    rho_d = jnp.where(cells.mask, jnp.maximum(rho_d, 0.1 * params.rho0), params.rho0)
    p_d = jnp.where(cells.mask, tait_pressure(rho_d, params), 0.0)
    acc_d = _accel_blocks(
        dense_x, dense_v, rho_d, p_d, cells.mask, nbr, params, WendlandC2, 32
    )
    acc_d = jnp.concatenate([acc_d, jnp.zeros((1, grid.capacity, 3), acc_d.dtype)])
    acc = numpy.asarray(gather_from_cells(acc_d, cells, grid))

    internal = params.mass * du.sum()
    kinetic = params.mass * (numpy.asarray(v) * acc).sum()
    scale = max(abs(internal), abs(kinetic), 1e-6)
    assert abs(internal + kinetic) / scale < 1e-3, (internal, kinetic)
    assert numpy.isfinite(du).all()


def test_auto_capacity_matches_occupancy():
    """capacity="auto" sizes slots to the initial lattice with
    headroom, and a dynamic run stays within it (no overflow)."""
    from tpgsd.sph.cells import auto_capacity

    db = dam_break(n_side=10, capacity="auto")
    # the densest initial cell holds 27 particles (cells stretch to
    # ~3.3 dx); 1.5x headroom rounded to a multiple of 8 -> 48, a 44%
    # pair-FLOP cut vs the fixed default 64
    assert db.grid.capacity == 48, db.grid.capacity
    assert auto_capacity(
        db.state.x, (0, 0, 0), db.box, 2 * db.params.h
    ) == db.grid.capacity

    step = jax.jit(make_step_fn(db.grid, db.params))
    state = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    for _ in range(30):
        state, (rho, p, ovf) = step(state)
    assert int(ovf) == 0
    assert numpy.isfinite(numpy.asarray(state.x)).all()


def test_lattice_density_near_rest():
    """A uniform lattice at spacing dx with h=1.3dx sums to ~rho0."""
    db = dam_break(n_side=8, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0))
    rho, p = density_and_pressure(db.state.x, db.grid, db.params)
    rho = numpy.asarray(rho)
    # interior particles: within 10% of rest density
    interior = rho > 0.8 * db.params.rho0  # surface particles are deficient
    assert interior.mean() > 0.4
    assert abs(numpy.median(rho[interior]) / db.params.rho0 - 1.0) < 0.15


def test_density_renorm_fixes_surface_deficit():
    """The clipped rest-volume Shepard renormalization (closed form:
    the Hughes-Graham floor, tpgsd.sph.step._renormalize_density) must
    (a) remove the free-surface density deficit - no particle below
    rho0, hence no spurious negative Tait pressures - while (b) leaving
    legitimately compressed interior densities untouched."""
    db = dam_break(n_side=8, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0))
    rho_raw, p_raw = density_and_pressure(db.state.x, db.grid, db.params)
    rho_rn, p_rn = density_and_pressure(
        db.state.x, db.grid, db.params, density_renorm=True
    )
    rho_raw, rho_rn = numpy.asarray(rho_raw), numpy.asarray(rho_rn)
    p_raw, p_rn = numpy.asarray(p_raw), numpy.asarray(p_rn)

    # the raw lattice HAS a surface deficit and negative surface pressure
    assert rho_raw.min() < 0.9 * db.params.rho0
    assert p_raw.min() < 0
    # (a) renormalized: no deficit anywhere, pressure floor at 0
    assert rho_rn.min() >= db.params.rho0 - 1e-3
    assert p_rn.min() >= -1e-6
    # (b) compressed particles (rho > rho0) are untouched
    over = rho_raw > db.params.rho0
    assert over.any()
    numpy.testing.assert_allclose(rho_rn[over], rho_raw[over], rtol=1e-6)


def test_density_renorm_in_step_paths():
    """density_renorm threads identically through the jnp and Triton
    kernel step paths."""
    db = dam_break(n_side=6)
    s0 = db.state
    step_j = jax.jit(make_step_fn(db.grid, db.params, density_renorm=True))
    step_p = jax.jit(
        make_step_fn(
            db.grid, db.params, density_renorm=True, use_pallas=True,
            pallas_interpret=True,
        )
    )
    s_j, (rho_j, _, _) = step_j(s0)
    s_p, (rho_p, _, _) = step_p(s0)
    assert float(jnp.min(rho_j)) >= db.params.rho0 - 1e-3
    numpy.testing.assert_allclose(
        numpy.asarray(s_p.x), numpy.asarray(s_j.x), rtol=1e-5, atol=1e-6
    )


def test_dam_break_short_run_stable():
    """A dam-break rollout stays finite, in-box, and near incompressible."""
    db = dam_break(n_side=6)
    step = make_step_fn(db.grid, db.params)
    step = jax.jit(step)

    state = db.state
    for _ in range(50):
        state, (rho, p, overflow) = step(state)

    x = numpy.asarray(state.x)
    v = numpy.asarray(state.v)
    rho = numpy.asarray(rho)
    assert numpy.isfinite(x).all()
    assert numpy.isfinite(v).all()
    assert int(overflow) == 0
    lo = numpy.zeros(3)
    hi = numpy.asarray(db.box)
    assert (x >= lo - 1e-5).all() and (x <= hi + 1e-5).all()
    # weakly compressible: density within ~30% of rest
    assert (numpy.abs(rho / db.params.rho0 - 1.0) < 0.3).mean() > 0.9


def test_gravity_free_fall():
    """A single isolated particle free-falls under gravity."""
    grid = make_grid((0, 0, 0), (1, 1, 1), support=0.25, capacity=8)
    params = SPHParams(mass=1.0, h=0.1, dt=0.001, gravity=(0.0, 0.0, -10.0))
    step = jax.jit(make_step_fn(grid, params))
    state = SPHState(
        x=jnp.asarray([[0.5, 0.5, 0.9]], jnp.float32),
        v=jnp.zeros((1, 3), jnp.float32),
    )
    for _ in range(100):
        state, _ = step(state)
    # after t=0.1s: dz = -g t^2 / 2 = -0.05 (symplectic Euler is first order)
    z = float(state.x[0, 2])
    assert abs((0.9 - z) - 0.05) < 0.005
    assert abs(float(state.v[0, 2]) + 1.0) < 0.02


def test_step_under_scan():
    """The step function composes with lax.scan (compiler-friendly loop)."""
    db = dam_break(n_side=5)
    step = make_step_fn(db.grid, db.params)

    def scan_body(state, _):
        new_state, (rho, _, _) = step(state)
        return new_state, rho.mean()

    final, rho_means = jax.lax.scan(scan_body, db.state, None, length=10)
    assert rho_means.shape == (10,)
    assert bool(jnp.isfinite(rho_means).all())


def test_use_pallas_auto_policy(monkeypatch):
    """"auto" resolves to the Triton kernels only on a GPU backend and
    never under GSPMD; explicit True under GSPMD raises."""
    import jax

    import tpgsd.sph.step as step_mod
    from tpgsd.sph import dam_break
    from tpgsd.sph.step import make_step_fn, resolve_use_pallas

    db = dam_break(n_side=4, capacity=32)
    # on the CPU test backend, auto must resolve to the jnp path and
    # the step must run
    step_fn = make_step_fn(db.grid, db.params, use_pallas="auto")
    assert step_fn.resolved["use_pallas"] is False
    state, aux = jax.jit(step_fn)(db.state)
    assert numpy.isfinite(numpy.asarray(state.x)).all()

    assert resolve_use_pallas(False) is False
    assert resolve_use_pallas(True) is True
    monkeypatch.setattr(step_mod.jax, "default_backend", lambda: "gpu")
    assert resolve_use_pallas("auto") is True
    assert resolve_use_pallas("auto", gspmd=True) is False
    assert resolve_use_pallas(False, gspmd=True) is False
    with pytest.raises(ValueError, match="shard_map"):
        resolve_use_pallas(True, gspmd=True)


def test_xsph_conserves_momentum():
    """The XSPH correction's pair weight is symmetric and the velocity
    difference antisymmetric, so total momentum is exactly preserved -
    and the correction must damp velocity disorder (smoothed field
    closer to the local mean)."""
    rng = numpy.random.RandomState(5)
    db = dam_break(n_side=8, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0))
    x = db.state.x
    v = jnp.asarray(rng.randn(db.n, 3).astype(numpy.float32) * 0.1)

    from tpgsd.sph.cells import build_cells, scatter_to_cells, gather_from_cells
    from tpgsd.sph.step import _xsph_blocks

    cells = build_cells(x, db.grid)
    dense_x = scatter_to_cells(x, cells, db.grid)
    dense_v = scatter_to_cells(v, cells, db.grid)
    rho, _ = density_and_pressure(x, db.grid, db.params)
    dense_rho = scatter_to_cells(rho, cells, db.grid, fill=db.params.rho0)
    nbr = neighbor_table(db.grid)
    dvc_dense = _xsph_blocks(
        dense_x, dense_v, dense_rho, cells.mask, nbr, db.params,
        WendlandC2, 32,
    )
    dvc_dense = jnp.concatenate(
        [dvc_dense, jnp.zeros((1, db.grid.capacity, 3), dvc_dense.dtype)]
    )
    dvc = numpy.asarray(gather_from_cells(dvc_dense, cells, db.grid))

    # momentum of the correction sums to ~0 (equal masses)
    total = numpy.abs(dvc.sum(axis=0))
    scale = numpy.abs(numpy.asarray(v)).sum()
    assert (total < 1e-4 * scale).all(), (total, scale)
    # disorder damped: the corrected field has smaller deviation from
    # the (unchanged) mean velocity
    v_np = numpy.asarray(v)
    before = numpy.var(v_np, axis=0).sum()
    after = numpy.var(v_np + 0.5 * dvc, axis=0).sum()
    assert after < before


def test_xsph_step_stable_and_momentum_neutral():
    """A dam-break rollout with xsph=0.5 stays finite/in-box, and at
    xsph=0 the option is exactly the plain step."""
    db = dam_break(n_side=6)
    step_x = jax.jit(make_step_fn(db.grid, db.params, xsph=0.5))
    step_0 = jax.jit(make_step_fn(db.grid, db.params, xsph=0.0))
    step_p = jax.jit(make_step_fn(db.grid, db.params))

    s_x = s_0 = s_p = db.state
    for _ in range(50):
        s_x, (rho_x, _, ovf_x) = step_x(s_x)
        s_0, _ = step_0(s_0)
        s_p, _ = step_p(s_p)
    assert numpy.isfinite(numpy.asarray(s_x.x)).all()
    assert int(ovf_x) == 0
    lo = numpy.zeros(3); hi = numpy.asarray(db.box)
    xs = numpy.asarray(s_x.x)
    assert (xs >= lo - 1e-5).all() and (xs <= hi + 1e-5).all()
    # xsph=0.0 is a no-op relative to the default step
    numpy.testing.assert_array_equal(
        numpy.asarray(s_0.x), numpy.asarray(s_p.x)
    )


def test_adaptive_step_matches_fixed_at_same_dt():
    """The adaptive step advanced with dt == params.dt must reproduce
    the fixed step exactly - dt is a traced operand of the SAME
    compiled physics, not a different integrator."""
    from tpgsd.sph import make_adaptive_step_fn

    db = dam_break(n_side=6)
    state = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))

    step_f = jax.jit(make_step_fn(db.grid, db.params))
    step_a = jax.jit(make_adaptive_step_fn(db.grid, db.params))

    s_f, s_a = state, state
    dt = jnp.float32(db.params.dt)
    for _ in range(3):
        s_f, aux_f = step_f(s_f)
        s_a, aux_a, _dt_next = step_a(s_a, dt)
    numpy.testing.assert_array_equal(
        numpy.asarray(s_a.x), numpy.asarray(s_f.x)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(s_a.v), numpy.asarray(s_f.v)
    )
    numpy.testing.assert_array_equal(
        numpy.asarray(aux_a[0]), numpy.asarray(aux_f[0])
    )


def test_adaptive_dt_is_traced_not_baked():
    """Two different dt values through ONE jitted step must yield
    different trajectories (dt is an operand, so adapting it cannot
    recompile) - and a smaller dt must move particles less."""
    from tpgsd.sph import make_adaptive_step_fn

    db = dam_break(n_side=6)
    state = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    step = jax.jit(make_adaptive_step_fn(db.grid, db.params))

    s1, _, _ = step(state, jnp.float32(db.params.dt))
    s2, _, _ = step(state, jnp.float32(db.params.dt * 0.25))
    d1 = numpy.abs(numpy.asarray(s1.x) - numpy.asarray(state.x)).max()
    d2 = numpy.abs(numpy.asarray(s2.x) - numpy.asarray(state.x)).max()
    assert d2 < d1


def test_adaptive_dt_controller_bounds_and_response():
    """dt_next obeys [dt_min, dt_max]; a violent flow (dam-break
    free-fall impact) demands a smaller dt than a quiescent one."""
    from tpgsd.sph import make_adaptive_step_fn, still_box

    db = dam_break(n_side=8)
    step = jax.jit(make_adaptive_step_fn(db.grid, db.params, cfl=0.25))
    s = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    dt = jnp.float32(db.params.dt)
    for _ in range(5):
        s, _aux, dt = step(s, dt)
        assert 0.0 < float(dt) <= float(jnp.float32(db.params.dt))

    # quiescent: near-zero velocities; the ceiling binds
    sb = still_box(n_side=6)
    step_q = jax.jit(
        make_adaptive_step_fn(sb.grid, sb.params, cfl=0.25)
    )
    sq = SPHState(x=jnp.asarray(sb.state.x), v=jnp.asarray(sb.state.v))
    _snew, _aux, dt_q = step_q(sq, jnp.float32(sb.params.dt))
    # the still box's configured dt is already conservative; the
    # controller must not demand an order-of-magnitude cut there
    assert float(dt_q) > 0.1 * sb.params.dt

    # dt_min floor is respected
    step_floor = jax.jit(
        make_adaptive_step_fn(
            db.grid, db.params, cfl=1e-6, dt_min=db.params.dt * 0.5
        )
    )
    _s, _aux, dt_f = step_floor(s, dt)
    assert float(dt_f) == pytest.approx(db.params.dt * 0.5)


def test_run_adaptive_scan_rollout():
    """lax.scan rollout: total time equals the sum of the dts taken
    (verified against an eager replay), state stays finite."""
    from tpgsd.sph import make_adaptive_step_fn, run_adaptive

    db = dam_break(n_side=6)
    state = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    step = make_adaptive_step_fn(db.grid, db.params, cfl=0.3)

    n_steps = 5
    s_scan, dt_scan, t_scan = jax.jit(
        lambda s: run_adaptive(step, s, db.params.dt, n_steps)
    )(state)

    # eager replay
    s_e = state
    dt_e = jnp.float32(db.params.dt)
    t_e = 0.0
    jstep = jax.jit(step)
    for _ in range(n_steps):
        t_e += float(dt_e)
        s_e, _aux, dt_e = jstep(s_e, dt_e)

    assert numpy.isfinite(numpy.asarray(s_scan.x)).all()
    numpy.testing.assert_allclose(float(t_scan), t_e, rtol=1e-6)
    numpy.testing.assert_allclose(float(dt_scan), float(dt_e), rtol=1e-6)
    numpy.testing.assert_allclose(
        numpy.asarray(s_scan.x), numpy.asarray(s_e.x), rtol=1e-5, atol=1e-7
    )


def test_adaptive_with_fixed_boundary_particles():
    """n_fixed composes: boundary slots never move under the adaptive
    step and their (nonzero) accelerations do not drive the controller
    when they are the extreme ones."""
    from tpgsd.sph import make_adaptive_step_fn
    from tpgsd.sph.scenarios import hydrostatic_tank

    sc = hydrostatic_tank(n_side=6)
    step = jax.jit(
        make_adaptive_step_fn(
            sc.grid, sc.params, n_fixed=sc.n_fixed, cfl=0.25
        )
    )
    s = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    dt = jnp.float32(sc.params.dt)
    for _ in range(3):
        s, _aux, dt = step(s, dt)
    numpy.testing.assert_array_equal(
        numpy.asarray(s.x)[: sc.n_fixed],
        numpy.asarray(sc.state.x)[: sc.n_fixed],
    )
    assert float(dt) > 0.0


def test_surface_tension_conserves_momentum():
    """The cohesion spline is symmetric and dx antisymmetric, so the
    pairwise surface-tension forces are equal-and-opposite: the total
    momentum kick sums to ~0 (equal masses)."""
    db = dam_break(n_side=8, box=(1.0, 1.0, 1.0), fill=(1.0, 1.0, 1.0))
    x = db.state.x

    from tpgsd.sph.cells import (
        build_cells,
        gather_from_cells,
        scatter_to_cells,
    )
    from tpgsd.sph.step import _cohesion_blocks

    cells = build_cells(x, db.grid)
    dense_x = scatter_to_cells(x, cells, db.grid)
    rho, _ = density_and_pressure(x, db.grid, db.params)
    dense_rho = scatter_to_cells(rho, cells, db.grid, fill=db.params.rho0)
    nbr = neighbor_table(db.grid)
    coh_dense = _cohesion_blocks(
        dense_x, dense_rho, cells.mask, nbr, db.params, WendlandC2, 32,
        gamma=1.0,
    )
    coh_dense = jnp.concatenate(
        [coh_dense, jnp.zeros((1, db.grid.capacity, 3), coh_dense.dtype)]
    )
    coh = numpy.asarray(gather_from_cells(coh_dense, cells, db.grid))

    total = numpy.abs(coh.sum(axis=0))
    scale = numpy.abs(coh).sum()
    assert scale > 0  # the pass actually produced forces
    assert (total < 1e-4 * scale).all(), (total, scale)


def test_surface_tension_contracts_free_drop():
    """A free cube of fluid with cohesion and no gravity contracts (its
    rms distance from the centroid shrinks); without cohesion it does
    not.  The physical signature of surface tension: drops pull toward
    spheres."""
    db = dam_break(
        n_side=6, box=(1.0, 1.0, 1.0), fill=(0.4, 0.4, 0.4),
    )
    # center the block so the contraction is wall-free
    x0 = jnp.asarray(db.state.x) + jnp.asarray([0.3, 0.3, 0.3], jnp.float32)
    params = db.params._replace(gravity=(0.0, 0.0, 0.0))

    def rms_radius(x):
        c = x.mean(axis=0)
        return float(numpy.sqrt(((numpy.asarray(x) - c) ** 2).sum(1).mean()))

    def run(gamma):
        step = jax.jit(
            make_step_fn(db.grid, params, surface_tension=gamma)
        )
        s = SPHState(x=x0, v=jnp.zeros_like(x0))
        for _ in range(60):
            s, _ = step(s)
        return s

    r0 = rms_radius(x0)
    s_coh = run(gamma=2.0)
    assert numpy.isfinite(numpy.asarray(s_coh.x)).all()
    r_coh = rms_radius(s_coh.x)
    s_free = run(gamma=0.0)
    r_free = rms_radius(s_free.x)
    # cohesion pulls the drop inward relative to the cohesion-free run
    assert r_coh < r_free
    assert r_coh < r0


# ---------------------------------------------------------------------------
# continuity-density mode (density_mode="continuity" + init_density)
# ---------------------------------------------------------------------------


def test_init_density_seeds_summation_and_override():
    """Default seed equals the summation density; explicit seeds broadcast."""
    from tpgsd.sph import init_density

    db = dam_break(n_side=5)
    seeded = init_density(db.state, db.grid, db.params)
    rho_sum, _ = density_and_pressure(db.state.x, db.grid, db.params)
    numpy.testing.assert_allclose(
        numpy.asarray(seeded.rho), numpy.asarray(rho_sum), rtol=1e-6
    )
    # positions/velocities untouched
    assert seeded.x is db.state.x and seeded.v is db.state.v

    forced = init_density(db.state, db.grid, db.params, rho=db.params.rho0)
    assert forced.rho.shape == (db.state.x.shape[0],)
    numpy.testing.assert_allclose(
        numpy.asarray(forced.rho), db.params.rho0, rtol=1e-7
    )


def test_continuity_step_requires_seed_and_rejects_bad_compositions():
    db = dam_break(n_side=4)
    step = make_step_fn(db.grid, db.params, density_mode="continuity")
    with pytest.raises(ValueError, match="init_density"):
        step(db.state)  # rho is None
    with pytest.raises(ValueError, match="density_renorm"):
        make_step_fn(
            db.grid, db.params, density_mode="continuity",
            density_renorm=True,
        )
    # continuity + the Triton kernels: the builder constructs with the
    # fused accel_drho kernel at any capacity
    make_step_fn(
        db.grid, db.params, density_mode="continuity", use_pallas=True
    )
    with pytest.raises(ValueError, match="density_mode"):
        make_step_fn(db.grid, db.params, density_mode="bogus")


def test_continuity_first_step_matches_summation_exactly():
    """Seeded with the summation density, the FIRST continuity step sees
    the exact same rho/p field as the summation step, so positions and
    velocities after one step agree to float tolerance (the
    formulations only diverge from step 2 on, through the density
    update).  A longer run then stays stable and weakly compressible."""
    from tpgsd.sph import init_density

    db = dam_break(n_side=6)
    step_s = jax.jit(make_step_fn(db.grid, db.params))
    step_c = jax.jit(
        make_step_fn(db.grid, db.params, density_mode="continuity")
    )

    s_sum, _ = step_s(db.state)
    s_con, _ = step_c(init_density(db.state, db.grid, db.params))
    numpy.testing.assert_allclose(
        numpy.asarray(s_con.x), numpy.asarray(s_sum.x), atol=1e-6
    )
    numpy.testing.assert_allclose(
        numpy.asarray(s_con.v), numpy.asarray(s_sum.v), atol=1e-4
    )

    for _ in range(40):
        s_con, (rho_c, _, of) = step_c(s_con)
    assert int(of) == 0
    assert bool(jnp.isfinite(s_con.x).all())
    # the evolved density is the aux output AND the carried state
    numpy.testing.assert_allclose(
        numpy.asarray(s_con.rho), numpy.asarray(rho_c), rtol=1e-6
    )
    # stays weakly compressible
    rho_c = numpy.asarray(rho_c)
    assert (numpy.abs(rho_c / db.params.rho0 - 1.0) < 0.3).mean() > 0.9


def test_continuity_free_surface_keeps_seeded_density():
    """The summation free-surface deficit does not exist in continuity
    mode: a resting lattice seeded at rho0 keeps surface densities at
    rho0 (summation reads them ~40% low)."""
    from tpgsd.sph import init_density, still_box

    sb = still_box(n_side=6)
    params = sb.params._replace(gravity=(0.0, 0.0, 0.0))
    state = init_density(sb.state, sb.grid, params, rho=params.rho0)
    step = jax.jit(make_step_fn(sb.grid, params, density_mode="continuity"))
    for _ in range(5):
        state, (rho, _, _) = step(state)
    rho = numpy.asarray(rho)
    # at rest, drho/dt = 0 exactly (v = 0 everywhere) -> density frozen
    numpy.testing.assert_allclose(rho, params.rho0, rtol=1e-5)
    rho_sum, _ = density_and_pressure(state.x, sb.grid, params)
    assert float(jnp.min(rho_sum)) < 0.75 * params.rho0  # the deficit


def test_continuity_under_scan_and_adaptive():
    """The rho-carrying state threads through lax.scan and the adaptive
    controller unchanged (same pytree in and out)."""
    from tpgsd.sph import init_density, make_adaptive_step_fn

    db = dam_break(n_side=5)
    state0 = init_density(db.state, db.grid, db.params)

    step = make_step_fn(db.grid, db.params, density_mode="continuity")

    def body(state, _):
        new, (rho, _, _) = step(state)
        return new, rho.mean()

    final, rho_means = jax.lax.scan(body, state0, None, length=10)
    assert final.rho.shape == state0.rho.shape
    assert bool(jnp.isfinite(rho_means).all())

    astep = jax.jit(
        make_adaptive_step_fn(db.grid, db.params, density_mode="continuity")
    )
    s = state0
    dt = db.params.dt
    for _ in range(5):
        s, (rho, _, _), dt = astep(s, dt)
    assert bool(jnp.isfinite(s.rho).all())
    assert float(dt) > 0


def test_continuity_delta_sph_damps_density_noise():
    """delta-SPH diffusion reduces the acoustic density scatter a
    sloshing run accumulates under pure continuity integration."""
    from tpgsd.sph import init_density

    db = dam_break(n_side=6)

    def run(delta):
        step = jax.jit(
            make_step_fn(
                db.grid, db.params, density_mode="continuity",
                delta_sph=delta,
            )
        )
        s = init_density(db.state, db.grid, db.params)
        for _ in range(80):
            s, (rho, _, _) = step(s)
        return float(jnp.std(rho))

    assert run(0.1) < run(0.0)


def test_continuity_composes_with_xsph_and_surface_tension():
    from tpgsd.sph import init_density

    db = dam_break(n_side=5)
    step = jax.jit(
        make_step_fn(
            db.grid, db.params, density_mode="continuity",
            xsph=0.5, surface_tension=0.5,
        )
    )
    s = init_density(db.state, db.grid, db.params)
    for _ in range(10):
        s, (rho, p, of) = step(s)
    assert int(of) == 0
    assert bool(jnp.isfinite(s.x).all() and jnp.isfinite(s.rho).all())
