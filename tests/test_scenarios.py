"""Physics validation on the scenario zoo.

Quantitative checks, not just finiteness: uniform-lattice density
normalization and hydrostatic pressure - failures here mean the SPH
formulation (kernel normalization, EOS, boundary handling) regressed.
"""

import numpy
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpgsd.sph import (  # noqa: E402
    SPHState,
    density_and_pressure,
    hydrostatic_tank,
    make_step_fn,
    still_box,
)


def test_still_box_density_normalization():
    """Interior particles of a uniform lattice must measure ~rho0."""
    sc = still_box(n_side=10)
    rho, p = density_and_pressure(jnp.asarray(sc.state.x), sc.grid, sc.params)
    rho = numpy.asarray(rho)

    # interior = particles farther than the support radius from any face
    x = numpy.asarray(sc.state.x)
    margin = 2.0 * sc.params.h
    interior = numpy.all(
        (x > margin) & (x < numpy.asarray(sc.box) - margin), axis=1
    )
    assert interior.sum() > 50
    rho_i = rho[interior]
    # kernel-sum density on a uniform lattice: within a few percent
    assert abs(rho_i.mean() / sc.params.rho0 - 1.0) < 0.05
    assert rho_i.std() / sc.params.rho0 < 0.02


def test_still_box_stays_still():
    """Zero gravity + uniform lattice: velocities stay ~0 (interior)."""
    sc = still_box(n_side=8)
    step = jax.jit(make_step_fn(sc.grid, sc.params))
    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    for _ in range(5):
        state, _ = step(state)
    x = numpy.asarray(sc.state.x)
    margin = 2.0 * sc.params.h
    interior = numpy.all(
        (x > margin) & (x < numpy.asarray(sc.box) - margin), axis=1
    )
    v = numpy.asarray(state.v)[interior]
    # interior pressure gradients cancel by symmetry
    assert numpy.abs(v).max() < 0.05 * sc.params.c0 * 0.01 + 0.2


def _settle(sc, n_steps, damping=1.0, density_renorm=False):
    params = sc.params._replace(velocity_damping=damping)
    step = jax.jit(
        make_step_fn(
            sc.grid, params, n_fixed=sc.n_fixed, density_renorm=density_renorm
        )
    )
    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    for _ in range(n_steps):
        state, (rho, p, _) = step(state)
    return numpy.asarray(state.x), numpy.asarray(p), numpy.asarray(state.v)


def test_fixed_particles_stay_and_support():
    """Boundary particles are immobile under the step and the fluid
    does not free-fall through the floor."""
    sc = hydrostatic_tank(n_side=6)
    x0 = numpy.asarray(sc.state.x)
    x, p, _ = _settle(sc, 150, damping=0.999)
    numpy.testing.assert_array_equal(x[: sc.n_fixed], x0[: sc.n_fixed])
    # sanity: the drop is bounded by free fall (the floor + walls can
    # only decelerate the column) and everything stays finite
    t = 150 * sc.params.dt
    free_fall = 0.5 * 9.81 * t * t
    drop = x0[sc.n_fixed :, 2].mean() - x[sc.n_fixed :, 2].mean()
    assert drop < 1.2 * free_fall + 1e-3, (drop, free_fall)
    assert numpy.isfinite(x).all() and numpy.isfinite(p).all()


def test_eos_pressure_orders_with_compression():
    """Static check of the kernel -> density -> EOS chain: a column
    whose lattice spacing shrinks toward the bottom must measure
    monotonically increasing density and pressure downward."""
    from tpgsd.sph import SPHParams
    from tpgsd.sph.cells import make_grid

    dx = 0.05
    h = 1.3 * dx
    layers = []
    z = dx / 2
    for k in range(16):
        # compression grows toward the bottom (k=0 is the top)
        squeeze = 1.0 - 0.04 * (15 - k)
        nx = 12
        gx, gy = numpy.meshgrid(
            (numpy.arange(nx) + 0.5) * dx, (numpy.arange(nx) + 0.5) * dx,
            indexing="ij",
        )
        layers.append(
            numpy.stack(
                [gx.ravel(), gy.ravel(), numpy.full(gx.size, z)], axis=1
            )
        )
        z += dx * squeeze
    x = numpy.concatenate(layers).astype(numpy.float32)

    params = SPHParams(mass=1000.0 * dx**3, h=h, dt=1e-4)
    grid = make_grid((0, 0, 0), (0.6, 0.6, z + dx), 2 * h, capacity=64)
    rho, p = density_and_pressure(jnp.asarray(x), grid, params)
    rho, p = numpy.asarray(rho), numpy.asarray(p)

    zs = x[:, 2]
    # interior only (away from lateral faces and the two z extremes)
    m = 2 * h
    interior = (
        (x[:, 0] > m) & (x[:, 0] < 0.6 - m)
        & (x[:, 1] > m) & (x[:, 1] < 0.6 - m)
        & (zs > zs.min() + m) & (zs < zs.max() - m)
    )
    zi, pi, ri = zs[interior], p[interior], rho[interior]
    bins = numpy.linspace(zi.min(), zi.max(), 5)
    med_p = [numpy.median(pi[(zi >= a) & (zi < b)]) for a, b in zip(bins, bins[1:])]
    med_r = [numpy.median(ri[(zi >= a) & (zi < b)]) for a, b in zip(bins, bins[1:])]
    # strictly decreasing with height
    assert all(a > b for a, b in zip(med_p, med_p[1:])), med_p
    assert all(a > b for a, b in zip(med_r, med_r[1:])), med_r
    assert med_p[0] > 0


@pytest.mark.validate
def test_hydrostatic_pressure_profile():
    """After full settling, p(z) tracks rho0 g (H - z) in the bulk to
    ~30% (WCSPH pressure noise; catches sign/scale/EOS regressions)."""
    sc = hydrostatic_tank(n_side=10)
    x, p, v = _settle(sc, 1600, density_renorm=True)

    # settle quality: the free-surface density floor removes the
    # deficit-driven NEGATIVE surface pressures (measured: min p
    # -11.6 kPa -> 0.0) and the ringing failure mode they seeded
    # (round-1 ledger: re-ring to v_rms ~0.33 m/s).  Measured settled
    # v_rms with the floor: about 0.07 m/s (1600 steps); bound with
    # margin for backend variation
    v_rms = float(numpy.sqrt((v[sc.n_fixed :] ** 2).sum(axis=1).mean()))
    assert v_rms < 0.12, "column still ringing: v_rms %.3f m/s" % v_rms
    assert p[sc.n_fixed :].min() >= 0.0, "spurious suction at the surface"

    z = x[sc.n_fixed :, 2]
    fp = p[sc.n_fixed :]
    z_top = numpy.percentile(z, 98)
    h = sc.params.h
    bulk = (z > z.min() + 2 * h) & (z < z_top - 2 * h)
    assert bulk.sum() > 50
    expected = sc.params.rho0 * 9.81 * (z_top - z[bulk])
    rel = numpy.abs(fp[bulk] - expected) / numpy.maximum(expected, 1e-3)
    assert numpy.median(rel) < 0.3, (
        "hydrostatic profile off: median rel err %.3f" % numpy.median(rel)
    )


def test_scenario_shape_invariants():
    sc = hydrostatic_tank(n_side=6, wall_layers=1)
    assert sc.n_fixed > 0
    assert numpy.asarray(sc.state.x).shape[0] == sc.n


def test_still_box_2d_density_normalization():
    """2-D kernel normalization: interior density of a planar lattice
    must measure ~rho0 (catches a wrong 2-D sigma immediately)."""
    from tpgsd.sph import still_box_2d

    sc = still_box_2d(n_side=16)
    rho, p = density_and_pressure(jnp.asarray(sc.state.x), sc.grid, sc.params)
    rho = numpy.asarray(rho)

    x = numpy.asarray(sc.state.x)
    margin = 2.0 * sc.params.h
    interior = (
        (x[:, 0] > margin) & (x[:, 0] < sc.box[0] - margin)
        & (x[:, 1] > margin) & (x[:, 1] < sc.box[1] - margin)
    )
    assert interior.sum() > 50
    rho_i = rho[interior]
    assert abs(rho_i.mean() / sc.params.rho0 - 1.0) < 0.05, rho_i.mean()
    assert rho_i.std() / sc.params.rho0 < 0.02


def test_periodic_density_uniform_everywhere():
    """A full periodic lattice has NO surface: every particle (not just
    interior ones) must measure ~rho0.  The crisp validation that
    periodic neighbor wrap + minimum-image separations are right."""
    from tpgsd.sph import SPHParams
    from tpgsd.sph.cells import make_grid

    n = 12
    dx = 1.0 / n
    h = 1.3 * dx
    support = 2 * h
    ax = (numpy.arange(n) + 0.5) * dx
    gx, gy, gz = numpy.meshgrid(ax, ax, ax, indexing="ij")
    x = numpy.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(
        numpy.float32
    )
    params = SPHParams(mass=1000.0 * dx**3, h=h, dt=1e-4)
    grid = make_grid((0, 0, 0), (1, 1, 1), support, capacity=64)

    rho, p = density_and_pressure(
        jnp.asarray(x), grid, params, periodic=True
    )
    rho = numpy.asarray(rho)
    # every particle, max deviation - not just interior medians
    assert abs(rho.mean() / 1000.0 - 1.0) < 0.02, rho.mean()
    assert numpy.abs(rho / 1000.0 - rho.mean() / 1000.0).max() < 0.01


def test_periodic_density_matches_bruteforce_min_image():
    """Cell-list periodic density == O(N^2) minimum-image density."""
    from tpgsd.sph import SPHParams
    from tpgsd.sph.cells import make_grid
    from tpgsd.sph.kernels import WendlandC2

    rng = numpy.random.RandomState(5)
    n = 120
    x = rng.rand(n, 3).astype(numpy.float32)
    h = 0.11
    params = SPHParams(mass=1.0, h=h, dt=1e-4)
    grid = make_grid((0, 0, 0), (1, 1, 1), 2 * h, capacity=128)

    rho, _ = density_and_pressure(jnp.asarray(x), grid, params, periodic=True)

    diff = x[:, None, :] - x[None, :, :]
    diff -= numpy.round(diff)  # unit box minimum image
    r = numpy.sqrt((diff**2).sum(-1))
    w = numpy.asarray(WendlandC2.w(jnp.asarray(r), h))
    rho_brute = params.mass * w.sum(axis=1)
    numpy.testing.assert_allclose(
        numpy.asarray(rho), rho_brute, rtol=1e-4, atol=1e-4
    )


def test_taylor_green_decays_on_mode():
    """Periodic 2-D Taylor-Green: kinetic energy decays monotonically,
    the velocity field stays correlated with the vortex mode, density
    holds ~rho0 everywhere, z stays planar."""
    from tpgsd.sph import taylor_green

    sc = taylor_green(n_side=16)
    step = jax.jit(make_step_fn(sc.grid, sc.params, periodic=True))
    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    v0 = numpy.asarray(sc.state.v)
    ke = [float((v0**2).sum())]
    for chunk in range(4):
        for _ in range(15):
            state, (rho, p, ovf) = step(state)
        v = numpy.asarray(state.v)
        ke.append(float((v**2).sum()))
    assert int(ovf) == 0
    x = numpy.asarray(state.x)
    assert numpy.isfinite(x).all()
    numpy.testing.assert_array_equal(x[:, 2], sc.state.x[:, 2])
    # monotone kinetic-energy decay (artificial viscosity dissipates)
    assert all(a > b for a, b in zip(ke, ke[1:])), ke
    # the field stays on the TG mode: correlation with the analytic
    # mode evaluated at the CURRENT positions
    two_pi = 2 * numpy.pi
    um = numpy.sin(two_pi * x[:, 0]) * numpy.cos(two_pi * x[:, 1])
    vm = -numpy.cos(two_pi * x[:, 0]) * numpy.sin(two_pi * x[:, 1])
    mode = numpy.stack([um, vm], 1).ravel()
    vel = v[:, :2].ravel()
    corr = (mode @ vel) / (
        numpy.linalg.norm(mode) * numpy.linalg.norm(vel) + 1e-12
    )
    assert corr > 0.9, corr
    # no free surface: density uniform near rho0 everywhere
    rho = numpy.asarray(rho)
    assert abs(numpy.median(rho) / sc.params.rho0 - 1.0) < 0.05


def test_dam_break_2d_stays_planar():
    """The 2-D dam break must evolve in-plane: z exactly invariant,
    everything finite, and the column collapsing (spreading in +x,
    falling in -y)."""
    from tpgsd.sph import dam_break_2d

    sc = dam_break_2d(n_side=10)
    step = jax.jit(make_step_fn(sc.grid, sc.params))
    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    x0 = numpy.asarray(sc.state.x)
    for _ in range(30):
        state, (rho, p, ovf) = step(state)
    assert int(ovf) == 0
    x = numpy.asarray(state.x)
    assert numpy.isfinite(x).all()
    numpy.testing.assert_array_equal(x[:, 2], x0[:, 2])  # planar
    # the column falls on average (individual surface particles may
    # jitter up by a fraction of h) and the front advances in +x
    assert x[:, 1].mean() < x0[:, 1].mean()
    assert x[:, 1].max() <= x0[:, 1].max() + 0.5 * sc.params.h
    assert x[:, 0].max() > x0[:, 0].max()


def test_dam_break_on_device_matches_host_builder():
    """The jitted-iota lattice and the analytic capacity must reproduce
    the host (numpy meshgrid + measured-occupancy) builder exactly:
    same particle count, same grid, same auto capacity, positions equal
    to f32 rounding."""
    import numpy

    from tpgsd.sph import dam_break

    for ns in (8, 12, 20):
        a = dam_break(n_side=ns, capacity="auto")
        b = dam_break(n_side=ns, capacity="auto", on_device=True)
        assert a.n == b.n
        assert a.grid.dims == b.grid.dims
        assert a.grid.capacity == b.grid.capacity
        numpy.testing.assert_allclose(
            numpy.asarray(a.state.x), numpy.asarray(b.state.x), atol=1e-6
        )
        assert not numpy.asarray(b.state.v).any()


def test_demo_decomp_flag(tmp_path):
    """The demo's --decomp flag runs the explicit decomposition paths
    end to end (best-fit mesh over the virtual devices, host-gathered
    dumps) and writes a readable trajectory."""
    import os
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), os.pardir, "examples")
    )
    import dam_break_demo

    import tpgsd.hoomd

    for decomp in ("slab", "2d", "3d"):
        out = str(tmp_path / ("demo_%s.gsd" % decomp))
        dam_break_demo.main(
            ["--decomp", decomp, "--steps", "4", "--every", "2",
             "--n-side", "8", "--out", out]
        )
        with tpgsd.hoomd.open(out, mode="r") as traj:
            assert len(traj) == 2
            assert traj[1].configuration.step == 2
