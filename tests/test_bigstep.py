"""Slab-sequential big step (tpgsd.sph.bigstep) vs the global step.

The slab step must reproduce the global step's physics - same kernels,
only the evaluation order differs - so parity is tight float-reassoc
tolerance, not a physics-level check.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

from tpgsd.sph import SPHState, dam_break, make_slab_step_fn, make_step_fn


def _scenario(n_side=10, capacity=48):
    return dam_break(n_side=n_side, capacity=capacity)


def _divisor(nx, want=2):
    for s in range(want, 0, -1):
        if nx % s == 0:
            return s
    return 1


def test_slab_step_matches_global_step():
    db = _scenario()
    step_g = jax.jit(make_step_fn(db.grid, db.params, use_pallas=False))
    step_s = jax.jit(
        make_slab_step_fn(db.grid, db.params, n_slabs=3, use_pallas=False)
    )
    assert db.grid.dims[0] % 3 == 0, db.grid.dims

    sg, (rg, pg, og) = step_g(db.state)
    ss, (rs, ps, os_, ws) = step_s(db.state)
    assert int(ws) == 0
    assert int(os_) == int(og)
    numpy.testing.assert_allclose(rs, rg, rtol=2e-5, atol=1e-2)
    numpy.testing.assert_allclose(ss.x, sg.x, rtol=1e-5, atol=1e-7)
    numpy.testing.assert_allclose(ss.v, sg.v, rtol=2e-4, atol=2e-4)


def test_slab_step_multiple_steps_stay_in_lockstep():
    # wall-free dynamics: the reflective-wall branch is discontinuous,
    # so runs compiled with different reduction trees diverge O(1)
    # across a bounce no matter how tight the per-step parity; a
    # perturbed zero-gravity box exercises 5 full steps of pair math
    # without any particle touching a wall
    from tpgsd.sph import still_box

    sc = still_box(n_side=8)
    amp = 0.02 * sc.grid.cell_size / sc.params.dt / 100.0
    v0 = amp * jnp.sin(
        jnp.arange(sc.state.x.size, dtype=jnp.float32)
    ).reshape(sc.state.x.shape)
    state0 = SPHState(x=sc.state.x, v=v0)
    step_g = jax.jit(make_step_fn(sc.grid, sc.params, use_pallas=False))
    step_s = jax.jit(
        make_slab_step_fn(
            sc.grid, sc.params, n_slabs=_divisor(sc.grid.dims[0], 3),
            use_pallas=False,
        )
    )
    sg, ss = state0, state0
    for _ in range(5):
        sg, _ = step_g(sg)
        ss, aux = step_s(ss)
        assert int(aux[3]) == 0
    numpy.testing.assert_allclose(ss.x, sg.x, rtol=1e-4, atol=1e-6)
    numpy.testing.assert_allclose(ss.v, sg.v, rtol=1e-3, atol=1e-4)


def test_slab_step_pallas_interpret_parity():
    db = _scenario(n_side=8)
    step_g = jax.jit(make_step_fn(db.grid, db.params, use_pallas=False))
    step_s = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=_divisor(db.grid.dims[0], 3),
            use_pallas=True, pallas_interpret=True,
        )
    )
    sg, _ = step_g(db.state)
    ss, aux = step_s(db.state)
    assert int(aux[3]) == 0
    numpy.testing.assert_allclose(ss.x, sg.x, rtol=1e-4, atol=1e-6)
    numpy.testing.assert_allclose(ss.v, sg.v, rtol=2e-3, atol=2e-3)


def test_window_overflow_is_counted_not_silent():
    db = _scenario(n_side=8)
    # a window far below the slab population must be REPORTED
    step_s = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=_divisor(db.grid.dims[0], 3),
            window=16, use_pallas=False,
        )
    )
    _, aux = step_s(db.state)
    assert int(aux[3]) > 0


def test_n_fixed_boundary_particles_do_not_move():
    from tpgsd.sph import hydrostatic_tank

    sc = hydrostatic_tank(n_side=6)
    slabs = _divisor(sc.grid.dims[0], 3)
    step_s = jax.jit(
        make_slab_step_fn(
            sc.grid, sc.params, n_slabs=slabs, use_pallas=False,
            n_fixed=sc.n_fixed,
        )
    )
    out, aux = step_s(sc.state)
    numpy.testing.assert_array_equal(
        out.x[: sc.n_fixed], sc.state.x[: sc.n_fixed]
    )
    assert float(jnp.abs(out.v[: sc.n_fixed]).max()) == 0.0


def test_bad_slab_count_raises():
    db = _scenario()
    with pytest.raises(ValueError):
        make_slab_step_fn(db.grid, db.params, n_slabs=db.grid.dims[0] + 1)


def test_density_renorm_parity_with_global_step():
    from tpgsd.sph import hydrostatic_tank

    sc = hydrostatic_tank(n_side=6)
    slabs = _divisor(sc.grid.dims[0], 3)
    kw = dict(n_fixed=sc.n_fixed, density_renorm=True, use_pallas=False)
    step_g = jax.jit(make_step_fn(sc.grid, sc.params, **kw))
    step_s = jax.jit(make_slab_step_fn(sc.grid, sc.params, n_slabs=slabs, **kw))
    sg, (rg, _, _) = step_g(sc.state)
    ss, (rs, _, _, w) = step_s(sc.state)
    assert int(w) == 0
    assert float(jnp.min(rs)) >= sc.params.rho0  # the floor holds
    numpy.testing.assert_allclose(rs, rg, rtol=2e-5, atol=1e-2)
    numpy.testing.assert_allclose(ss.x, sg.x, rtol=1e-5, atol=1e-7)


def test_continuity_slab_step_matches_global_continuity():
    """Continuity-density slab step: the carried rho rides the sorted
    features (7th column) and ONE fused accel+drho sweep per slab
    replaces the density+accel pair - lockstep with the global
    continuity step."""
    from tpgsd.sph import init_density

    db = _scenario()
    st0 = init_density(db.state, db.grid, db.params)
    kw = dict(density_mode="continuity", use_pallas=False)
    step_g = jax.jit(make_step_fn(db.grid, db.params, **kw))
    step_s = jax.jit(make_slab_step_fn(db.grid, db.params, n_slabs=3, **kw))
    sg, ss = st0, st0
    for _ in range(3):
        sg, (rg, _pg, _og) = step_g(sg)
        ss, (rs, _ps, _os, w) = step_s(ss)
        assert int(w) == 0
    numpy.testing.assert_allclose(ss.x, sg.x, rtol=1e-5, atol=1e-6)
    numpy.testing.assert_allclose(ss.v, sg.v, rtol=5e-4, atol=5e-4)
    numpy.testing.assert_allclose(rs, rg, rtol=5e-4)


def test_slab_init_density_matches_init_density():
    from tpgsd.sph import init_density, slab_init_density

    db = _scenario()
    st_g = init_density(db.state, db.grid, db.params)
    st_s = slab_init_density(db.state, db.grid, db.params, 3)
    numpy.testing.assert_allclose(st_s.rho, st_g.rho, rtol=2e-5, atol=1e-2)


def test_continuity_slab_requires_rho():
    db = _scenario()
    step_s = jax.jit(
        make_slab_step_fn(db.grid, db.params, n_slabs=3,
                          density_mode="continuity", use_pallas=False)
    )
    with pytest.raises(ValueError, match="slab_init_density"):
        step_s(db.state)


def test_continuity_renorm_rejected():
    db = _scenario()
    with pytest.raises(ValueError, match="delta_sph"):
        make_slab_step_fn(db.grid, db.params, n_slabs=3,
                          density_mode="continuity", density_renorm=True)
