"""The jnp WCSPH step against an independent plain reference.

``reference_step`` is a brute-force float64 numpy implementation of the
same scheme - all pairs, no cell list, no dense layout, no blocks:
density summation or continuity with delta-SPH diffusion, Tait EOS,
pressure plus Monaghan viscosity, symplectic Euler, reflective walls or
periodic wrap, static boundary particles.  It shares no code with
``tpgsd.sph`` beyond the scenario builders, so agreement checks the
cell list, the neighbour table, the layout gathers and the blocked pair
sums together.
"""

import math

import jax
import jax.numpy as jnp
import numpy
import pytest

from tpgsd.sph import (
    SPHState,
    dam_break,
    dam_break_2d,
    hydrostatic_tank,
    init_density,
    make_step_fn,
    taylor_green,
)


def _wendland(r, h, dim):
    """Wendland C2 ``(W, (1/r) dW/dr)`` in float64."""
    sigma = (21.0 / (16.0 * math.pi * h**3) if dim == 3
             else 7.0 / (4.0 * math.pi * h**2))
    q = r / h
    t = numpy.maximum(1.0 - 0.5 * q, 0.0)
    return sigma * t**4 * (2.0 * q + 1.0), -5.0 * sigma * t**3 / (h * h)


def reference_step(x, v, rho, grid, params, periodic=False, n_fixed=0,
                   density_mode="summation", delta_sph=0.1):
    """One WCSPH step over all particle pairs in float64.

    Returns ``(x, v, rho, p)`` after the step (``rho``/``p`` are the
    densities and pressures the step's forces used in summation mode,
    the updated carried density in continuity mode).
    """
    x = numpy.asarray(x, numpy.float64)
    v = numpy.asarray(v, numpy.float64)
    lo = numpy.asarray(grid.lo, numpy.float64)
    ext = grid.cell_size * numpy.asarray(grid.dims, numpy.float64)
    hi = lo + ext
    wrap = (numpy.asarray(grid.dims) >= 3) & bool(periodic)
    m, h = params.mass, params.h

    dx = x[:, None, :] - x[None, :, :]
    dx = numpy.where(wrap, dx - ext * numpy.round(dx / ext), dx)
    r2 = numpy.sum(dx * dx, axis=-1)
    r = numpy.sqrt(r2)
    w, dwr = _wendland(r, h, params.dim)

    if density_mode == "summation":
        rho_s = m * numpy.sum(w, axis=1)
    else:
        rho_s = numpy.asarray(rho, numpy.float64)
    rho_s = numpy.maximum(rho_s, 0.1 * params.rho0)
    B = params.rho0 * params.c0**2 / params.gamma
    p = B * ((rho_s / params.rho0) ** params.gamma - 1.0)

    dv = v[:, None, :] - v[None, :, :]
    vdotx = numpy.sum(dv * dx, axis=-1)
    mu = vdotx / (r2 + params.eps * h * h)
    rho_bar = 0.5 * (rho_s[:, None] + rho_s[None, :])
    visc = numpy.where(
        vdotx < 0.0, -params.alpha * params.c0 * h * mu / rho_bar, 0.0
    )
    press = p[:, None] / rho_s[:, None] ** 2 + p[None, :] / rho_s[None, :] ** 2
    acc = -m * numpy.sum(((press + visc) * dwr)[..., None] * dx, axis=1)
    acc = acc + numpy.asarray(params.gravity, numpy.float64)

    if density_mode == "continuity":
        drho = m * numpy.sum(dwr * vdotx, axis=1)
        if delta_sph > 0.0:
            eta2 = (0.1 * h) ** 2
            drho = drho + 2.0 * delta_sph * h * params.c0 * m * numpy.sum(
                (rho_s[:, None] - rho_s[None, :]) / rho_s[None, :]
                * dwr * r2 / (r2 + eta2),
                axis=1,
            )
        rho_out = numpy.maximum(rho_s + params.dt * drho, 0.1 * params.rho0)
        p_out = B * ((rho_out / params.rho0) ** params.gamma - 1.0)
    else:
        rho_out, p_out = rho_s, p

    v_new = (v + params.dt * acc) * params.velocity_damping
    x_new = x + params.dt * v_new
    under, over = x_new < lo, x_new > hi
    refl = numpy.where(under, 2.0 * lo - x_new, x_new)
    refl = numpy.where(over, 2.0 * hi - refl, refl)
    refl = numpy.clip(refl, lo, hi)
    bounce = (under | over) & ~wrap
    x_new = numpy.where(wrap, lo + numpy.mod(x_new - lo, ext), refl)
    v_new = numpy.where(bounce, -params.wall_damping * v_new, v_new)
    if n_fixed:
        x_new[:n_fixed] = x[:n_fixed]
        v_new[:n_fixed] = 0.0
    return x_new, v_new, rho_out, p_out


SCENARIOS = {
    "dam_break_3d": lambda: (dam_break(n_side=8, capacity="auto"), {}),
    "dam_break_2d": lambda: (dam_break_2d(n_side=16, capacity="auto"), {}),
    "taylor_green": lambda: (taylor_green(n_side=20, capacity="auto"),
                             {"periodic": True}),
    "hydrostatic": lambda: (hydrostatic_tank(n_side=6, capacity="auto"),
                            {"n_fixed": "n_fixed"}),
}

#: float32 jnp step vs float64 reference after 3 steps.  Positions move
#: by dt * v per step, so their error is a few float32 ulps of the box
#: coordinate; the summed pair terms carry float32 roundoff of their
#: largest addend, so v, rho and p are compared relative to their own
#: scale (p = B (rho/rho0)^7 amplifies a density error sevenfold).
#: Measured: x <= 1e-7 of the box, v <= 3e-6, rho <= 1.1e-6,
#: p <= 6.4e-5.
STEPS = 3


@pytest.mark.parametrize("density_mode", ["summation", "continuity"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_matches_float64_reference(name, density_mode):
    sc, kw = SCENARIOS[name]()
    if kw.get("n_fixed"):
        kw = dict(kw, n_fixed=sc.n_fixed)
    state = SPHState(x=jnp.asarray(sc.state.x), v=jnp.asarray(sc.state.v))
    if density_mode == "continuity":
        state = init_density(state, sc.grid, sc.params,
                             periodic=kw.get("periodic", False))
    step = jax.jit(make_step_fn(sc.grid, sc.params, use_pallas=False,
                                density_mode=density_mode, **kw))

    x = numpy.asarray(state.x, numpy.float64)
    v = numpy.asarray(state.v, numpy.float64)
    rho = None if state.rho is None else numpy.asarray(state.rho, numpy.float64)
    for _ in range(STEPS):
        state, (rho_j, p_j, overflow) = step(state)
        assert int(overflow) == 0
        x, v, rho, p = reference_step(
            x, v, rho, sc.grid, sc.params, density_mode=density_mode, **kw
        )

    box = float(numpy.max(numpy.abs(x)))
    vscale = max(float(numpy.max(numpy.abs(v))), 1e-3)
    numpy.testing.assert_allclose(numpy.asarray(state.x), x, rtol=0,
                                  atol=2e-6 * box)
    numpy.testing.assert_allclose(numpy.asarray(state.v), v, rtol=0,
                                  atol=1e-4 * vscale)
    numpy.testing.assert_allclose(numpy.asarray(rho_j), rho, rtol=1e-5)
    numpy.testing.assert_allclose(
        numpy.asarray(p_j), p, rtol=0,
        atol=3e-4 * max(float(numpy.max(numpy.abs(p))), 1.0),
    )
