"""The Triton pair kernels (``tpgsd.sph.pair_kernel``) against the jnp
pair blocks of ``tpgsd.sph.step``, sweep by sweep and through a whole
``make_step_fn`` step.

On the CPU the kernels run in the Pallas interpreter, which executes
the same kernel body the GPU compiles; the compiled kernels are checked
by the ``gpu``-marked test below and by ``chip_smoke.py``'s ``kernel``
phase on the card.  Both use ``chip_smoke.sweep_parity``.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy
import pytest

from tpgsd.sph import SPHParams, SPHState, dam_break, init_density, make_step_fn
from tpgsd.sph import pair_kernel as pk
from tpgsd.sph.cells import (
    CellGrid,
    build_cells,
    make_grid,
    neighbor_table,
    scatter_to_cells,
)
from tpgsd.sph.step import _density_blocks, pair_sweeps

#: interpreter vs jnp: the kernel sums the 27 neighbour cells chunk by
#: chunk, XLA in one reduction - a few float32 roundoffs of the largest
#: term (measured <= 1e-6), so 1e-5 of the largest magnitude
TOL = 1e-5

CAPACITIES = (24, 48, 64, 128)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep_parity = _chip_smoke().sweep_parity


@functools.lru_cache(maxsize=None)
def _parity(periodic, capacity, dim):
    """One random cloud per configuration, filled to ~60% of capacity
    (Poisson tails reach it), all three sweeps compared at once."""
    dims = (4, 3, 3) if dim == 3 else (5, 4, 1)
    cell = 0.25
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=cell, dims=dims,
                    capacity=capacity)
    rng = numpy.random.default_rng(capacity + 10 * dim + int(periodic))
    n = int(0.6 * capacity * grid.n_cells)
    x = rng.uniform(0.0, 1.0, (n, 3)) * numpy.asarray(dims) * cell
    if dim == 2:
        x[:, 2] = 0.5 * cell
    v = rng.normal(scale=0.05, size=(n, 3))
    if dim == 2:
        v[:, 2] = 0.0
    params = SPHParams(
        mass=0.02 * (cell ** dim) / capacity * 1000.0, h=0.5 * cell,
        dt=1e-4, c0=20.0, dim=dim,
    )
    return sweep_parity(
        jnp.asarray(x, jnp.float32), jnp.asarray(v, jnp.float32), grid,
        params, periodic=periodic, interpret=True,
    )


@pytest.mark.parametrize("dim", [3, 2], ids=["3d", "2d"])
@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
@pytest.mark.parametrize(
    "sweep", ["density", "accel", "accel_drho_acc", "accel_drho_drho"]
)
def test_sweep_matches_jnp(sweep, periodic, capacity, dim):
    assert _parity(periodic, capacity, dim)[sweep] <= TOL


def _step_scenario(periodic, capacity):
    """Walls: a small dam break.  Periodic: a jittered lattice at rest
    density that tiles a (4, 3, 3)-cell box exactly, with random
    velocities, so pairs across every wrapped face carry pressure and
    viscosity."""
    if not periodic:
        db = dam_break(n_side=6, capacity=capacity)
        return db.grid, db.params, db.state
    dx = 0.1
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=3 * dx, dims=(4, 3, 3),
                    capacity=capacity)
    extent = 3 * dx * numpy.asarray(grid.dims)
    axes = [(numpy.arange(round(e / dx)) + 0.5) * dx for e in extent]
    x = numpy.stack(numpy.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    rng = numpy.random.default_rng(11)
    x = numpy.mod(x + rng.uniform(-0.2, 0.2, x.shape) * dx, extent)
    v = rng.normal(scale=0.5, size=x.shape)
    params = SPHParams(mass=1000.0 * dx ** 3, h=1.5 * dx, dt=1e-4,
                       gravity=(0.0, 0.0, 0.0))
    state = SPHState(x=jnp.asarray(x, jnp.float32),
                     v=jnp.asarray(v, jnp.float32))
    return grid, params, state


@pytest.mark.parametrize("capacity", [48, 128])
@pytest.mark.parametrize("mode", ["summation", "continuity"])
@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
def test_step_with_kernels_matches_jnp(periodic, mode, capacity):
    """Two ``make_step_fn`` steps on the kernels (the path ``"auto"``
    picks on a GPU) against the same steps on the jnp blocks: the
    builder's wiring of the sweeps, not only the sweeps."""
    grid, params, state = _step_scenario(periodic, capacity)
    if mode == "continuity":
        state = init_density(state, grid, params, periodic=periodic)
    kw = dict(periodic=periodic, density_mode=mode)
    step_ref = jax.jit(make_step_fn(grid, params, use_pallas=False, **kw))
    step_ker = jax.jit(make_step_fn(grid, params, use_pallas=True,
                                    pallas_interpret=True, **kw))
    assert step_ker.resolved["use_pallas"]
    s_ref = s_ker = state
    for _ in range(2):
        s_ref, (rho_ref, _, _) = step_ref(s_ref)
        s_ker, (rho_ker, _, _) = step_ker(s_ker)
    numpy.testing.assert_allclose(
        numpy.asarray(s_ker.x), numpy.asarray(s_ref.x), rtol=1e-5, atol=1e-6
    )
    vmax = float(jnp.max(jnp.abs(s_ref.v)))
    numpy.testing.assert_allclose(
        numpy.asarray(s_ker.v), numpy.asarray(s_ref.v), rtol=1e-4,
        atol=1e-5 * vmax,
    )
    numpy.testing.assert_allclose(
        numpy.asarray(rho_ker), numpy.asarray(rho_ref), rtol=1e-5, atol=1e-3
    )


@pytest.mark.parametrize(
    "k, kp", [(1, 8), (8, 8), (9, 16), (24, 32), (48, 64), (64, 64),
              (65, 128), (128, 128)],
)
def test_padded_capacity(k, kp):
    assert pk.padded_capacity(k) == kp


def _cloud(n=300, capacity=24, seed=0):
    grid = CellGrid(lo=(0.0, 0.0, 0.0), cell_size=0.25, dims=(3, 3, 3),
                    capacity=capacity)
    x = numpy.random.default_rng(seed).uniform(0.0, 0.75, (n, 3))
    params = SPHParams(mass=0.01, h=0.125, dt=1e-4)
    x = jnp.asarray(x, jnp.float32)
    cells = build_cells(x, grid)
    return grid, params, scatter_to_cells(x, cells, grid), cells.mask


def test_missing_sentinel_row_raises():
    grid, params, dx, mask = _cloud()
    nbr = neighbor_table(grid)
    with pytest.raises(ValueError, match="sentinel"):
        pk.density(dx[:-1], mask[:-1], nbr, params, interpret=True)


def test_mask_with_gaps_matches_jnp():
    """Chunks are skipped past a cell's LAST live slot, not its count:
    a mask with holes (dead slots between live ones) still sums every
    live neighbour."""
    grid, params, dx, mask = _cloud(n=500, capacity=48)
    holes = jnp.arange(48)[None, :] % 3 == 1
    mask = mask & ~holes
    nbr = neighbor_table(grid)
    ref = _density_blocks(dx, mask, nbr, params, pk.WendlandC2, 32)
    out = pk.density(dx, mask, nbr, params, interpret=True)
    numpy.testing.assert_allclose(
        numpy.asarray(out), numpy.asarray(ref), rtol=TOL,
        atol=TOL * float(jnp.max(ref)),
    )


def test_output_shapes_follow_capacity():
    """Outputs come back at the caller's capacity, not the padded one,
    with one row per cell of the neighbour table."""
    grid, params, dx, mask = _cloud(capacity=24)
    nbr = neighbor_table(grid)
    rho = jnp.full(mask.shape, 1000.0)
    p = jnp.zeros(mask.shape)
    assert pk.density(dx, mask, nbr, params, interpret=True).shape == (27, 24)
    assert pk.accel(dx, dx, rho, p, mask, nbr, params,
                    interpret=True).shape == (27, 24, 3)
    assert pk.accel_drho(dx, dx, rho, p, mask, nbr, params,
                         interpret=True).shape == (27, 24, 4)


def test_pair_sweeps_selects_path():
    """``pair_sweeps`` routes to the kernels or the jnp blocks, and the
    two agree through the common signature."""
    grid, params, dx, mask = _cloud()
    nbr = neighbor_table(grid)
    ker = pair_sweeps(True, interpret=True)
    ref = pair_sweeps(False)
    a = ker.density(dx, mask, nbr, params, pk.WendlandC2)
    b = ref.density(dx, mask, nbr, params, pk.WendlandC2)
    numpy.testing.assert_allclose(
        numpy.asarray(a), numpy.asarray(b), rtol=TOL,
        atol=TOL * float(jnp.max(b)),
    )


def test_compiled_kernel_refused_on_cpu():
    """No silent interpreter: a compiled call on the CPU backend raises."""
    grid, params, dx, mask = _cloud()
    nbr = neighbor_table(grid)
    with pytest.raises(Exception, match="interpret"):
        jax.jit(lambda d, m: pk.density(d, m, nbr, params))(dx, mask)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True], ids=["walls", "periodic"])
def test_compiled_kernels_match_jnp(gpu, periodic):
    """The compiled kernels against the jnp blocks on the card (the
    same check ``chip_smoke.py`` runs at 1e6 particles)."""
    db = dam_break(n_side=20, capacity="auto")
    x = jnp.asarray(db.state.x)
    v = jnp.asarray(
        numpy.random.default_rng(0).normal(scale=0.1, size=x.shape),
        jnp.float32,
    )
    errs = sweep_parity(x, v, db.grid, db.params, periodic=periodic)
    assert max(errs.values()) <= TOL, errs
