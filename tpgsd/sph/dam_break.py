"""Dam-break scenario: the canonical WCSPH demo and benchmark workload.

A block of fluid at rest in one corner of a box collapses under gravity
and sloshes.  Produces the initial state, grid, and parameters sized so
the simulation is stable at the returned ``dt`` (CFL on the artificial
sound speed).
"""

import math
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from .cells import auto_capacity, make_grid
from .step import SPHParams, SPHState


class DamBreak(NamedTuple):
    state: SPHState
    grid: object  # CellGrid
    params: SPHParams
    box: tuple  # (lx, ly, lz) domain size
    n: int  # particle count


def dam_break(
    n_side=20,
    box=(2.0, 1.0, 1.0),
    fill=(0.5, 1.0, 0.8),
    spacing=None,
    capacity=64,
    rho0=1000.0,
    c0=None,
    dtype=jnp.float32,
    on_device=False,
    capacity_headroom=1.5,
):
    """Build a dam-break initial condition.

    Args:
        n_side: particles along the z edge of the fluid block; total count
            scales with the fill fractions.
        box: domain extents (lx, ly, lz).
        fill: fluid block extents as fractions of the box.
        spacing: particle spacing (default: fluid height / n_side).
        capacity: cell-list slot capacity; ``"auto"`` sizes it to the
            initial lattice occupancy (pair math scales with
            capacity^2 - see :func:`tpgsd.sph.cells.auto_capacity`).
        capacity_headroom: safety factor for ``capacity="auto"``.  The
            default 1.5 covers sloshing transients (run max measured
            ~1.6x the initial densest cell).
        rho0: rest density.
        c0: artificial sound speed (default 10x the peak fall speed).

    Returns:
        :class:`DamBreak` with ``n = prod(block_dims)`` particles.

    ``on_device=True`` builds the lattice with a jitted iota kernel
    (no host meshgrid, no host->device transfer - minutes saved at 1e8
    particles) and sizes ``capacity="auto"``
    analytically from the lattice geometry.
    """
    lz_fluid = box[2] * fill[2]
    dx = spacing if spacing is not None else lz_fluid / n_side
    h = 1.3 * dx
    support = 2.0 * h

    counts = [max(1, int(round(box[d] * fill[d] / dx))) for d in range(3)]
    n = counts[0] * counts[1] * counts[2]

    mass = rho0 * dx**3
    v_max = math.sqrt(2.0 * 9.81 * lz_fluid)
    if c0 is None:
        c0 = 10.0 * max(v_max, 1.0)
    dt = 0.25 * h / c0  # CFL on the sound speed

    grid0 = make_grid((0.0, 0.0, 0.0), box, support, 8)
    if capacity == "auto" and on_device:
        # a lattice's densest cell is computable without materializing
        # the positions: per axis, cell j spans [j c, (j+1) c) and holds
        # the lattice planes (i + 0.5) dx inside it - an exact scan
        # over the (few hundred) cells per axis, no 1e8-row bincount
        cell0 = grid0.cell_size
        m0 = 1
        for d in range(3):
            j = np.arange(grid0.dims[d], dtype=np.float64)
            lo_i = np.maximum(np.ceil(j * cell0 / dx - 0.5), 0)
            hi_i = np.minimum(
                np.ceil((j + 1) * cell0 / dx - 0.5), counts[d]
            )
            m0 *= int(np.maximum(hi_i - lo_i, 0).max())
        capacity = max(8, int(-(-capacity_headroom * m0 // 8) * 8))

    if on_device:
        # build the lattice ON the device: at 1e8 particles the host
        # meshgrid costs minutes of numpy + a 1.2 GB host->device
        # transfer; the jitted iota
        # version is milliseconds with zero transfer
        import jax

        cy, cz = counts[1], counts[2]

        @jax.jit
        def lattice():
            i = jnp.arange(n, dtype=jnp.int32)
            ix = i // (cy * cz)
            rem = i - ix * (cy * cz)
            iy = rem // cz
            iz = rem - iy * cz
            idx = jnp.stack([ix, iy, iz], axis=1).astype(jnp.dtype(dtype))
            return (idx + 0.5) * jnp.asarray(dx, jnp.dtype(dtype))

        x0 = lattice()
        state = SPHState(x=x0, v=jnp.zeros_like(x0))
    else:
        axes = [(np.arange(c) + 0.5) * dx for c in counts]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        x0 = np.stack(
            [gx.ravel(), gy.ravel(), gz.ravel()], axis=1
        ).astype(np.float32)
        if capacity == "auto":
            capacity = auto_capacity(
                x0, (0.0, 0.0, 0.0), box, support,
                headroom=capacity_headroom,
            )
        # host (numpy) arrays: the first jitted call transfers them with
        # the executable's arguments; eager device placement here would
        # add a standalone transfer at build time
        x_host = np.asarray(x0, dtype=np.dtype(str(jnp.dtype(dtype))))
        state = SPHState(x=x_host, v=np.zeros_like(x_host))

    grid = make_grid((0.0, 0.0, 0.0), box, support, capacity)
    params = SPHParams(
        mass=float(mass), h=float(h), dt=float(dt), rho0=float(rho0), c0=float(c0)
    )
    return DamBreak(state=state, grid=grid, params=params, box=box, n=n)
