"""Weakly-compressible SPH step: density -> EOS -> forces -> integrate.

Formulation (standard WCSPH; the physics behind the reference's SPH schema
fields, pgsd/doc/pgsd.tex:525-565):

* density summation  rho_i = sum_j m W(r_ij, h)
* Tait EOS           p = (rho0 c0^2 / gamma) ((rho/rho0)^gamma - 1)
* momentum           dv_i/dt = -sum_j m (p_i/rho_i^2 + p_j/rho_j^2
                      + Pi_ij) grad_W_ij + g   (Monaghan artificial
                      viscosity Pi_ij)
* symplectic Euler (kick-drift) + reflective box walls

Compute structure: all pair interactions happen inside 27-cell
neighborhoods of the dense cell layout (``tpgsd.sph.cells``).  The plain
path processes cells in fixed-size blocks under ``lax.map`` so the peak
intermediate is ``[block, K, 27K]`` - a few MB - regardless of domain
size; everything is static-shaped, mask-predicated jnp.  On a GPU the
density, accel and fused accel+drho sweeps run as Pallas kernels
through Triton instead (``tpgsd.sph.pair_kernel``), one program per
cell with the pair block in registers.

Multi-chip: jit the returned step function with the particle axis sharded
(``NamedSharding(mesh, P("shard"))``); the scatter/gather between particle
order and the cell-dense layout gives XLA the halo pattern and it inserts
the collectives (the scaling-book recipe: annotate, let GSPMD place
comms).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cells import (
    build_cells,
    gather_from_cells,
    neighbor_table,
    scatter_to_cells,
)
from .kernels import WendlandC2


class SPHParams(NamedTuple):
    """Physical + numerical parameters (trace-time constants)."""

    mass: float  # per-particle mass
    h: float  # smoothing length
    dt: float  # time step
    rho0: float = 1000.0  # rest density
    c0: float = 40.0  # artificial speed of sound
    gamma: float = 7.0  # Tait exponent
    alpha: float = 0.1  # artificial viscosity strength
    gravity: tuple = (0.0, 0.0, -9.81)
    wall_damping: float = 0.5  # velocity retained on wall reflection
    eps: float = 0.01  # viscosity denominator regularizer (times h^2)
    velocity_damping: float = 1.0  # global per-step velocity factor
    # (< 1 = overdamped relaxation for settling initial conditions)
    dim: int = 3  # spatial dimension (2 = planar flow: z collapsed to a
    # single cell plane, kernel normalization switched to its 2-D value)


class SPHState(NamedTuple):
    """Dynamic state: positions and velocities, ``[N, 3]`` float32.

    ``rho`` is carried only in continuity-density mode
    (``make_step_fn(density_mode="continuity")``), where density is a
    state variable evolved by the continuity equation instead of being
    re-summed from positions each step; the default summation mode
    leaves it ``None`` (a static empty pytree slot - no cost under
    jit).  Seed it with :func:`init_density`.
    """

    x: jax.Array
    v: jax.Array
    rho: jax.Array = None


def tait_pressure(rho, params):
    """Tait equation of state."""
    B = params.rho0 * params.c0**2 / params.gamma
    return B * ((rho / params.rho0) ** params.gamma - 1.0)


def _pad_cells(arr, block):
    """Pad the leading (cell) axis to a multiple of ``block``."""
    c = arr.shape[0]
    rem = (-c) % block
    if rem == 0:
        return arr
    pad = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, pad)


def _min_image(diff, mimage):
    """Wrap pair separations to the nearest periodic image.

    ``mimage`` is a (3,) extent vector with a huge finite sentinel on
    non-periodic axes (round(x/huge) == 0 leaves those components
    untouched; an actual inf would produce inf * 0 = NaN).
    """
    if mimage is None:
        return diff
    m = jnp.asarray(mimage, diff.dtype)
    return diff - m * jnp.round(diff / m)


def _density_blocks(dense_x, mask, nbr, params, kernel, block, mimage=None):
    """Per-slot density over cell blocks -> ``[n_cells, K]``."""
    c, k = nbr.shape[0], dense_x.shape[1]
    nbr_p = _pad_cells(nbr, block)  # padded rows point at sentinel 0-cells? no:
    # padded rows are all-zero -> they gather cell 0; their outputs are
    # sliced off below and their masks are False via mask_p
    x_p = _pad_cells(dense_x[:c], block)
    mask_p = _pad_cells(mask[:c], block)
    nblocks = x_p.shape[0] // block

    def one_block(args):
        xb, mb, nb = args  # [B,K,3], [B,K], [B,27]
        y = dense_x[nb].reshape(block, 27 * k, 3)  # [B,27K,3]
        ym = mask[nb].reshape(block, 27 * k)  # [B,27K]
        diff = _min_image(xb[:, :, None, :] - y[:, None, :, :], mimage)
        r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        w = kernel.w(r, params.h, dim=params.dim) * ym[:, None, :]
        return params.mass * jnp.sum(w, axis=-1) * mb  # [B,K]

    rho = jax.lax.map(
        one_block,
        (
            x_p.reshape(nblocks, block, k, 3),
            mask_p.reshape(nblocks, block, k),
            nbr_p.reshape(nblocks, block, 27),
        ),
    )
    return rho.reshape(-1, k)[:c]


def _renormalize_density(rho, params):
    """Clipped rest-volume Shepard normalization of summation density.

    The Shepard partition-of-unity at rest volume is
    ``s0_i = sum_j (m/rho0) W_ij``, which for summation density is
    IDENTICALLY ``rho_i / rho0`` - so dividing by ``min(s0, 1)``
    (clipping so the normalization never *reduces* a legitimately
    compressed density) collapses to the closed form

        rho_hat = max(rho, rho0)

    i.e. the Hughes & Graham (2010) free-surface density floor, derived
    rather than asserted.  It removes the free-surface support-truncation
    deficit (raw summation measures ~0.85 rho0 at a surface) and the
    spurious NEGATIVE Tait pressures that deficit produces - a source
    of hydrostatic ringing.  Costs nothing: no extra pair pass.

    Note the *general* Shepard filter ``rho / sum_j (m/rho_j) W_ij``
    with the current densities is a no-op for summation density (the
    sum is ~1 everywhere by construction - measured: surface deficit
    0.858 -> 0.854); it only adds information for evolved
    (continuity-equation) density, which this stepper does not use.
    """
    return jnp.maximum(rho, params.rho0)


def _xsph_blocks(
    dense_x, dense_v, dense_rho, mask, nbr, params, kernel, block, mimage=None
):
    """Per-slot XSPH velocity correction -> ``[n_cells, K, 3]``.

    Monaghan's XSPH variant: particles DRIFT with a locally-averaged
    velocity

        dv_i = sum_j (2 m / (rho_i + rho_j)) (v_j - v_i) W_ij

    (the momentum kick is unchanged), which damps particle-scale
    velocity disorder - the dominant source of summation-density /
    pressure noise in WCSPH - without viscosity's energy loss.  The
    pair weight is symmetric and the velocity difference antisymmetric,
    so total momentum is conserved exactly
    (``test_xsph_conserves_momentum``).
    """
    k = dense_x.shape[1]

    def one_block(args):
        xb, vb, rhob, _pb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        vy = dense_v[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        ym = mask[nb].reshape(block, 27 * k)

        dx = _min_image(xb[:, :, None, :] - y[:, None, :, :], mimage)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        w = kernel.w(r, params.h, dim=params.dim)
        coef = (
            2.0 * params.mass / (rhob[:, :, None] + rhoy[:, None, :])
        ) * w * ym[:, None, :]
        dv = vy[:, None, :, :] - vb[:, :, None, :]
        out = jnp.sum(coef[..., None] * dv, axis=-2)  # [B, K, 3]
        return out * mb[..., None]

    return _pair_blocks(
        one_block,
        (dense_x, dense_v, dense_rho, dense_rho),
        mask, nbr, block, (3,),
    )


def _cohesion_c(r, hs):
    """Akinci et al. (2013) cohesion spline ``C(r)`` at support ``hs``.

    Piecewise sextic with 3-D normalization ``32/(pi hs^9)``: attractive
    over ``hs/2 < r <= hs``, turning repulsive below ``~hs/4`` (the
    ``-hs^6/64`` shift) so cohesion alone never collapses particles
    onto each other.  ``hs`` is the kernel SUPPORT (2h in this
    framework's h convention), so cohesion reaches exactly the pairs
    the cell list already visits.
    """
    c = 32.0 / (jnp.pi * hs**9)
    hr = jnp.maximum(hs - r, 0.0)
    core = hr**3 * r**3
    outer = jnp.where(r <= hs, core, 0.0)
    inner = 2.0 * core - hs**6 / 64.0
    return c * jnp.where(r > 0.5 * hs, outer, inner)


def _cohesion_blocks(
    dense_x, dense_rho, mask, nbr, params, kernel, block, gamma, mimage=None
):
    """Per-slot surface-tension acceleration -> ``[c, K, 3]``.

    The Akinci et al. (2013) surface-tension model, both terms:

        a_i = -gamma * sum_j K_ij [ m C(|dx|) dx/|dx| + (n_i - n_j) ],
        n_i = hs * sum_j (m / rho_j) grad_W_ij,
        K_ij = 2 rho0 / (rho_i + rho_j)

    cohesion (the spline term) pulls surface particles together;
    the curvature term (the normal difference - normals point out of
    the fluid and vanish in the bulk, so ``n_i - n_j`` measures local
    curvature) flattens high-curvature regions and is what makes drops
    round rather than merely clumped.  Both pair terms are
    antisymmetric under i<->j (equal masses), so total momentum is
    conserved exactly (``test_surface_tension_conserves_momentum``);
    the ``K_ij`` correction keeps force magnitudes rest-density-scaled
    at free surfaces.  Costs two pair passes (normals, then forces).
    """
    n_dense = _st_normals_blocks(
        dense_x, dense_rho, mask, nbr, params, kernel, block, mimage=mimage
    )
    n_dense = jnp.concatenate(
        [n_dense, jnp.zeros((1, dense_x.shape[1], 3), n_dense.dtype)]
    )
    return _st_force_blocks(
        dense_x, n_dense, dense_rho, mask, nbr, params, kernel, block,
        gamma, mimage=mimage,
    )


def _st_normals_blocks(
    dense_x, dense_rho, mask, nbr, params, kernel, block, mimage=None
):
    """Akinci surface normals ``n_i = hs sum_j (m/rho_j) grad_W_ij``
    -> ``[c, K, 3]``.  Distributed callers must OWNER-exchange boundary
    normals before the force pass (ghost cells' local normals have
    truncated neighborhoods), exactly like rho/p."""
    k = dense_x.shape[1]
    hs = kernel.support_scale * params.h

    def normals_block(args):
        xb, _vb, _rhob, _rb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        ym = mask[nb].reshape(block, 27 * k)

        dx = _min_image(xb[:, :, None, :] - y[:, None, :, :], mimage)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        dwr = kernel.dw_over_r(r, params.h, dim=params.dim)
        coef = (params.mass / rhoy[:, None, :]) * dwr * ym[:, None, :]
        n = hs * jnp.sum(coef[..., None] * dx, axis=2)
        return n * mb[:, :, None]

    return _pair_blocks(
        normals_block, (dense_x, dense_x, dense_rho, dense_rho), mask, nbr,
        block, (3,),
    )


def _st_force_blocks(
    dense_x, n_dense, dense_rho, mask, nbr, params, kernel, block, gamma,
    mimage=None,
):
    """Akinci surface-tension force pass (cohesion + curvature) given
    per-slot normals ``n_dense`` (``[c+1, K, 3]``, sentinel row last)
    -> ``[c, K, 3]``."""
    k = dense_x.shape[1]
    hs = kernel.support_scale * params.h

    def force_block(args):
        # own normals ride the dense_v slot of the pair machinery, so
        # they are padded/blocked in lockstep with the positions
        xb, nself, rhob, _rb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        ny = n_dense[nb].reshape(block, 27 * k, 3)
        ym = mask[nb].reshape(block, 27 * k)

        dx = _min_image(xb[:, :, None, :] - y[:, None, :, :], mimage)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        kij = (
            2.0 * params.rho0 / (rhob[:, :, None] + rhoy[:, None, :])
        ) * ym[:, None, :]
        # cohesion: C(r)/r is finite at r=0 only through the dx factor;
        # the self pair has dx = 0, so the safe divisor drops it exactly
        coh = (
            -gamma * params.mass * kij * _cohesion_c(r, hs)
            / jnp.maximum(r, 1e-12)
        )
        acc = jnp.sum(coh[..., None] * dx, axis=2)
        # curvature: -gamma K_ij (n_i - n_j); the self pair cancels
        dn = nself[:, :, None, :] - ny[:, None, :, :]
        acc = acc + jnp.sum((-gamma * kij)[..., None] * dn, axis=2)
        return acc * mb[:, :, None]

    return _pair_blocks(
        force_block, (dense_x, n_dense, dense_rho, dense_rho), mask, nbr,
        block, (3,),
    )


def _pair_terms(xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel, mimage=None):
    """Shared pair machinery of the momentum AND energy equations:
    returns ``(dx, dwr, press_plus_pi, vdotx)``.

    One implementation on purpose - the energy equation conserves
    total (kinetic + internal) energy only because its pressure +
    viscosity pair terms are EXACTLY the momentum equation's; sharing
    the code makes that conjugacy hold by construction
    (``test_energy_rate_conserves_pair_energy``).
    """
    h2eps = params.eps * params.h * params.h
    dx = _min_image(xb[:, :, None, :] - y[:, None, :, :], mimage)  # [B,K,27K,3]
    dv = vb[:, :, None, :] - vy[:, None, :, :]
    r2 = jnp.sum(dx * dx, axis=-1)
    r = jnp.sqrt(r2)
    dwr = kernel.dw_over_r(r, params.h, dim=params.dim)  # [B,K,27K]

    # pressure term
    press = pb[:, :, None] / (rhob[:, :, None] ** 2) + py[:, None, :] / (
        rhoy[:, None, :] ** 2
    )

    # Monaghan artificial viscosity
    vdotx = jnp.sum(dv * dx, axis=-1)
    mu = vdotx / (r2 + h2eps)
    rho_bar = 0.5 * (rhob[:, :, None] + rhoy[:, None, :])
    pi = jnp.where(
        vdotx < 0.0, -params.alpha * params.c0 * params.h * mu / rho_bar, 0.0
    )
    return dx, dwr, press + pi, vdotx


def _pair_blocks(one_block, arrays, mask, nbr, block, out_trailing):
    """Run a per-block pair computation over padded cell blocks.

    ``arrays`` = (dense_x, dense_v, dense_rho, dense_p); ``one_block``
    receives ``(xb, vb, rhob, pb, mb, nb)`` and returns a ``[B, K,
    *out_trailing]`` block.
    """
    dense_x = arrays[0]
    c, k = nbr.shape[0], dense_x.shape[1]
    padded = [_pad_cells(a[:c], block) for a in arrays]
    mask_p = _pad_cells(mask[:c], block)
    nbr_p = _pad_cells(nbr, block)
    nblocks = padded[0].shape[0] // block

    out = jax.lax.map(
        one_block,
        (
            padded[0].reshape(nblocks, block, k, 3),
            padded[1].reshape(nblocks, block, k, 3),
            padded[2].reshape(nblocks, block, k),
            padded[3].reshape(nblocks, block, k),
            mask_p.reshape(nblocks, block, k),
            nbr_p.reshape(nblocks, block, 27),
        ),
    )
    return out.reshape((-1, k) + out_trailing)[:c]


def _accel_blocks(
    dense_x, dense_v, dense_rho, dense_p, mask, nbr, params, kernel, block,
    mimage=None,
):
    """Per-slot acceleration (pressure + viscosity) -> ``[n_cells, K, 3]``."""
    k = dense_x.shape[1]

    def one_block(args):
        xb, vb, rhob, pb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        vy = dense_v[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        py = dense_p[nb].reshape(block, 27 * k)
        ym = mask[nb].reshape(block, 27 * k)

        dx, dwr, press_pi, _ = _pair_terms(
            xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel, mimage
        )
        scale = -params.mass * press_pi * dwr * ym[:, None, :]  # [B,K,27K]
        acc = jnp.sum(scale[..., None] * dx, axis=2)  # [B,K,3]
        return acc * mb[:, :, None]

    return _pair_blocks(
        one_block, (dense_x, dense_v, dense_rho, dense_p), mask, nbr, block, (3,)
    )


def _accel_drho_blocks(
    dense_x, dense_v, dense_rho, dense_p, mask, nbr, params, kernel, block,
    delta_sph, mimage=None,
):
    """Fused momentum + continuity pair pass -> ``[n_cells, K, 4]``.

    Columns = [acc_x, acc_y, acc_z, drho/dt].  The continuity equation

        drho_i/dt = sum_j m (v_i - v_j) . grad_i W_ij
                  = sum_j m dwr vdotx

    shares every pair term the momentum equation already computes, so
    in continuity-density mode the separate density summation pass
    disappears entirely - ONE neighbor sweep per step instead of two.

    ``delta_sph`` adds Molteni-Colagrossi diffusion (the delta-SPH
    scheme; delta ~ 0.1 is the standard production setting)::

        D_i = delta h c0 sum_j (2 m / rho_j) (rho_i - rho_j)
              dwr r^2 / (r^2 + eta^2),   eta = 0.1 h

    which smooths the acoustic density noise WCSPH accumulates under
    pure continuity integration (summation density self-corrects;
    evolved density needs this term to).  With ``dwr <= 0`` the sign
    is diffusive: a locally dense particle sheds density to lighter
    neighbors.  The self pair contributes exactly 0 through ``r^2``.
    """
    k = dense_x.shape[1]
    eta2 = (0.1 * params.h) ** 2
    dcoef = 2.0 * delta_sph * params.h * params.c0 * params.mass

    def one_block(args):
        xb, vb, rhob, pb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        vy = dense_v[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        py = dense_p[nb].reshape(block, 27 * k)
        ym = mask[nb].reshape(block, 27 * k)

        dx, dwr, press_pi, vdotx = _pair_terms(
            xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel, mimage
        )
        mdwr = params.mass * dwr * ym[:, None, :]  # [B,K,27K]
        acc = jnp.sum((-press_pi * mdwr)[..., None] * dx, axis=2)
        drho = params.mass * dwr * vdotx
        if delta_sph > 0.0:
            r2 = jnp.sum(dx * dx, axis=-1)
            drho = drho + (
                dcoef
                * (rhob[:, :, None] - rhoy[:, None, :])
                / rhoy[:, None, :]
                * dwr
                * r2
                / (r2 + eta2)
            )
        drho = jnp.sum(drho * ym[:, None, :], axis=2)
        out = jnp.concatenate([acc, drho[..., None]], axis=-1)
        return out * mb[:, :, None]

    return _pair_blocks(
        one_block, (dense_x, dense_v, dense_rho, dense_p), mask, nbr, block, (4,)
    )


def _energy_blocks(
    dense_x, dense_v, dense_rho, dense_p, mask, nbr, params, kernel, block,
    mimage=None,
):
    """Per-slot internal-energy rate du/dt -> ``[n_cells, K]``.

    WCSPH energy equation: du_i/dt = 1/2 sum_j m (p_i/rho_i^2 +
    p_j/rho_j^2 + Pi_ij) (v_i - v_j) . grad_W_ij - the pressure-work +
    viscous-heating conjugate of the momentum equation, built from the
    SAME :func:`_pair_terms` so the conjugacy holds by construction.
    """
    k = dense_x.shape[1]

    def one_block(args):
        xb, vb, rhob, pb, mb, nb = args
        y = dense_x[nb].reshape(block, 27 * k, 3)
        vy = dense_v[nb].reshape(block, 27 * k, 3)
        rhoy = dense_rho[nb].reshape(block, 27 * k)
        py = dense_p[nb].reshape(block, 27 * k)
        ym = mask[nb].reshape(block, 27 * k)

        _, dwr, press_pi, vdotx = _pair_terms(
            xb, vb, rhob, pb, y, vy, rhoy, py, params, kernel, mimage
        )
        # (v_i - v_j) . grad_W = vdotx * dwr
        du = 0.5 * params.mass * press_pi * dwr * vdotx * ym[:, None, :]
        return jnp.sum(du, axis=-1) * mb

    return _pair_blocks(
        one_block, (dense_x, dense_v, dense_rho, dense_p), mask, nbr, block, ()
    )


def _mimage_of(grid, periodic):
    """(3,) minimum-image extents for ``grid`` (None when not periodic);
    the single source of the wrap-axis rule and the huge-finite
    sentinel shared by every pair path."""
    import numpy as _np

    if not periodic:
        return None
    ext = grid.cell_size * _np.asarray(grid.dims, _np.float32)
    wrap = _np.asarray(grid.dims) >= 3
    return _np.where(wrap, ext, _np.float32(1e30)).astype(_np.float32)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def energy_rate(state, grid, params, kernel=WendlandC2, block=32, periodic=False):
    """Per-particle internal-energy rate du/dt of a configuration.

    Produces the physics behind the schema's ``particles/energy`` chunk
    (reference: pgsd/doc/pgsd.tex:525-565 lists energy among the SPH
    extension fields; the reference only stores it - here it is
    computed).  Integrate it alongside the step (``u += dt * du``), or
    dump the rate directly as a log quantity.

    Returns:
        ``[N]`` float32 du/dt.
    """
    cells = build_cells(state.x, grid)
    nbr = neighbor_table(grid, periodic=periodic)
    mimage = _mimage_of(grid, periodic)
    dense_x = scatter_to_cells(state.x, cells, grid)
    dense_v = scatter_to_cells(state.v, cells, grid)
    rho_dense = _density_blocks(
        dense_x, cells.mask, nbr, params, kernel, block, mimage=mimage
    )
    rho_dense = jnp.concatenate(
        [rho_dense, jnp.full((1, grid.capacity), params.rho0, rho_dense.dtype)]
    )
    rho_dense = jnp.where(
        cells.mask, jnp.maximum(rho_dense, 0.1 * params.rho0), params.rho0
    )
    p_dense = jnp.where(cells.mask, tait_pressure(rho_dense, params), 0.0)
    du_dense = _energy_blocks(
        dense_x, dense_v, rho_dense, p_dense, cells.mask, nbr, params, kernel,
        block, mimage=mimage,
    )
    du_dense = jnp.concatenate(
        [du_dense, jnp.zeros((1, grid.capacity), du_dense.dtype)]
    )
    return gather_from_cells(du_dense, cells, grid)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def density_and_pressure(
    x, grid, params, kernel=WendlandC2, block=32, periodic=False,
    density_renorm=False,
):
    """Standalone density + Tait pressure of a configuration.

    Returns per-particle ``(rho, p)`` - the SPH quantities the schema's
    ``particles/density`` / ``particles/pressure`` chunks carry.  With
    ``density_renorm`` the Shepard filter removes the free-surface
    density deficit (see :func:`_renormalize_density`).
    """
    cells = build_cells(x, grid)
    nbr = neighbor_table(grid, periodic=periodic)
    mimage = _mimage_of(grid, periodic)
    dense_x = scatter_to_cells(x, cells, grid)
    rho_dense = _density_blocks(
        dense_x, cells.mask, nbr, params, kernel, block, mimage=mimage
    )
    rho_dense = jnp.concatenate(
        [rho_dense, jnp.full((1, grid.capacity), params.rho0, rho_dense.dtype)]
    )
    if density_renorm:
        rho_dense = jnp.where(
            cells.mask, _renormalize_density(rho_dense, params), rho_dense
        )
    rho = gather_from_cells(rho_dense, cells, grid)
    rho = jnp.maximum(rho, 0.1 * params.rho0)  # isolated-particle floor
    return rho, tait_pressure(rho, params)


def init_density(
    state, grid, params, kernel=WendlandC2, block=32, periodic=False,
    rho=None,
):
    """Seed ``state.rho`` for continuity-density mode.

    By default the seed is the summation density of the configuration
    (the natural self-consistent start; a lattice at rest-spacing seeds
    ~rho0 automatically).  Pass ``rho`` explicitly to override - e.g.
    ``rho0`` everywhere for a pre-relaxed state, or the
    ``particles/density`` chunk when resuming from a trajectory.
    """
    if rho is None:
        rho, _ = density_and_pressure(
            state.x, grid, params, kernel=kernel, block=block,
            periodic=periodic,
        )
    else:
        rho = jnp.broadcast_to(
            jnp.asarray(rho, jnp.float32), (state.x.shape[0],)
        )
    return state._replace(rho=rho)


def _spmd_device_count(sharding):
    """Number of devices a ``sharding`` hint spans (1 = unsharded).

    Accepts ``None``, an int, a ``jax.sharding.Mesh`` / ``AbstractMesh``,
    or any ``jax.sharding.Sharding`` - whatever the caller will jit the
    step's inputs with.
    """
    if sharding is None:
        return 1
    if isinstance(sharding, int):
        return sharding
    size = getattr(sharding, "size", None)  # Mesh / AbstractMesh
    if size is not None:
        return int(size)
    mesh = getattr(sharding, "mesh", None)  # NamedSharding
    if mesh is not None:
        return int(mesh.size)
    dev = getattr(sharding, "device_set", None)  # generic Sharding
    if dev is not None:
        return len(dev)
    raise TypeError(
        "sharding hint must be None, an int device count, a Mesh, or a "
        "jax.sharding.Sharding; got %r" % (type(sharding),)
    )


def resolve_use_pallas(use_pallas="auto", gspmd=False):
    """The one kernel policy of every step builder.

    ``"auto"`` picks the Triton pair kernels on a GPU backend unless the
    step is GSPMD-partitioned (a ``pallas_call`` is a custom call GSPMD
    cannot partition); elsewhere it picks the jnp pair blocks.  An
    explicit ``True`` under GSPMD raises instead of failing at lowering.
    """
    if use_pallas == "auto":
        return not gspmd and jax.default_backend() == "gpu"
    if use_pallas and gspmd:
        raise ValueError(
            "use_pallas=True cannot run under GSPMD-partitioned inputs: "
            "GSPMD does not partition a pallas_call.  Use "
            "make_distributed_step_fn (or the 2-D/3-D variants), which "
            "run the kernels inside shard_map, or leave use_pallas='auto'."
        )
    return bool(use_pallas)


class PairSweeps(NamedTuple):
    """The three neighbour sweeps of a step, with one signature each:
    ``density(x, mask, nbr, params, kernel, mimage=)``,
    ``accel(x, v, rho, p, mask, nbr, params, kernel, mimage=)`` and
    ``accel_drho(x, v, rho, p, mask, nbr, params, kernel, delta_sph,
    mimage=)``."""

    density: object
    accel: object
    accel_drho: object


def pair_sweeps(use_pallas, block=32, interpret=False):
    """Pair sweeps of the resolved path: the Triton kernels of
    :mod:`tpgsd.sph.pair_kernel` or the jnp blocks of this module."""
    if use_pallas:
        from . import pair_kernel as pk

        def density(x, mask, nbr, params, kernel, mimage=None):
            return pk.density(
                x, mask, nbr, params, kernel, mimage=mimage,
                interpret=interpret,
            )

        def accel(x, v, rho, p, mask, nbr, params, kernel, mimage=None):
            return pk.accel(
                x, v, rho, p, mask, nbr, params, kernel, mimage=mimage,
                interpret=interpret,
            )

        def accel_drho(x, v, rho, p, mask, nbr, params, kernel, delta_sph,
                       mimage=None):
            return pk.accel_drho(
                x, v, rho, p, mask, nbr, params, kernel,
                delta_sph=delta_sph, mimage=mimage, interpret=interpret,
            )

        return PairSweeps(density, accel, accel_drho)

    def density(x, mask, nbr, params, kernel, mimage=None):
        return _density_blocks(x, mask, nbr, params, kernel, block, mimage)

    def accel(x, v, rho, p, mask, nbr, params, kernel, mimage=None):
        return _accel_blocks(
            x, v, rho, p, mask, nbr, params, kernel, block, mimage
        )

    def accel_drho(x, v, rho, p, mask, nbr, params, kernel, delta_sph,
                   mimage=None):
        return _accel_drho_blocks(
            x, v, rho, p, mask, nbr, params, kernel, block, delta_sph, mimage
        )

    return PairSweeps(density, accel, accel_drho)


def make_step_fn(
    grid,
    params,
    kernel=WendlandC2,
    block=32,
    use_pallas="auto",
    pallas_interpret=False,
    n_fixed=0,
    periodic=False,
    density_renorm=False,
    xsph=0.0,
    surface_tension=0.0,
    density_mode="summation",
    delta_sph=0.1,
    sharding=None,
    _traced_dt=False,
):
    """Build the jittable SPH step.

    Returns ``step(state) -> (state, aux)`` with ``aux = (rho, p,
    overflow)``.  Pure function of static-shaped arrays: jit it directly,
    ``lax.scan`` it for multi-step rollouts, or jit with sharded
    in/out-shardings for multi-chip (the particle axis is the data-parallel
    axis).

    Args:
        grid: static :class:`CellGrid`.
        params: :class:`SPHParams`.
        kernel: smoothing kernel class.
        block: cells per ``lax.map`` block (memory/parallelism knob).
        use_pallas: run the density, accel and fused accel+drho sweeps
            as the Triton Pallas kernels of
            :mod:`tpgsd.sph.pair_kernel` instead of the jnp pair blocks.
            ``"auto"`` (the default) picks them on a GPU backend when
            the step is not GSPMD-partitioned (see ``sharding``); see
            :func:`resolve_use_pallas`.
        pallas_interpret: run those kernels in the Pallas interpreter
            (CPU tests).  Off unless asked for: a compiled kernel on a
            backend without Triton raises.
        n_fixed: the first ``n_fixed`` particles are static boundary
            particles: they contribute to density and pressure forces
            (the standard dummy-particle wall treatment) but never move.
        periodic: wrap every axis with >= 3 cells (minimum-image pair
            separations + modular position wrap instead of reflective
            walls on those axes; narrower axes stay reflective - the
            collapsed-z 2-D layout composes naturally).  HOOMD-schema
            boxes are periodic by convention, so trajectories written
            from a periodic run match downstream tooling's reading of
            the box chunk.  Works with both compute paths: both apply
            the same minimum image (:func:`_mimage_of`).
        density_renorm: renormalize the summation density with the
            clipped rest-volume Shepard filter, whose closed form is the
            Hughes-Graham density floor ``max(rho, rho0)`` (derivation
            in :func:`_renormalize_density`) - removes the free-surface
            support-truncation deficit and its spurious negative
            pressures.  Free (no extra pair pass); works with every
            compute path.
        xsph: XSPH drift-velocity smoothing strength (Monaghan's
            epsilon, typically 0.5; 0 = off).  Damps particle-scale
            velocity disorder while conserving momentum exactly; costs
            one extra (jnp) pair pass regardless of the density/accel
            compute path.  Intended for violent flows (impacts,
            splashes, pairing-instability suppression); measured
            NEUTRAL on the quasi-static hydrostatic settle, where
            viscous damping already governs (v_rms 0.071 -> 0.084).
            See :func:`_xsph_blocks`.
        surface_tension: strength gamma of the Akinci surface-tension
            model (0 = off): pairwise spline cohesion PLUS the
            curvature (normal-difference) term, both momentum-exact;
            free drops contract toward spheres and nearby drops merge.
            Costs two extra (jnp) pair passes (normals, then forces)
            regardless of the density/accel compute path.  See
            :func:`_cohesion_blocks`.
        density_mode: ``"summation"`` (default) re-sums density from
            positions every step - self-correcting, parameter-free,
            but needs its own neighbor sweep and carries the kernel's
            support-truncation deficit at free surfaces.
            ``"continuity"`` evolves density as a state variable by the
            continuity equation ``drho_i/dt = sum_j m v_ij . grad W_ij``
            (the formulation production WCSPH codes like DualSPHysics
            ship): ``state.rho`` must be seeded (:func:`init_density`),
            the continuity pair terms fuse into the momentum pass so
            the step runs ONE neighbor sweep instead of two, and
            free surfaces keep exactly the density they advect (no
            summation deficit, so no ``density_renorm`` needed - the
            two options are mutually exclusive).
        delta_sph: delta-SPH density-diffusion strength (continuity
            mode only; 0.1 is the standard production setting, 0 =
            off).  Pure continuity integration accumulates acoustic
            density noise that summation would have self-corrected;
            the Molteni-Colagrossi diffusion term dissipates it at the
            particle scale while leaving the hydrostatic component
            intact (see :func:`_accel_drho_blocks`).
        sharding: REQUIRED hint when the step will be jitted with
            GSPMD-partitioned inputs (``jax.jit(step, in_shardings=
            NamedSharding(mesh, P("shard")))``): pass the mesh, the
            NamedSharding, or the device count.  A ``pallas_call`` is a
            custom call that GSPMD cannot partition, so with a
            multi-device hint ``"auto"`` resolves to the jnp pair path,
            which GSPMD partitions correctly, and an explicit
            ``use_pallas=True`` raises.  The kernels on a mesh run
            inside ``shard_map`` in the decomposed steps
            (:func:`tpgsd.sph.make_distributed_step_fn` and the 2-D/3-D
            variants).

    The returned function carries the post-resolution configuration in
    its ``resolved`` attribute (``{"use_pallas", "density_mode",
    "gspmd"}``) so callers and tests can pin what the
    zero-knob defaults chose.
    """
    # trace-time constants stay on the host (numpy): eager jnp.asarray
    # here would trigger device transfers at build time; as embedded
    # constants they ship with the compiled executable instead
    import numpy as _np

    continuity = density_mode == "continuity"
    if density_mode not in ("summation", "continuity"):
        raise ValueError("unknown density_mode: %r" % (density_mode,))
    if continuity and density_renorm:
        raise ValueError(
            "density_renorm corrects the summation-density free-surface "
            "deficit; continuity mode has no deficit to correct - use "
            "delta_sph for its noise control instead"
        )
    gspmd = _spmd_device_count(sharding) > 1
    use_pallas = resolve_use_pallas(use_pallas, gspmd=gspmd)
    sweeps = pair_sweeps(use_pallas, block, interpret=pallas_interpret)
    resolved = {
        "use_pallas": use_pallas,
        "density_mode": density_mode,
        "gspmd": gspmd,
    }

    nbr_static = neighbor_table(grid, periodic=periodic)
    lo = _np.asarray(grid.lo, _np.float32)
    hi = lo + grid.cell_size * _np.asarray(grid.dims, _np.float32)
    gravity = _np.asarray(params.gravity, _np.float32)
    wrap_axes = periodic & (_np.asarray(grid.dims) >= 3)
    mimage = _mimage_of(grid, periodic)

    def _finish(x, v, out, overflow, dt, rho_cur=None):
        """Shared integrate/boundary tail: ``out`` is the per-particle
        gathered bundle [acc3 | rho | p | (xsph dv3)] (summation mode)
        or [acc3 | drho | (xsph dv3)] (continuity mode, with the prior
        density passed as ``rho_cur``).  ``dt`` is the trace-time
        constant ``params.dt`` on the fixed-step path or a traced
        scalar on the adaptive path (same compiled code either way;
        the constant just folds)."""
        acc = out[..., :3] + gravity
        if continuity:
            # density update rides the state directly (never a
            # scatter/gather round trip): dropped-overflow particles
            # gather drho = 0 from the sentinel row and keep their
            # carried density
            rho = jnp.maximum(
                rho_cur + dt * out[..., 3], 0.1 * params.rho0
            )
            p = tait_pressure(rho, params)
            xsph_cols = out[..., 4:7]
        else:
            rho = out[..., 3]
            p = out[..., 4]
            xsph_cols = out[..., 5:8]

        # symplectic Euler: kick then drift (XSPH smooths the DRIFT
        # velocity only - the kick is untouched)
        v_new = (v + dt * acc) * params.velocity_damping
        v_drift = v_new + xsph * xsph_cols if xsph > 0 else v_new
        x_new = x + dt * v_drift

        # boundaries: reflective walls with damping, except modular
        # wrap on periodic axes (static per-axis selection)
        under = x_new < lo
        over = x_new > hi
        reflected = jnp.where(under, 2.0 * lo - x_new, x_new)
        reflected = jnp.where(over, 2.0 * hi - reflected, reflected)
        reflected = jnp.clip(reflected, lo, hi)
        if periodic:
            wrapped = lo + jnp.mod(x_new - lo, hi - lo)
            x_new = jnp.where(wrap_axes, wrapped, reflected)
            bounce = (under | over) & ~wrap_axes
        else:
            x_new = reflected
            bounce = under | over
        v_new = jnp.where(bounce, -params.wall_damping * v_new, v_new)

        if n_fixed > 0:
            # boundary particles: full SPH sources, zero motion (their
            # density still evolves in continuity mode - the standard
            # dummy-particle treatment, pressure tracks the fluid's)
            x_new = jnp.concatenate([x[:n_fixed], x_new[n_fixed:]])
            v_new = jnp.concatenate(
                [jnp.zeros((n_fixed, 3), v.dtype), v_new[n_fixed:]]
            )

        new_state = SPHState(
            x=x_new, v=v_new, rho=rho if continuity else None
        )
        if _traced_dt:
            # max squared acceleration of the MOBILE particles - the
            # input to the CFL force condition (fixed boundary slots
            # carry nonzero acc but never move, so they cannot limit
            # stability; their influence shows up in their neighbors'
            # acc already)
            a2 = jnp.sum(acc * acc, axis=-1)
            if n_fixed > 0:
                a2 = a2[n_fixed:]
            a2max = jnp.max(a2)
            return new_state, (rho, p, overflow), a2max
        return new_state, (rho, p, overflow)

    if continuity:

        def step_continuity(state, dt=params.dt):
            if state.rho is None:
                raise ValueError(
                    "density_mode='continuity' needs state.rho - seed "
                    "it with tpgsd.sph.init_density(state, grid, params)"
                )
            x, v, rho = state.x, state.v, state.rho
            cells = build_cells(x, grid)
            # one fused layout scatter for x, v AND rho (7 columns)
            xvr = scatter_to_cells(
                jnp.concatenate([x, v, rho[:, None]], axis=-1), cells, grid
            )
            dense_x, dense_v = xvr[..., :3], xvr[..., 3:6]
            rho_dense = jnp.where(
                cells.mask, jnp.maximum(xvr[..., 6], 0.1 * params.rho0),
                params.rho0,
            )
            p_dense = jnp.where(
                cells.mask, tait_pressure(rho_dense, params), 0.0
            )
            # the fused momentum+continuity sweep: ONE pair pass for acc
            # AND drho
            out4 = sweeps.accel_drho(
                dense_x, dense_v, rho_dense, p_dense, cells.mask,
                nbr_static, params, kernel, delta_sph, mimage=mimage,
            )
            if surface_tension > 0:
                coh = _cohesion_blocks(
                    dense_x, rho_dense, cells.mask, nbr_static, params,
                    kernel, block, surface_tension, mimage=mimage,
                )
                out4 = jnp.concatenate(
                    [out4[..., :3] + coh, out4[..., 3:]], axis=-1
                )
            cols = [
                jnp.concatenate(
                    [out4, jnp.zeros((1, grid.capacity, 4), out4.dtype)]
                )
            ]
            if xsph > 0:
                dvc_dense = _xsph_blocks(
                    dense_x, dense_v, rho_dense, cells.mask, nbr_static,
                    params, kernel, block, mimage=mimage,
                )
                cols.append(
                    jnp.concatenate(
                        [
                            dvc_dense,
                            jnp.zeros((1, grid.capacity, 3), dvc_dense.dtype),
                        ]
                    )
                )
            bundle = cols[0] if len(cols) == 1 else jnp.concatenate(cols, -1)
            out = gather_from_cells(bundle, cells, grid)
            return _finish(x, v, out, cells.overflow, dt, rho_cur=rho)

        step_continuity.resolved = resolved
        return step_continuity

    def step(state, dt=params.dt):
        x, v = state.x, state.v
        cells = build_cells(x, grid)
        # one fused layout gather for x AND v (6 columns in one pass
        # instead of two)
        xv = scatter_to_cells(jnp.concatenate([x, v], axis=-1), cells, grid)
        dense_x, dense_v = xv[..., :3], xv[..., 3:]

        rho_dense = sweeps.density(
            dense_x, cells.mask, nbr_static, params, kernel, mimage=mimage
        )
        # sentinel row: rest density (never 0 - avoids NaN in p/rho^2)
        rho_dense = jnp.concatenate(
            [rho_dense, jnp.full((1, grid.capacity), params.rho0, rho_dense.dtype)]
        )
        rho_dense = jnp.where(
            cells.mask, jnp.maximum(rho_dense, 0.1 * params.rho0), params.rho0
        )
        if density_renorm:
            rho_dense = _renormalize_density(rho_dense, params)
        p_dense = tait_pressure(rho_dense, params)
        p_dense = jnp.where(cells.mask, p_dense, 0.0)

        acc_dense = sweeps.accel(
            dense_x, dense_v, rho_dense, p_dense, cells.mask, nbr_static,
            params, kernel, mimage=mimage,
        )
        if surface_tension > 0:
            acc_dense = acc_dense + _cohesion_blocks(
                dense_x, rho_dense, cells.mask, nbr_static, params, kernel,
                block, surface_tension, mimage=mimage,
            )
        # one fused particle-order gather for acc, rho, p (and the XSPH
        # correction): stack the per-slot outputs as columns, gather
        # once, split
        cols = [
            jnp.concatenate(
                [acc_dense, jnp.zeros((1, grid.capacity, 3), acc_dense.dtype)]
            ),
            rho_dense[..., None],
            p_dense[..., None],
        ]
        if xsph > 0:
            dvc_dense = _xsph_blocks(
                dense_x, dense_v, rho_dense, cells.mask, nbr_static, params,
                kernel, block, mimage=mimage,
            )
            cols.append(
                jnp.concatenate(
                    [dvc_dense, jnp.zeros((1, grid.capacity, 3), dvc_dense.dtype)]
                )
            )
        bundle = jnp.concatenate(cols, axis=-1)
        out = gather_from_cells(bundle, cells, grid)
        return _finish(x, v, out, cells.overflow, dt)

    step.resolved = resolved
    return step


def make_adaptive_step_fn(
    grid,
    params,
    cfl=0.25,
    dt_min=0.0,
    dt_max=None,
    **kwargs,
):
    """Build a CFL-adaptive variant of the SPH step.

    WCSPH runs at a fixed artificial sound speed, so the stable time
    step varies with the flow: quiescent phases tolerate the acoustic
    Courant limit, violent phases (impacts, wave breaking) demand the
    force condition.  The standard controller (Monaghan 1992; the same
    scheme production SPH codes like DualSPHysics ship) picks, each
    step::

        dt_f  = sqrt(h / max_i |a_i|)          # force condition
        dt_cv = h / (c0 + max_i |v_i|)         # Courant + advection
        dt    = clip(cfl * min(dt_f, dt_cv), dt_min, dt_max)

    The step is built once and jitted once; ``dt`` flows through the
    trace as a scalar operand, so adapting it never recompiles (this is
    the jit-friendly shape of "variable dt": data-dependent VALUES are
    free under jit, data-dependent SHAPES are not).  The returned
    ``dt_next`` is computed from the post-step state, giving the usual
    one-step lag - cover it with the safety factor ``cfl``.

    The reference has no stepper (its frames come from an external host
    simulation, pgsd/scripts/benchmark-write.cc:86-130); this belongs
    to the SPH producer that this package adds on top.

    Args:
        grid / params: as :func:`make_step_fn`.  ``params.dt`` seeds
            the rollout and (by default) caps ``dt_next``.
        cfl: safety factor on the CFL minimum (0.25 is conservative;
            DualSPHysics defaults to 0.2).
        dt_min: floor on ``dt_next`` (0 = none).  A floor larger than
            the true stability limit trades accuracy for progress -
            leave at 0 unless a known-pathological transient (e.g. the
            initial lattice relaxation) needs bounding.
        dt_max: ceiling on ``dt_next`` (default ``params.dt``) - keeps
            quiescent phases from over-stretching the acoustic limit.
        **kwargs: forwarded to :func:`make_step_fn` (``use_pallas``,
            ``periodic``, ``n_fixed``, ``xsph``, ...).

    Returns:
        ``step(state, dt) -> (state, (rho, p, overflow), dt_next)``.
        Jit it directly or roll it out with :func:`run_adaptive`.
    """
    base = make_step_fn(grid, params, _traced_dt=True, **kwargs)
    h = float(params.h)
    c0 = float(params.c0)
    if dt_max is None:
        dt_max = float(params.dt)

    def step(state, dt):
        new_state, aux, a2max = base(state, dt)
        amax = jnp.sqrt(jnp.maximum(a2max, 1e-30))
        v2max = jnp.max(jnp.sum(new_state.v * new_state.v, axis=-1))
        vmax = jnp.sqrt(jnp.maximum(v2max, 1e-30))
        dt_f = jnp.sqrt(h / amax)
        dt_cv = h / (c0 + vmax)
        dt_next = jnp.clip(
            cfl * jnp.minimum(dt_f, dt_cv), dt_min, dt_max
        ).astype(jnp.float32)
        return new_state, aux, dt_next

    step.resolved = base.resolved
    return step


def run_adaptive(step_fn, state, dt0, n_steps):
    """Roll an adaptive step out for ``n_steps`` under ``lax.scan``.

    The carry is ``(state, dt, t)``; step ``i`` advances by the carry's
    ``dt`` and the controller's ``dt_next`` becomes step ``i+1``'s.
    Fixed trip count + traced dt = one compile, any trajectory.

    Args:
        step_fn: from :func:`make_adaptive_step_fn`.
        state: initial :class:`SPHState`.
        dt0: first step's dt (e.g. ``params.dt``).
        n_steps: static trip count.

    Returns:
        ``(state, dt_next, t)`` - final state, the controller's next
        dt, and total simulated time (the sum of the dts actually
        taken, a traced scalar).
    """

    def body(carry, _):
        s, dt, t = carry
        s, _aux, dt_next = step_fn(s, dt)
        return (s, dt_next, t + dt), None

    (state, dt, t), _ = jax.lax.scan(
        body,
        (state, jnp.float32(dt0), jnp.float32(0.0)),
        None,
        length=int(n_steps),
    )
    return state, dt, t
