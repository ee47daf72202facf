"""2-D block-decomposed distributed SPH over a ``(px, py)`` device mesh.

The 1-D slab decomposition (:mod:`tpgsd.sph.distributed`) cuts the
domain along one axis; its halo surface per device is a full cross
section of the box, so past ~8 devices the cross section stops
shrinking and halo traffic per device plateaus.  This module cuts the
domain along BOTH horizontal axes: device ``(i, j)`` of a 2-D mesh owns
the ``nxl x nyl x nz`` cell block at block-coordinates ``(i, j)``, and
halo traffic scales with the block *perimeter*.

Two collective patterns, both dimension-ordered (y first, then x) so
corner cells ride along without any explicit diagonal communication
(the standard stencil-exchange trick: the x-faces exchanged second
already contain the y-ghosts received first):

* **halo exchange** - one cell-plane of boundary data per face
  (positions/velocities/mask stacked in ONE payload per direction, and
  a second owner-computed rho/p exchange before the force pass), and
* **two-phase migration** - particles that left their block hop along
  x first, then along y; a diagonal mover takes both hops in the same
  step.  Send-side overflow keeps the particle local one more step
  (one-step delay, never loss); receive-side overflow is counted in
  ``aux.migrate_overflow``.

Capacity model, fixed-particle support, periodic seams (ring
permutations with coordinate-shifted ghost planes), energy and XSPH
passes all match the 1-D slab step; parity is tested against it and
against the single-device step.  The MPI reference has no counterpart
(its parallel axis is the I/O row partition only:
pgsd/scripts/benchmark-write.cc:30-45); this is a scale-out path for
the SPH producer.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .cells import CellGrid, neighbor_table
from .distributed import (
    DistAux,
    DistState,
    _gather,
    _insert,
    _local_cells,
    _pack_migrants,
    _scatter,
)
from .kernels import WendlandC2
from .step import (
    _st_force_blocks,
    _st_normals_blocks,
    _energy_blocks,
    _mimage_of,
    _renormalize_density,
    _xsph_blocks,
    tait_pressure,
    pair_sweeps,
    resolve_use_pallas,
)


def _block_perms(n_ax, ring):
    """Forward/backward ppermute pairs along one mesh axis."""
    if ring:
        fwd = [(a, (a + 1) % n_ax) for a in range(n_ax)]
        bwd = [((a + 1) % n_ax, a) for a in range(n_ax)]
    else:
        fwd = [(a, a + 1) for a in range(n_ax - 1)]
        bwd = [(a + 1, a) for a in range(n_ax - 1)]
    return fwd, bwd


def _halo2d(a, nxl, nyl, nz, ax_x, ax_y, perms):
    """Dimension-ordered 2-D halo exchange of one dense payload.

    ``a``: ``[c_local + 1, K, F]`` (sentinel row last).  Exchanges the
    y-faces first, then the x-faces of the y-extended block - so the
    x-faces carry the fresh y-ghost corners and every device ends up
    with all 8 in-plane neighbors' boundary cells.  Returns the
    ``[(nxl+2)*(nyl+2)*nz + 1, K, F]`` extended payload.  With
    edge-terminated permutations, edge devices receive zeros - exactly
    the empty-ghost boundary condition, since the mask rides in the
    payload; ring permutations make the seam ghosts real (periodic).
    """
    (sx_f, sx_b), (sy_f, sy_b) = perms
    c_local = nxl * nyl * nz
    tail = a.shape[1:]
    core = a[:c_local].reshape((nxl, nyl, nz) + tail)

    # y exchange: top face travels +y, bottom face travels -y
    ghost_dn = jax.lax.ppermute(core[:, nyl - 1 : nyl], ax_y, sy_f)
    ghost_up = jax.lax.ppermute(core[:, 0:1], ax_y, sy_b)
    ycat = jnp.concatenate([ghost_dn, core, ghost_up], axis=1)

    # x exchange of the y-extended faces (corners ride along)
    ghost_l = jax.lax.ppermute(ycat[nxl - 1 : nxl], ax_x, sx_f)
    ghost_r = jax.lax.ppermute(ycat[0:1], ax_x, sx_b)
    xcat = jnp.concatenate([ghost_l, ycat, ghost_r], axis=0)

    return jnp.concatenate(
        [xcat.reshape((-1,) + tail), a[c_local:]], axis=0
    )


def _core2d(dense, nxl, nyl, nz):
    """Slice the interior block back out of an extended dense array."""
    c_ext = (nxl + 2) * (nyl + 2) * nz
    tail = dense.shape[1:]
    e4 = dense[:c_ext].reshape((nxl + 2, nyl + 2, nz) + tail)
    return e4[1 : nxl + 1, 1 : nyl + 1].reshape((-1,) + tail)


def _migrate_axis(payload, col, slab_lo, slab_hi, d, n_ax, ax_name,
                  send_fwd, send_bwd, wrap_ax, lo_ax, L_ax, mig_cap):
    """One migration phase along one mesh axis (shared by the 2-D and
    3-D block steps; the 1-D slab step has its own inline variant).

    ``payload``: ``[cap, 7]`` = (x, v, pid) rows; coordinate column
    ``col`` is RAW (unwrapped) so seam crossings are detectable.  The
    sent copy carries the wrapped coordinate (correct on the receiving
    block); retained overflow rows keep the raw one and re-detect next
    step - the documented one-step delay.
    """
    pid = payload[:, 6].astype(jnp.int32)
    alive = pid >= 0
    coord = payload[:, col]
    if wrap_ax:
        go_bwd = alive & (coord < slab_lo)
        go_fwd = alive & (coord >= slab_hi)
        wrapped = lo_ax + jnp.mod(coord - lo_ax, L_ax)
        pay_send = payload.at[:, col].set(wrapped)
    else:
        go_bwd = alive & (coord < slab_lo) & (d > 0)
        go_fwd = alive & (coord >= slab_hi) & (d < n_ax - 1)
        pay_send = payload

    buf_f, n_f, ovf_f, sent_f = _pack_migrants(pay_send, go_fwd, mig_cap)
    buf_b, n_b, ovf_b, sent_b = _pack_migrants(pay_send, go_bwd, mig_cap)
    valid_f = jnp.arange(mig_cap) < n_f
    valid_b = jnp.arange(mig_cap) < n_b

    recv_from_bwd = jax.lax.ppermute(buf_f, ax_name, send_fwd)
    recv_from_bwd_valid = jax.lax.ppermute(valid_f, ax_name, send_fwd)
    recv_from_fwd = jax.lax.ppermute(buf_b, ax_name, send_bwd)
    recv_from_fwd_valid = jax.lax.ppermute(valid_b, ax_name, send_bwd)

    pid_after = jnp.where(sent_f | sent_b, -1, pid)
    alive_after = pid_after >= 0
    recv_vals = jnp.concatenate([recv_from_bwd, recv_from_fwd], axis=0)
    recv_valid = jnp.concatenate(
        [recv_from_bwd_valid, recv_from_fwd_valid], axis=0
    )
    pay_keep = jnp.where(
        alive_after[:, None], payload, jnp.zeros_like(payload)
    )
    pay_keep = pay_keep.at[:, 6].set(
        jnp.where(alive_after, pid_after.astype(jnp.float32), -1.0)
    )
    merged, lost = _insert(pay_keep, alive_after, recv_vals, recv_valid)
    return merged, (ovf_f + ovf_b + lost).astype(jnp.int32)


def make_distributed2d_step_fn(
    grid,
    params,
    mesh,
    capacity=None,
    migrate_cap=None,
    kernel=WendlandC2,
    block=32,
    use_pallas="auto",
    pallas_interpret=False,
    n_fixed=0,
    periodic=False,
    compute_energy=False,
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the 2-D block-decomposed distributed step.

    Args:
        grid: global :class:`CellGrid`; ``grid.dims[0]`` must be a
            multiple of the mesh's x extent and ``grid.dims[1]`` of its
            y extent.
        params: :class:`SPHParams`.
        mesh: 2-D ``jax.sharding.Mesh`` (shape ``(px, py)``); its two
            axis names are used for the ppermute hops.
        capacity: particle slots per device (use
            :func:`distribute_state_2d`'s choice).
        migrate_cap: max migrations per face per phase per step
            (default ``capacity // 4``).
        n_fixed: particles with ``pid < n_fixed`` are static boundary
            particles, exactly as in the 1-D slab step.
        periodic: periodic global box.  x and y wrap through RING halo
            permutations along their mesh axes (each needs >= 3 cells
            globally); z wraps locally in the cell table.  Ghost planes
            crossing a seam arrive coordinate-shifted by the box extent
            so the kernels see true geometry.
        compute_energy / xsph / density_renorm: as in the 1-D slab
            step (the density floor lands before the owner rho/p
            exchange, so ghosts carry it too).
        use_pallas / pallas_interpret: the pair-sweep path, as in
            :func:`tpgsd.sph.make_step_fn`; the Triton kernels run
            inside the ``shard_map`` on each device's extended block.
        density_mode / delta_sph: as in the 1-D slab step.
            ``"continuity"`` carries density as migrating state
            (``DistState.rho``): ghost densities are exact by
            construction, so the step runs ONE fused halo round
            (x|v|rho|p|mask) instead of two and ONE fused accel+drho
            pair pass instead of two sweeps; the density rides the
            x- and y-hop migration payloads.

    Returns:
        ``step(state: DistState) -> (DistState, DistAux)``, jitted with
        axis-0 shardings over both mesh axes.  (With the private
        ``_traced_dt=True``, instead returns the UNJITTED
        ``step(state, dt) -> (DistState, DistAux, a2max[px*py])`` plus
        the sharding, for :func:`make_adaptive_distributed2d_step_fn`
        to compose the CFL controller around before jitting - the same
        contract as the 1-D slab builder.)
    """
    if len(mesh.axis_names) != 2:
        raise ValueError(
            "make_distributed2d_step_fn needs a 2-D mesh, got axes %r"
            % (mesh.axis_names,)
        )
    ax_x, ax_y = mesh.axis_names
    px, py = mesh.devices.shape
    nx, ny, nz = grid.dims
    if nx % px != 0 or ny % py != 0:
        raise ValueError(
            "grid dims (%d, %d) must be multiples of the mesh shape"
            " (%d, %d)" % (nx, ny, px, py)
        )
    nxl, nyl = nx // px, ny // py
    c_local = nxl * nyl * nz
    c_ext = (nxl + 2) * (nyl + 2) * nz
    if capacity is None:
        raise ValueError("pass capacity (slots per device)")
    cap = int(capacity)
    mig_cap = int(migrate_cap) if migrate_cap is not None else max(8, cap // 4)
    k = grid.capacity

    # static geometry
    cell = grid.cell_size
    lo_g = jnp.asarray(grid.lo, jnp.float32)
    hi_g = lo_g + cell * jnp.asarray(grid.dims, jnp.float32)
    gravity = jnp.asarray(params.gravity, jnp.float32)

    wrap = periodic & (np.asarray(grid.dims) >= 3)
    if periodic and (nx < 3 or ny < 3):
        raise ValueError("periodic needs >= 3 cells along x and y")
    wrap_x, wrap_y, wrap_z = bool(wrap[0]), bool(wrap[1]), bool(wrap[2])
    Lx, Ly = cell * nx, cell * ny

    # extended (ghost-padded) local grid; x/y periodicity flows through
    # the ring halos, only the LOCAL z wrap reaches the cell table
    ext_grid = CellGrid(
        lo=(0.0, 0.0, 0.0), cell_size=cell, dims=(nxl + 2, nyl + 2, nz),
        capacity=k,
    )
    nbr_ext = neighbor_table(
        ext_grid, periodic=(False, False, periodic) if periodic else False
    )
    mimage = _mimage_of(grid, periodic)

    continuity = density_mode == "continuity"
    if density_mode not in ("summation", "continuity"):
        raise ValueError("unknown density_mode: %r" % (density_mode,))
    if continuity and density_renorm:
        raise ValueError(
            "density_renorm corrects the summation-density free-surface "
            "deficit; continuity mode has no deficit to correct - use "
            "delta_sph for its noise control instead"
        )

    use_pallas = resolve_use_pallas(use_pallas)
    sweeps = pair_sweeps(use_pallas, block, interpret=pallas_interpret)

    perms = (_block_perms(px, wrap_x), _block_perms(py, wrap_y))
    (sx_f, sx_b), (sy_f, sy_b) = perms

    def migrate(payload, col, slab_lo, slab_hi, d, n_ax, ax_name,
                send_fwd, send_bwd, wrap_ax, lo_ax, L_ax):
        return _migrate_axis(
            payload, col, slab_lo, slab_hi, d, n_ax, ax_name,
            send_fwd, send_bwd, wrap_ax, lo_ax, L_ax, mig_cap,
        )

    def local_step(x, v, pid, rho_in, dt):
        # x/v/pid are this device's [cap] slot arrays (rho_in carried
        # density in continuity mode, None otherwise); dt is the
        # trace-time constant params.dt on the fixed path or a traced
        # replicated scalar on the adaptive path
        i = jax.lax.axis_index(ax_x)
        j = jax.lax.axis_index(ax_y)
        alive = pid >= 0
        lo_local = lo_g + jnp.stack(
            [i * nxl * cell, j * nyl * cell, jnp.zeros((), jnp.float32)]
        )

        cid_s, slot, order, gidx, mask, cell_ovf = _local_cells(
            x, alive, nxl, nyl, nz, k, lo_local, cell
        )
        if continuity:
            # density is CARRIED STATE: ghosts are exact, so x|v|rho|p
            # |mask ride ONE halo round - no owner rho/p re-exchange
            xvr = _scatter(
                jnp.concatenate([x, v, rho_in[:, None]], axis=-1),
                order, gidx,
            )
            rho_dense = jnp.where(
                mask, jnp.maximum(xvr[..., 6], 0.1 * params.rho0),
                params.rho0,
            )
            # pressure does NOT ride the halo: the receiver recomputes
            # it from the exchanged rho (pure per-element Tait math) -
            # ~11% less halo traffic, bit-identical values
            xvm = jnp.concatenate(
                [
                    xvr[..., :6],
                    rho_dense[..., None],
                    mask.astype(jnp.float32)[..., None],
                ],
                axis=-1,
            )
        else:
            # ONE stacked halo payload: x + v + mask = 7 lanes
            xvm = _scatter(
                jnp.concatenate(
                    [x, v, alive.astype(jnp.float32)[:, None]], axis=-1
                ),
                order,
                gidx,
            )
        nlanes = xvm.shape[-1]
        ext = _halo2d(xvm, nxl, nyl, nz, ax_x, ax_y, perms)

        # periodic seams: shift ghost-plane coordinates by the box
        # extent so ghost positions are geometrically true (the kernels
        # see no min-image on x/y).  The y shift covers the x-ghost
        # corner columns too - the x-neighbor that sent them shares our
        # j, so our shift condition is exactly the one it would apply.
        if wrap_x or wrap_y:
            e4 = ext[:c_ext].reshape(nxl + 2, nyl + 2, nz, k, nlanes)
            if wrap_y:
                sy_lo = jnp.where(j == 0, -Ly, 0.0).astype(jnp.float32)
                sy_hi = jnp.where(j == py - 1, Ly, 0.0).astype(jnp.float32)
                e4 = e4.at[:, 0, ..., 1].add(sy_lo)
                e4 = e4.at[:, nyl + 1, ..., 1].add(sy_hi)
            if wrap_x:
                sx_lo = jnp.where(i == 0, -Lx, 0.0).astype(jnp.float32)
                sx_hi = jnp.where(i == px - 1, Lx, 0.0).astype(jnp.float32)
                e4 = e4.at[0, ..., 0].add(sx_lo)
                e4 = e4.at[nxl + 1, ..., 0].add(sx_hi)
            ext = jnp.concatenate(
                [e4.reshape(c_ext, k, nlanes), ext[c_ext:]], axis=0
            )

        ext_x, ext_v = ext[..., :3], ext[..., 3:6]
        ext_mask = ext[..., nlanes - 1] > 0.5

        if continuity:
            # ghost rho/p arrived in the fused payload (edge devices'
            # ghost planes are zeros - refill dead/absent slots with
            # rho0 / 0 so p/rho^2 terms stay finite, masked anyway)
            rho_d2 = jnp.where(
                ext_mask, jnp.maximum(ext[..., 6], 0.1 * params.rho0),
                params.rho0,
            )
            p_d2 = jnp.where(ext_mask, tait_pressure(rho_d2, params), 0.0)
        else:
            # density over the extended block; only CORE outputs are
            # correct
            rho_d = sweeps.density(
                ext_x, ext_mask, nbr_ext, params, kernel, mimage=mimage
            )

            mask_core = _core2d(ext_mask, nxl, nyl, nz)
            rho_core = jnp.where(
                mask_core,
                jnp.maximum(_core2d(rho_d, nxl, nyl, nz), 0.1 * params.rho0),
                params.rho0,
            )
            if density_renorm:
                rho_core = _renormalize_density(rho_core, params)
            p_core = jnp.where(
                mask_core, tait_pressure(rho_core, params), 0.0
            )

            # second halo exchange: OWNER-computed rho/p replace the
            # locally-miscomputed ghost values before the force pass;
            # rho and p ride one stacked payload (latency-bound hops)
            rp = jnp.concatenate(
                [
                    jnp.stack([rho_core, p_core], axis=-1),
                    jnp.stack(
                        [
                            jnp.full((1, k), params.rho0, rho_core.dtype),
                            jnp.zeros((1, k), p_core.dtype),
                        ],
                        axis=-1,
                    ),
                ],
                axis=0,
            )
            ext_rp = _halo2d(rp, nxl, nyl, nz, ax_x, ax_y, perms)
            # edge devices' ghosts receive zeros; refill dead/absent
            # slots with rho0 / 0 so p/rho^2 terms stay finite (masked
            # anyway)
            rho_d2 = jnp.where(ext_mask, ext_rp[..., 0], params.rho0)
            p_d2 = jnp.where(ext_mask, ext_rp[..., 1], 0.0)

        if continuity:
            # the fused accel+drho sweep on the extended block grid
            out4_d = sweeps.accel_drho(
                ext_x, ext_v, rho_d2, p_d2, ext_mask, nbr_ext, params,
                kernel, delta_sph, mimage=mimage,
            )
            acc_d = out4_d[..., :3]
        else:
            acc_d = sweeps.accel(
                ext_x, ext_v, rho_d2, p_d2, ext_mask, nbr_ext, params,
                kernel, mimage=mimage,
            )
        if surface_tension > 0:
            # Akinci surface tension needs neighbor NORMALS; like rho/p,
            # ghost normals computed locally have truncated neighborhoods,
            # so exchange the owner-computed values first (normals are
            # vectors - periodic seams need no coordinate shift)
            n_loc = _st_normals_blocks(
                ext_x, rho_d2, ext_mask, nbr_ext, params, kernel, block,
                mimage=mimage,
            )
            n_pay = jnp.concatenate(
                [
                    _core2d(n_loc, nxl, nyl, nz),
                    jnp.zeros((1, k, 3), n_loc.dtype),
                ],
                axis=0,
            )
            n_d = jnp.where(
                ext_mask[..., None],
                _halo2d(n_pay, nxl, nyl, nz, ax_x, ax_y, perms),
                0.0,
            )
            acc_d = acc_d + _st_force_blocks(
                ext_x, n_d, rho_d2, ext_mask, nbr_ext, params, kernel,
                block, surface_tension, mimage=mimage,
            )

        # bundle core outputs as columns of ONE particle-order gather
        cols = [_core2d(acc_d, nxl, nyl, nz)]
        sent = [jnp.zeros((1, k, 3), acc_d.dtype)]
        if continuity:
            # drho sentinel is 0: cell-overflow-dropped particles keep
            # their carried density
            cols.append(_core2d(out4_d[..., 3:4], nxl, nyl, nz))
            sent.append(jnp.zeros((1, k, 1), acc_d.dtype))
        else:
            cols += [rho_core[..., None], p_core[..., None]]
            sent += [
                jnp.full((1, k, 1), params.rho0, rho_core.dtype),
                jnp.zeros((1, k, 1), p_core.dtype),
            ]
        if compute_energy:
            du_d = _energy_blocks(
                ext_x, ext_v, rho_d2, p_d2, ext_mask, nbr_ext, params,
                kernel, block, mimage=mimage,
            )
            cols.append(_core2d(du_d, nxl, nyl, nz)[..., None])
            sent.append(jnp.zeros((1, k, 1), du_d.dtype))
        if xsph > 0:
            dvc_d = _xsph_blocks(
                ext_x, ext_v, rho_d2, ext_mask, nbr_ext, params, kernel,
                block, mimage=mimage,
            )
            cols.append(_core2d(dvc_d, nxl, nyl, nz))
            sent.append(jnp.zeros((1, k, 3), dvc_d.dtype))
        bundle = jnp.concatenate(
            [jnp.concatenate(cols, axis=-1), jnp.concatenate(sent, axis=-1)],
            axis=0,
        )
        out = _gather(bundle, cid_s, slot, order, c_local, k)
        acc = out[..., :3] + gravity
        if continuity:
            # integrate the gathered drho directly on the carried state
            rho = jnp.where(
                alive,
                jnp.maximum(rho_in + dt * out[..., 3], 0.1 * params.rho0),
                params.rho0,
            )
            p = jnp.where(alive, tait_pressure(rho, params), 0.0)
            ecol = 4
        else:
            rho = out[..., 3]
            p = out[..., 4]
            ecol = 5
        dudt = out[..., ecol] if compute_energy else jnp.zeros_like(rho)
        if compute_energy:
            ecol += 1
        dvc = out[..., ecol : ecol + 3] if xsph > 0 else None

        # integrate (dead slots don't move); XSPH smooths DRIFT velocity
        v_new = jnp.where(alive[:, None], v + dt * acc, v)
        v_drift = v_new + xsph * dvc if dvc is not None else v_new
        x_new = jnp.where(alive[:, None], x + dt * v_drift, x)

        # global walls: reflective except wrapped axes (x/y wraps are
        # deferred to the migration payloads - detection needs raw
        # coordinates; the z wrap commits to state)
        under = x_new < lo_g
        over = x_new > hi_g
        reflected = jnp.where(under, 2.0 * lo_g - x_new, x_new)
        reflected = jnp.where(over, 2.0 * hi_g - reflected, reflected)
        reflected = jnp.clip(reflected, lo_g, hi_g)
        if periodic:
            x_new = jnp.where(wrap, x_new, reflected)
            bounce = (under | over) & ~wrap
        else:
            x_new = reflected
            bounce = under | over
        v_new = jnp.where(
            bounce & alive[:, None], -params.wall_damping * v_new, v_new
        )
        if wrap_z:
            zw = lo_g[2] + jnp.mod(x_new[:, 2] - lo_g[2], hi_g[2] - lo_g[2])
            x_new = jnp.concatenate([x_new[:, :2], zw[:, None]], axis=1)

        if n_fixed > 0:
            fixed = alive & (pid < n_fixed)
            x_new = jnp.where(fixed[:, None], x, x_new)
            v_new = jnp.where(fixed[:, None], 0.0, v_new)

        # ---- two-phase migration: x hop, then y hop ----
        # (carried rho rides as column 7 in continuity mode; the
        # migration machinery keys on pid at column 6 regardless)
        rho_col = [rho[:, None]] if continuity else []
        payload = jnp.concatenate(
            [x_new, v_new, pid.astype(jnp.float32)[:, None]] + rho_col,
            axis=1,
        )  # [cap, 7 (8 continuity)], raw x/y coordinates
        slab_lo_x = lo_g[0] + i * nxl * cell
        merged1, ovf_x = migrate(
            payload, 0, slab_lo_x, slab_lo_x + nxl * cell, i, px, ax_x,
            sx_f, sx_b, wrap_x, lo_g[0], Lx,
        )
        slab_lo_y = lo_g[1] + j * nyl * cell
        merged2, ovf_y = migrate(
            merged1, 1, slab_lo_y, slab_lo_y + nyl * cell, j, py, ax_y,
            sy_f, sy_b, wrap_y, lo_g[1], Ly,
        )

        x_out = merged2[:, 0:3]
        v_out = merged2[:, 3:6]
        pid_out = merged2[:, 6].astype(jnp.int32)
        if continuity:
            # post-migration slot-consistent density/pressure
            rho = jnp.where(pid_out >= 0, merged2[:, 7], params.rho0)
            p = jnp.where(pid_out >= 0, tait_pressure(rho, params), 0.0)
        mig_ovf = ovf_x + ovf_y
        outs = (
            x_out, v_out, pid_out, rho, p, cell_ovf[None], mig_ovf[None],
            dudt,
        )
        if _traced_dt:
            # max squared acceleration of this block's MOBILE particles
            # (the CFL force-condition input); per-block [1] outputs,
            # the controller maxes globally outside the shard_map
            mobile = alive & (pid >= n_fixed) if n_fixed > 0 else alive
            a2 = jnp.where(mobile, jnp.sum(acc * acc, axis=-1), 0.0)
            outs = outs + (jnp.max(a2)[None],)
        return outs

    spec = P((ax_x, ax_y))
    sh = NamedSharding(mesh, spec)

    n_out = 9 if _traced_dt else 8
    if continuity:
        fn = local_step if _traced_dt else (
            lambda x, v, pid, rho: local_step(x, v, pid, rho, params.dt)
        )
    elif _traced_dt:
        def fn(x, v, pid, dt):
            return local_step(x, v, pid, None, dt)
    else:
        def fn(x, v, pid):
            return local_step(x, v, pid, None, params.dt)
    sm_kwargs = dict(
        mesh=mesh,
        in_specs=(spec, spec, spec)
        + ((spec,) if continuity else ())
        + ((P(),) if _traced_dt else ()),
        out_specs=(spec,) * n_out,
    )
    # pallas_call outputs carry no varying-mesh-axes annotation, so the
    # kernel-backed variant runs without the replication checker
    mapped = shard_map(fn, check_vma=not use_pallas, **sm_kwargs)

    st_sh = DistState(x=sh, v=sh, pid=sh, rho=sh if continuity else None)

    def _state_args(state):
        if continuity:
            if state.rho is None:
                raise ValueError(
                    "density_mode='continuity' needs DistState.rho - "
                    "seed the global state with tpgsd.sph.init_density "
                    "before distribute_state_2d"
                )
            return (state.x, state.v, state.pid, state.rho)
        return (state.x, state.v, state.pid)

    def _pack(x, v, pid, rho, p, covf, movf, dudt):
        return (
            DistState(x=x, v=v, pid=pid, rho=rho if continuity else None),
            DistAux(
                rho=rho, p=p, cell_overflow=covf, migrate_overflow=movf,
                dudt=dudt,
            ),
        )

    if _traced_dt:

        def step_dt(state, dt):
            *outs, a2 = mapped(*_state_args(state), jnp.float32(dt))
            return _pack(*outs) + (a2,)

        return step_dt, sh

    @partial(
        jax.jit,
        in_shardings=(st_sh,),
        out_shardings=(
            st_sh,
            DistAux(
                rho=sh, p=sh, cell_overflow=sh, migrate_overflow=sh, dudt=sh
            ),
        ),
    )
    def step(state):
        return _pack(*mapped(*_state_args(state)))

    return step


def make_adaptive_distributed2d_step_fn(
    grid,
    params,
    mesh,
    cfl=0.25,
    dt_min=0.0,
    dt_max=None,
    **kwargs,
):
    """CFL-adaptive variant of the 2-D block-decomposed step.

    Same Monaghan controller as
    :func:`tpgsd.sph.make_adaptive_distributed_step_fn`, computed
    globally over the ``(px, py)`` mesh: each block reports its mobile
    particles' max ``|acc|^2`` out of the shard_map, the controller
    maxes over blocks and over the sharded velocity slots, and every
    device advances with one replicated traced dt - adapting never
    recompiles or re-shards.

    Args:
        grid / params / mesh: as :func:`make_distributed2d_step_fn`.
        cfl / dt_min / dt_max: as the single-device adaptive builder
            (``dt_max`` defaults to ``params.dt``).
        **kwargs: forwarded to :func:`make_distributed2d_step_fn`
            (``capacity``, ``use_pallas``, ``periodic``, ``n_fixed``,
            ``xsph``, ...).

    Returns:
        jitted ``step(state: DistState, dt) ->
        (DistState, DistAux, dt_next)``.  Roll out with
        :func:`tpgsd.sph.run_adaptive` (DistState is a pytree).
    """
    base, sh = make_distributed2d_step_fn(
        grid, params, mesh, _traced_dt=True, **kwargs
    )
    h = float(params.h)
    c0 = float(params.c0)
    if dt_max is None:
        dt_max = float(params.dt)
    continuity = kwargs.get("density_mode") == "continuity"
    st_sh = DistState(x=sh, v=sh, pid=sh, rho=sh if continuity else None)

    @partial(
        jax.jit,
        in_shardings=(st_sh, None),
        out_shardings=(
            st_sh,
            DistAux(
                rho=sh, p=sh, cell_overflow=sh, migrate_overflow=sh, dudt=sh
            ),
            None,
        ),
    )
    def step(state, dt):
        new_state, aux, a2 = base(state, dt)
        a2max = jnp.max(a2)
        amax = jnp.sqrt(jnp.maximum(a2max, 1e-30))
        v2max = jnp.max(jnp.sum(new_state.v * new_state.v, axis=-1))
        vmax = jnp.sqrt(jnp.maximum(v2max, 1e-30))
        dt_f = jnp.sqrt(h / amax)
        dt_cv = h / (c0 + vmax)
        dt_next = jnp.clip(
            cfl * jnp.minimum(dt_f, dt_cv), dt_min, dt_max
        ).astype(jnp.float32)
        return new_state, aux, dt_next

    return step


def distribute_state_2d(state, grid, mesh, capacity=None):
    """Partition an ``SPHState`` onto a 2-D mesh by block ownership.

    Returns a :class:`DistState` (``[px * py * capacity, ...]``, axis 0
    sharded over both mesh axes, x-major block order) plus the chosen
    capacity - smallest multiple of 8 at least twice the densest
    block's population when not given.
    """
    px, py = mesh.devices.shape
    nx, ny, _ = grid.dims
    nxl, nyl = nx // px, ny // py
    x = np.asarray(state.x)
    v = np.asarray(state.v)
    n = x.shape[0]

    wx = nxl * grid.cell_size
    wy = nyl * grid.cell_size
    bi = np.clip(((x[:, 0] - grid.lo[0]) // wx).astype(np.int64), 0, px - 1)
    bj = np.clip(((x[:, 1] - grid.lo[1]) // wy).astype(np.int64), 0, py - 1)
    owner = bi * py + bj
    pops = np.bincount(owner, minlength=px * py)
    if capacity is None:
        capacity = int(-(-2 * max(int(pops.max()), 1) // 8) * 8)

    n_dev = px * py
    rho = None if state.rho is None else np.asarray(state.rho)
    xs = np.zeros((n_dev, capacity, 3), np.float32)
    vs = np.zeros((n_dev, capacity, 3), np.float32)
    pids = np.full((n_dev, capacity), -1, np.int32)
    rhos = None if rho is None else np.zeros((n_dev, capacity), np.float32)
    for d in range(n_dev):
        sel = np.nonzero(owner == d)[0]
        if len(sel) > capacity:
            raise ValueError(
                "device %d block holds %d particles > capacity %d"
                % (d, len(sel), capacity)
            )
        xs[d, : len(sel)] = x[sel]
        vs[d, : len(sel)] = v[sel]
        pids[d, : len(sel)] = sel
        if rhos is not None:
            rhos[d, : len(sel)] = rho[sel]

    sh = NamedSharding(mesh, P(mesh.axis_names))
    return DistState(
        x=jax.device_put(xs.reshape(-1, 3), sh),
        v=jax.device_put(vs.reshape(-1, 3), sh),
        pid=jax.device_put(pids.reshape(-1), sh),
        rho=(
            None if rhos is None
            else jax.device_put(rhos.reshape(-1), sh)
        ),
    ), capacity
