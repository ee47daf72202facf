"""Explicitly-communicating distributed SPH: slab decomposition over a
device mesh with ppermute halo exchange and particle migration.

The jit-sharded step in ``tpgsd.sph.step`` lets GSPMD place collectives
around a *global* cell sort - simple, but the sort gathers across the
whole mesh every step.  This module is the scale-out design: the domain
is cut into contiguous x-slabs (the linear cell index is x-major, so a
slab is a contiguous cell range), each device owns the particles in its
slab, and each step communicates only:

* one cell-plane of boundary data to each x-neighbor
  (``lax.ppermute`` - halo traffic scales with slab *surface*), and
* the particles that crossed a slab face (migration buffers, also
  ``ppermute``).

No global sort, no all-gather of particle state.  This is the SPH
analogue of context-parallel halo exchange (SURVEY.md section 5
"long-context" entry).  The per-device compute reuses the same
fixed-capacity cell-dense layout as the single-device path.

Capacity model (all static shapes): each device holds ``cap`` particle
slots with an ``alive`` mask, and at most ``migrate_cap`` particles can
cross a face per step; every overflow is counted in ``aux`` rather
than silently dropped.  Send-side overflow (more than ``migrate_cap``
crossings in one step) keeps the particle alive locally one more step
- a one-step delay, never loss.  Receive-side overflow (an arriving
migrant finds no free slot) does lose the particle, but only occurs
when a slab's occupancy exceeds ``cap - arrivals``; it is counted in
``aux.migrate_overflow`` so the caller can re-slab with more capacity.
"""

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .cells import CellGrid, _sorted_slot_map, neighbor_table
from .kernels import WendlandC2
from .step import (
    _st_force_blocks,
    _st_normals_blocks,
    _energy_blocks,
    _mimage_of,
    _renormalize_density,
    _xsph_blocks,
    pair_sweeps,
    resolve_use_pallas,
    tait_pressure,
)


class DistState(NamedTuple):
    """Per-device particle slots, globally ``[n_devices * cap, ...]``
    sharded on axis 0.

    ``pid`` preserves particle identity across migrations (-1 = dead
    slot).
    """

    x: jax.Array  # [S*cap, 3] float32
    v: jax.Array  # [S*cap, 3] float32
    pid: jax.Array  # [S*cap] int32, -1 for dead slots
    #: carried density, only in continuity-density mode (see
    #: ``make_distributed_step_fn(density_mode="continuity")``); the
    #: default summation mode leaves it ``None`` (an empty pytree slot,
    #: exactly as ``SPHState.rho``)
    rho: jax.Array = None


class DistAux(NamedTuple):
    rho: jax.Array  # [S*cap]
    p: jax.Array  # [S*cap]
    cell_overflow: jax.Array  # [S] per-device dropped-from-cells count
    migrate_overflow: jax.Array  # [S] per-device failed-migration count
    dudt: jax.Array  # [S*cap] internal-energy rate (zeros unless the
    # step was built with compute_energy=True)


def _local_cells(x, alive, nxl, ny, nz, capacity, lo_local, cell_size):
    """Cell assignment for one device's slab (x-major local ids),
    scatter-free: one sort + one binary search + gathers (scatters
    are avoided; see ``tpgsd.sph.cells.build_cells``).

    Dead slots sort into a sentinel cell past the grid.  Returns
    (cid_sorted, slot, order, gidx, mask, overflow) where ``gidx`` is
    the ``[c+1, capacity]`` gather map into SORTED order (n = empty).
    """
    n = x.shape[0]
    c = nxl * ny * nz
    lo = jnp.asarray(lo_local)
    idx = jnp.floor((x - lo) / cell_size).astype(jnp.int32)
    idx = jnp.clip(idx, 0, jnp.asarray([nxl - 1, ny - 1, nz - 1]))
    cid = idx[:, 0] * (ny * nz) + idx[:, 1] * nz + idx[:, 2]
    cid = jnp.where(alive, cid, c)  # dead -> sentinel cell

    # shared slot-map core (tpgsd.sph.cells); the sentinel row (c) holds
    # the dead particles and never produces live slots
    order, cid_s, valid, gidx, slot, _starts = _sorted_slot_map(
        cid, c + 1, capacity, live_rows=c
    )
    dead_s = cid_s == c
    dropped = (slot >= capacity) & ~dead_s
    slot = jnp.where(dropped | dead_s, capacity, slot)
    return cid_s, slot, order, gidx, valid, dropped.sum().astype(jnp.int32)


def _scatter(values, order, gidx, fill=0.0):
    """Dense [c+1, capacity, ...] layout: one n-row gather into sorted
    order + one dense gather through the elementwise ``gidx`` map."""
    trailing = values.shape[1:]
    pad = jnp.full((1,) + trailing, fill, values.dtype)
    vs = jnp.concatenate([values[order], pad])
    return vs[gidx]


def _gather(dense, cid_s, slot, order, c, capacity):
    n = order.shape[0]
    slot_c = jnp.minimum(slot, capacity - 1)
    cid_c = jnp.where(slot >= capacity, c, cid_s)
    sorted_vals = dense[cid_c, slot_c]
    inv = jnp.zeros(n, order.dtype).at[order].set(jnp.arange(n, dtype=order.dtype))
    return sorted_vals[inv]


def _halo_exchange(arrays, nynz, axis, send_right, send_left):
    """Append each x-neighbor's boundary cell-plane as ghost planes.

    ``arrays``: list of ``[c+1, K, ...]`` dense arrays (sentinel row
    last).  Returns extended ``[nynz + c + nynz (+1 sentinel), ...]``
    arrays.  With edge-terminated permutations, edge devices receive
    zeros (lax.ppermute semantics for unnamed targets) - exactly the
    empty-ghost boundary condition since the mask rides along; ring
    permutations make the ghosts real (periodic x).
    """
    c = arrays[0].shape[0] - 1

    out = []
    for a in arrays:
        right_face = a[c - nynz : c]  # last x-plane (w/o sentinel)
        left_face = a[:nynz]  # first x-plane
        ghost_left = jax.lax.ppermute(right_face, axis, send_right)
        ghost_right = jax.lax.ppermute(left_face, axis, send_left)
        out.append(jnp.concatenate([ghost_left, a[:c], ghost_right, a[c:]], axis=0))
    return out


def _pack_migrants(values, send_mask, cap):
    """Pack rows where ``send_mask`` into a fixed ``[cap, ...]`` buffer.

    Returns (buffer, n_packed, overflow_count).  Rows beyond ``cap``
    are NOT packed (caller keeps them alive locally for one more step).
    """
    rank = jnp.cumsum(send_mask.astype(jnp.int32)) - 1  # pack position
    ok = send_mask & (rank < cap)
    dest = jnp.where(ok, rank, cap)  # cap = dropped by mode="drop"
    buf = jnp.zeros((cap,) + values.shape[1:], values.dtype)
    buf = buf.at[dest].set(values, mode="drop")
    n_packed = ok.sum().astype(jnp.int32)
    overflow = (send_mask.sum() - n_packed).astype(jnp.int32)
    return buf, n_packed, overflow, ok


def _insert(values, alive, recv_vals, recv_valid):
    """Insert received rows into dead slots (first-fit).

    Valid rows are first compacted (ranked by their order among the
    valid rows, not by raw buffer position), so the j-th arriving
    migrant takes the j-th free slot no matter where in the stacked
    receive buffer it landed.  Returns ``(merged, n_lost)`` where
    ``n_lost`` counts valid rows for which no free slot existed.
    """
    n = alive.shape[0]
    dead_rank = jnp.cumsum((~alive).astype(jnp.int32)) - 1  # rank among dead
    # slot index of the k-th dead slot: scatter positions by dead rank
    slot_of_rank = jnp.full(n, n, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(~alive, dead_rank, n)].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    recv_rank = jnp.cumsum(recv_valid.astype(jnp.int32)) - 1
    targets = slot_of_rank[jnp.clip(recv_rank, 0, n - 1)]
    targets = jnp.where(recv_valid, targets, n)  # invalid -> dropped
    lost = (recv_valid & (targets >= n)).sum().astype(jnp.int32)
    return values.at[targets].set(recv_vals, mode="drop"), lost


#: column permutation swapping the x and y axes of ``[N, 3]`` arrays
_PERM01 = np.array([1, 0, 2])


def _swap01_tuple(t):
    return (t[1], t[0], t[2])


def make_distributed_step_fn(
    grid,
    params,
    mesh,
    capacity=None,
    migrate_cap=None,
    axis_name="shard",
    kernel=WendlandC2,
    block=32,
    use_pallas="auto",
    pallas_interpret=False,
    n_fixed=0,
    periodic=False,
    compute_energy=False,
    decomp_axis=0,
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the slab-decomposed distributed step.

    Args:
        grid: global :class:`CellGrid`; ``grid.dims[decomp_axis]`` must
            be a multiple of the mesh size (each device owns
            ``n / n_devices`` planes of cells along the decomposed axis).
        params: :class:`SPHParams`.
        mesh: 1-D ``jax.sharding.Mesh``.
        capacity: particle slots per device (default: next multiple of 8
            of ``2 * n_global / n_devices`` chosen by the caller - this
            builder has no n, so REQUIRED in practice via
            :func:`distribute_state`).
        migrate_cap: max migrations per face per step (default
            ``capacity // 4``).
        n_fixed: particles with ``pid < n_fixed`` are static boundary
            particles (the first ``n_fixed`` rows of the global state
            passed to :func:`distribute_state`): full density/pressure
            sources, but never integrated and never migrated - the
            distributed form of ``make_step_fn(..., n_fixed=...)``.
        periodic: periodic global box.  The x axis wraps through the
            RING halo (device n-1 exchanges planes and migrants with
            device 0 - ppermute with a ring permutation); y/z wrap
            locally, in the cell table and the minimum image, when they
            have >= 3 cells.
        compute_energy: also run the WCSPH energy equation (a third
            pair pass reusing the halo-exchanged rho/p) and return
            per-particle du/dt in ``aux.dudt`` (zeros when off - the
            default, since it costs ~an accel pass).
        xsph: XSPH drift-velocity smoothing strength (Monaghan's
            epsilon; 0 = off) - one extra pair pass over the
            halo-exchanged velocities, same semantics as the
            single-device step.
        density_renorm: free-surface density floor, as in
            :func:`tpgsd.sph.make_step_fn` (applied to owner densities
            before the rho/p halo exchange, so ghosts carry it too).
        decomp_axis: 0 (x-slabs, the default) or 1 (y-slabs, for wide
            planar domains whose x extent is too narrow to cut).  The
            y form is the x machinery run on the axis-swapped problem:
            SPH is isotropic, so swapping the x/y coordinates of the
            grid, gravity, and state is exact - one column permutation
            per step each way, no second slab implementation to keep
            in sync.
        use_pallas / pallas_interpret: the pair-sweep path, as in
            :func:`tpgsd.sph.make_step_fn`; the Triton kernels run
            inside the ``shard_map`` on each device's extended slab.
        density_mode: ``"summation"`` (default) re-sums density each
            step; ``"continuity"`` evolves it as carried per-particle
            state (``DistState.rho``, seeded globally with
            :func:`tpgsd.sph.init_density` before
            :func:`distribute_state`), as in
            :func:`tpgsd.sph.make_step_fn`.  Continuity mode is the
            BETTER distributed fit: density is state, so ghost
            densities are exact by construction - ONE fused halo
            exchange (x|v|rho|p|mask in a single ppermute pair) and ONE
            fused accel+drho pair pass replace summation mode's two
            exchange rounds and two sweeps.  Migrating particles carry
            their density in the migration payload.
        delta_sph: delta-SPH density-diffusion strength (continuity
            mode only; same scheme and default as the single-device
            step).

    Returns:
        ``step(state: DistState) -> (DistState, DistAux)``, jitted with
        axis-0 shardings on every array.  (With the private
        ``_traced_dt=True``, instead returns the UNJITTED
        ``step(state, dt) -> (DistState, DistAux, a2max[S])`` plus the
        axis-0 sharding, for :func:`make_adaptive_distributed_step_fn`
        to compose the CFL controller around before jitting.)
    """
    if decomp_axis == 1:
        inner = make_distributed_step_fn(
            grid._replace(
                lo=_swap01_tuple(grid.lo), dims=_swap01_tuple(grid.dims)
            ),
            params._replace(gravity=_swap01_tuple(tuple(params.gravity))),
            mesh,
            capacity=capacity,
            migrate_cap=migrate_cap,
            axis_name=axis_name,
            kernel=kernel,
            block=block,
            use_pallas=use_pallas,
            pallas_interpret=pallas_interpret,
            n_fixed=n_fixed,
            periodic=periodic,
            compute_energy=compute_energy,
            decomp_axis=0,
            xsph=xsph,
            density_renorm=density_renorm,
            surface_tension=surface_tension,
            density_mode=density_mode,
            delta_sph=delta_sph,
            _traced_dt=_traced_dt,
        )

        def _swapped(state):
            # rho is a scalar field - invariant under the column swap
            return DistState(
                x=state.x[:, _PERM01],
                v=state.v[:, _PERM01],
                pid=state.pid,
                rho=state.rho,
            )

        if _traced_dt:
            inner_step, sh = inner

            def step_dt(state, dt):
                # |acc| is invariant under the 0<->1 column swap, so the
                # controller input passes straight through
                new, aux, a2 = inner_step(_swapped(state), dt)
                return _swapped(new), aux, a2

            return step_dt, sh

        def step(state):
            new, aux = inner(_swapped(state))
            return _swapped(new), aux

        return step
    if decomp_axis != 0:
        raise ValueError("decomp_axis must be 0 or 1, got %r" % (decomp_axis,))

    n_dev = mesh.devices.size
    nx, ny, nz = grid.dims
    if nx % n_dev != 0:
        raise ValueError(
            "grid nx=%d must be a multiple of the mesh size %d" % (nx, n_dev)
        )
    nxl = nx // n_dev
    nynz = ny * nz
    c_local = nxl * nynz
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

    # extended (ghost-padded) local grid for the pair loops; with a
    # periodic box, y/z wrap locally in the table while x periodicity
    # flows through the ring halo below
    ext_grid = CellGrid(
        lo=(0.0, 0.0, 0.0), cell_size=cell, dims=(nxl + 2, ny, nz), capacity=k
    )
    nbr_ext = neighbor_table(
        ext_grid, periodic=(False, periodic, periodic) if periodic else False
    )
    if periodic and nx < 3:
        raise ValueError("periodic needs >= 3 cells along x")
    wrap = periodic & (np.asarray(grid.dims) >= 3)
    mimage = _mimage_of(grid, periodic)  # shared wrap-rule + sentinel

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
    if periodic:
        # ring: device n-1 is device 0's left neighbor
        send_right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        send_left = [((i + 1) % n_dev, i) for i in range(n_dev)]
    else:
        send_right = [(i, i + 1) for i in range(n_dev - 1)]
        send_left = [(i + 1, i) for i in range(n_dev - 1)]

    def local_step(x, v, pid, rho_in, dt):
        # x/v/pid are this device's [cap] slot arrays (rho_in carried
        # density in continuity mode, None otherwise); dt is the
        # trace-time constant params.dt on the fixed path or a traced
        # replicated scalar on the adaptive path
        d = jax.lax.axis_index(axis_name)
        alive = pid >= 0
        lo_local = lo_g + jnp.asarray([d * nxl * cell, 0.0, 0.0], jnp.float32)

        cid_s, slot, order, gidx, mask, cell_ovf = _local_cells(
            x, alive, nxl, ny, nz, k, lo_local, cell
        )
        core = slice(nynz, nynz + c_local)

        if continuity:
            # density is CARRIED STATE here, so ghost densities are
            # exact by construction: one fused layout scatter (x|v|rho)
            # and ONE fused halo exchange (x|v|rho|p|mask - a single
            # ppermute pair) replace summation mode's two exchange
            # rounds; the separate density sweep disappears too (the
            # fused accel+drho pass below)
            xvr = _scatter(
                jnp.concatenate([x, v, rho_in[:, None]], axis=-1),
                order, gidx,
            )
            rho_dense = jnp.where(
                mask, jnp.maximum(xvr[..., 6], 0.1 * params.rho0),
                params.rho0,
            )
            # pressure does NOT ride the halo: it is pure per-element
            # math on rho (Tait), so the receiver recomputes it from the
            # exchanged density - ~11% less halo traffic, bit-identical
            # values (same rho bits -> same p bits)
            big = jnp.concatenate(
                [
                    xvr[..., :6],
                    rho_dense[..., None],
                    mask.astype(jnp.float32)[..., None],
                ],
                axis=-1,
            )
            (ext,) = _halo_exchange(
                [big], nynz, axis_name, send_right, send_left
            )
            ext_x, ext_v = ext[..., :3], ext[..., 3:6]
            ext_mask = ext[..., 7] > 0.5
            # edge devices receive zero planes; refill dead/absent
            # slots with rho0 so p/rho^2 terms stay finite (masked out
            # of every sum anyway)
            rho_d = jnp.where(
                ext_mask, jnp.maximum(ext[..., 6], 0.1 * params.rho0),
                params.rho0,
            )
            p_d = jnp.where(ext_mask, tait_pressure(rho_d, params), 0.0)
        else:
            # one fused layout gather for x AND v
            xv = _scatter(jnp.concatenate([x, v], axis=-1), order, gidx)
            dense_x, dense_v = xv[..., :3], xv[..., 3:]

            # halo exchange: one x-plane of cells each way
            ext_x, ext_v, ext_m = _halo_exchange(
                [dense_x, dense_v, mask.astype(jnp.float32)[..., None]],
                nynz,
                axis_name,
                send_right,
                send_left,
            )
            ext_mask = ext_m[..., 0] > 0.5
        if periodic:
            # the ring seam delivers far-end planes with raw coordinates;
            # pre-shift their x by -+Lx so ghost positions are
            # geometrically true.  The jnp minimum image then never
            # triggers on x (every true pair distance is < one cell) and
            # the Pallas kernels - which see only true geometry, no
            # min-image - get the seam right too.
            Lx = cell * nx
            sl = jnp.where(d == 0, -Lx, 0.0).astype(jnp.float32)
            sr = jnp.where(d == n_dev - 1, Lx, 0.0).astype(jnp.float32)
            ext_x = ext_x.at[:nynz, :, 0].add(sl)
            ext_x = ext_x.at[nynz + c_local : 2 * nynz + c_local, :, 0].add(sr)

        sent_rho = jnp.full((1, k), params.rho0, jnp.float32)
        if not continuity:
            # density over the extended slab; only CORE outputs are
            # correct (a ghost cell's own neighborhood extends one plane
            # further out than the halo carries - its locally-computed
            # density misses those contributions)
            rho_d = sweeps.density(
                ext_x, ext_mask, nbr_ext, params, kernel, mimage=mimage
            )

            mask_core = ext_mask[core]
            rho_core = jnp.where(
                mask_core, jnp.maximum(rho_d[core], 0.1 * params.rho0),
                params.rho0,
            )
            if density_renorm:
                # free-surface density floor (local closed form; dead
                # slots already hold rho0, the floor is a no-op there).
                # Applied BEFORE the owner rho/p exchange, so ghost
                # values carry it.
                rho_core = _renormalize_density(rho_core, params)
            p_core = jnp.where(mask_core, tait_pressure(rho_core, params), 0.0)

            # second halo exchange: the OWNER-computed rho/p of each
            # boundary plane replaces the locally-miscomputed ghost
            # values before the force pass (core forces read ghost rho/p
            # one plane deep); rho and p ride one stacked payload per
            # direction - these exchanges are latency-bound, so one
            # collective, not two
            plane_r = jnp.stack(
                [rho_core[c_local - nynz :], p_core[c_local - nynz :]],
                axis=-1,
            )
            plane_l = jnp.stack([rho_core[:nynz], p_core[:nynz]], axis=-1)
            gl = jax.lax.ppermute(plane_r, axis_name, send_right)
            gr = jax.lax.ppermute(plane_l, axis_name, send_left)
            gl_rho, gl_p = gl[..., 0], gl[..., 1]
            gr_rho, gr_p = gr[..., 0], gr[..., 1]
            # edge devices receive zeros; refill dead/absent slots with
            # rho0 so p/rho^2 terms stay finite (masked out of every
            # sum anyway)
            gl_mask = ext_mask[:nynz]
            gr_mask = ext_mask[nynz + c_local : nynz + c_local + nynz]
            gl_rho = jnp.where(gl_mask, gl_rho, params.rho0)
            gr_rho = jnp.where(gr_mask, gr_rho, params.rho0)
            gl_p = jnp.where(gl_mask, gl_p, 0.0)
            gr_p = jnp.where(gr_mask, gr_p, 0.0)

            rho_d = jnp.concatenate([gl_rho, rho_core, gr_rho, sent_rho])
            p_d = jnp.concatenate(
                [gl_p, p_core, gr_p, jnp.zeros((1, k), p_core.dtype)]
            )

        if continuity:
            # the fused accel+drho sweep on the extended local grid
            # (only CORE outputs are owner-correct; ghosts carry exact
            # carried densities, so no second exchange)
            out4_d = sweeps.accel_drho(
                ext_x, ext_v, rho_d, p_d, ext_mask, nbr_ext, params,
                kernel, delta_sph, mimage=mimage,
            )
            acc_d = out4_d[..., :3]
        else:
            acc_d = sweeps.accel(
                ext_x, ext_v, rho_d, p_d, ext_mask, nbr_ext, params, kernel,
                mimage=mimage,
            )
        if surface_tension > 0:
            # Akinci surface tension needs neighbor NORMALS; like rho/p,
            # ghost normals computed locally have truncated neighborhoods,
            # so exchange the owner-computed boundary planes first
            n_loc = _st_normals_blocks(
                ext_x, rho_d, ext_mask, nbr_ext, params, kernel, block,
                mimage=mimage,
            )
            n_core = n_loc[core]
            gl_n = jax.lax.ppermute(
                n_core[c_local - nynz :], axis_name, send_right
            )
            gr_n = jax.lax.ppermute(n_core[:nynz], axis_name, send_left)
            n_d = jnp.concatenate(
                [gl_n, n_core, gr_n, jnp.zeros((1, k, 3), n_core.dtype)]
            )
            n_d = jnp.where(ext_mask[..., None], n_d, 0.0)
            acc_d = acc_d + _st_force_blocks(
                ext_x, n_d, rho_d, ext_mask, nbr_ext, params, kernel,
                block, surface_tension, mimage=mimage,
            )
        # slice the core planes back out and bundle acc/rho/p (or
        # acc/drho in continuity mode, and du) as columns of ONE
        # particle-order gather - n-element gathers are the layout
        # cost, one fused pass instead of three/four
        cols = [acc_d[core]]
        sent = [jnp.zeros((1, k, 3), acc_d.dtype)]
        if continuity:
            # drho sentinel is 0: cell-overflow-dropped particles keep
            # their carried density, as on the single-device path
            cols.append(out4_d[core][..., 3:4])
            sent.append(jnp.zeros((1, k, 1), acc_d.dtype))
        else:
            cols += [rho_core[..., None], p_core[..., None]]
            sent += [sent_rho[..., None], jnp.zeros((1, k, 1), p_core.dtype)]
        if compute_energy:
            # third pair pass over the same halo-exchanged fields: the
            # energy equation shares _pair_terms with the momentum
            # equation, so KE + internal energy stays conserved
            du_d = _energy_blocks(
                ext_x, ext_v, rho_d, p_d, ext_mask, nbr_ext, params, kernel,
                block, mimage=mimage,
            )
            cols.append(du_d[core][..., None])
            sent.append(jnp.zeros((1, k, 1), du_d.dtype))
        if xsph > 0:
            # XSPH over the halo-exchanged velocities and owner-correct
            # rho (an extra pair pass; same semantics as single-device)
            dvc_d = _xsph_blocks(
                ext_x, ext_v, rho_d, ext_mask, nbr_ext, params, kernel,
                block, mimage=mimage,
            )
            cols.append(dvc_d[core])
            sent.append(jnp.zeros((1, k, 3), dvc_d.dtype))
        bundle = jnp.concatenate(
            [jnp.concatenate(cols, axis=-1),
             jnp.concatenate(sent, axis=-1)],
            axis=0,
        )
        out = _gather(bundle, cid_s, slot, order, c_local, k)
        acc = out[..., :3] + gravity
        if continuity:
            # density update rides the state directly: integrate the
            # gathered drho, floor, and derive pressure - per particle,
            # never a second scatter/gather round trip
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

        # integrate (dead slots don't move); XSPH smooths the DRIFT
        # velocity only
        v_new = jnp.where(alive[:, None], v + dt * acc, v)
        v_drift = v_new + xsph * dvc if dvc is not None else v_new
        x_new = jnp.where(alive[:, None], x + dt * v_drift, x)

        # global walls: reflective, except wrapped axes of a periodic
        # box (the x wrap is deferred past migration detection - a
        # crossing is detected on UNWRAPPED coordinates, then the ring
        # permutation delivers the wrapped position to the far slab)
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

        if n_fixed > 0:
            # boundary particles: full SPH sources, zero motion (their
            # x_new == x stays strictly inside the owning slab, so the
            # migration logic below never selects them)
            fixed = alive & (pid < n_fixed)
            x_new = jnp.where(fixed[:, None], x, x_new)
            v_new = jnp.where(fixed[:, None], 0.0, v_new)

        # ---- migration: particles that left this slab ----
        slab_lo = lo_g[0] + d * nxl * cell
        slab_hi = slab_lo + nxl * cell
        x_raw_0 = x_new[:, 0:1]  # pre-wrap x (identical inside the box)
        if periodic:
            go_left = alive & (x_new[:, 0] < slab_lo)
            go_right = alive & (x_new[:, 0] >= slab_hi)
            # wrap AFTER detecting the crossing direction.  On the
            # MIGRATION (x) axis, only the migration payload carries
            # the wrapped coordinate (correct on the receiving slab);
            # particles retained by send-side overflow keep the raw x -
            # a wrapped seam-crosser sitting on its OWN slab would land
            # in the far edge cells, exert forces on the wrong side of
            # the domain, and then migrate the long way around the
            # ring; the raw x re-detects the same crossing next step
            # (the documented one-step delay).  y/z wraps are LOCAL and
            # must always commit to state - retaining raw y/z would let
            # a cross-boundary drift grow without bound.
            x_new = jnp.where(
                wrap, lo_g + jnp.mod(x_new - lo_g, hi_g - lo_g), x_new
            )
        else:
            go_left = alive & (x_new[:, 0] < slab_lo) & (d > 0)
            go_right = alive & (x_new[:, 0] >= slab_hi) & (d < n_dev - 1)

        # migration payload: [x|v|pid] (+ carried rho in continuity
        # mode - the density travels WITH the particle)
        rho_col = [rho[:, None]] if continuity else []
        payload = jnp.concatenate(
            [x_new, v_new, pid.astype(jnp.float32)[:, None]] + rho_col,
            axis=1,
        )  # [cap, 7 (8 continuity)]

        buf_r, n_r, ovf_r, sent_r = _pack_migrants(payload, go_right, mig_cap)
        buf_l, n_l, ovf_l, sent_l = _pack_migrants(payload, go_left, mig_cap)
        valid_r = jnp.arange(mig_cap) < n_r
        valid_l = jnp.arange(mig_cap) < n_l

        recv_from_left = jax.lax.ppermute(buf_r, axis_name, send_right)
        recv_from_left_valid = jax.lax.ppermute(valid_r, axis_name, send_right)
        recv_from_right = jax.lax.ppermute(buf_l, axis_name, send_left)
        recv_from_right_valid = jax.lax.ppermute(valid_l, axis_name, send_left)

        # remove the migrants we actually sent
        pid_after = jnp.where(sent_r | sent_l, -1, pid)
        alive_after = pid_after >= 0

        recv_vals = jnp.concatenate([recv_from_left, recv_from_right], axis=0)
        recv_valid = jnp.concatenate(
            [recv_from_left_valid, recv_from_right_valid], axis=0
        )

        x_keep = jnp.concatenate([x_raw_0, x_new[:, 1:3]], axis=1)
        payload_new = jnp.concatenate(
            [x_keep, v_new, pid_after.astype(jnp.float32)[:, None]]
            + rho_col,
            axis=1,
        )
        payload_new = jnp.where(
            alive_after[:, None], payload_new, jnp.zeros_like(payload_new)
        )
        payload_new = payload_new.at[:, 6].set(
            jnp.where(alive_after, pid_after.astype(jnp.float32), -1.0)
        )
        merged, lost = _insert(payload_new, alive_after, recv_vals, recv_valid)

        x_out = merged[:, 0:3]
        v_out = merged[:, 3:6]
        pid_out = merged[:, 6].astype(jnp.int32)
        if continuity:
            # post-migration slot-consistent density/pressure: a
            # migrant's rho arrived in its payload, so state AND aux
            # stay aligned with the slots they describe
            rho = jnp.where(pid_out >= 0, merged[:, 7], params.rho0)
            p = jnp.where(pid_out >= 0, tait_pressure(rho, params), 0.0)

        mig_ovf = ovf_r + ovf_l + lost
        outs = (
            x_out,
            v_out,
            pid_out,
            rho,
            p,
            cell_ovf[None],
            mig_ovf[None],
            dudt,
        )
        if _traced_dt:
            # max squared acceleration of the MOBILE particles on this
            # slab - the CFL force-condition input.  Dead slots and
            # fixed boundary slots never move, so they cannot limit
            # stability (their influence is already in their mobile
            # neighbors' acc).  Per-slab [1] outputs; the controller
            # takes the global max outside the shard_map.
            mobile = alive & (pid >= n_fixed) if n_fixed > 0 else alive
            a2 = jnp.where(mobile, jnp.sum(acc * acc, axis=-1), 0.0)
            outs = outs + (jnp.max(a2)[None],)
        return outs

    sh = NamedSharding(mesh, P(axis_name))
    spec = P(axis_name)

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
                    "before distribute_state"
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


def make_adaptive_distributed_step_fn(
    grid,
    params,
    mesh,
    cfl=0.25,
    dt_min=0.0,
    dt_max=None,
    axis_name="shard",
    **kwargs,
):
    """CFL-adaptive variant of the distributed slab step.

    Same controller as the single-device
    :func:`tpgsd.sph.make_adaptive_step_fn` (Monaghan force +
    Courant/advection conditions), computed GLOBALLY: each slab
    reports its mobile particles' max |acc|^2 out of the shard_map,
    the controller maxes over slabs and over the (sharded) velocity
    field - XLA inserts the cross-device reductions - and every device
    steps with the same replicated dt.  dt is a traced scalar operand,
    so adapting it never recompiles or re-shards.

    Args:
        grid / params / mesh: as :func:`make_distributed_step_fn`.
        cfl / dt_min / dt_max: as the single-device adaptive builder
            (``dt_max`` defaults to ``params.dt``).
        **kwargs: forwarded to :func:`make_distributed_step_fn`
            (``capacity``, ``use_pallas``, ``periodic``, ``n_fixed``,
            ``decomp_axis``, ...).

    Returns:
        jitted ``step(state: DistState, dt) ->
        (DistState, DistAux, dt_next)``.  Roll out with
        :func:`tpgsd.sph.run_adaptive` (DistState is a pytree).
    """
    base, sh = make_distributed_step_fn(
        grid, params, mesh, axis_name=axis_name, _traced_dt=True, **kwargs
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
        # global reductions over the sharded per-slab maxima and the
        # sharded velocity slots (dead/fixed slots carry v == 0)
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


def distribute_state(
    state, grid, mesh, capacity=None, axis_name="shard", decomp_axis=0
):
    """Partition an ``SPHState`` onto the mesh by slab ownership.

    Returns a :class:`DistState` (``[n_devices * capacity, ...]``,
    sharded on axis 0) where each device's slots hold exactly the
    particles inside its slab, in original-index ``pid`` order.

    Args:
        capacity: slots per device (default: smallest multiple of 8
            at least ``2 * max slab population``).
        decomp_axis: slab axis, matching the step builder's.
    """
    n_dev = mesh.devices.size
    nx = grid.dims[decomp_axis]
    nxl = nx // n_dev
    x = np.asarray(state.x)
    v = np.asarray(state.v)
    n = x.shape[0]

    slab_width = nxl * grid.cell_size
    owner = np.clip(
        ((x[:, decomp_axis] - grid.lo[decomp_axis]) // slab_width).astype(
            np.int64
        ),
        0,
        n_dev - 1,
    )
    pops = np.bincount(owner, minlength=n_dev)
    if capacity is None:
        capacity = int(-(-2 * max(int(pops.max()), 1) // 8) * 8)

    rho = None if state.rho is None else np.asarray(state.rho)
    xs = np.zeros((n_dev, capacity, 3), np.float32)
    vs = np.zeros((n_dev, capacity, 3), np.float32)
    pids = np.full((n_dev, capacity), -1, np.int32)
    rhos = None if rho is None else np.zeros((n_dev, capacity), np.float32)
    for d in range(n_dev):
        sel = np.nonzero(owner == d)[0]
        if len(sel) > capacity:
            raise ValueError(
                "device %d slab holds %d particles > capacity %d"
                % (d, len(sel), capacity)
            )
        xs[d, : len(sel)] = x[sel]
        vs[d, : len(sel)] = v[sel]
        pids[d, : len(sel)] = sel
        if rhos is not None:
            rhos[d, : len(sel)] = rho[sel]

    sh = NamedSharding(mesh, P(axis_name))
    return DistState(
        x=jax.device_put(xs.reshape(-1, 3), sh),
        v=jax.device_put(vs.reshape(-1, 3), sh),
        pid=jax.device_put(pids.reshape(-1), sh),
        rho=(
            None if rhos is None
            else jax.device_put(rhos.reshape(-1), sh)
        ),
    ), capacity


class CollectedState(NamedTuple):
    """Host-side gather of a :class:`DistState`, in original pid order.

    Fixed arity regardless of density mode: ``rho`` is ``None`` unless
    the state carried continuity-mode density (mode-dependent tuple
    length was easy to misuse in generic callers).
    """

    x: "np.ndarray"  # [n_global, 3]
    v: "np.ndarray"  # [n_global, 3]
    rho: "np.ndarray" = None  # [n_global] or None (summation mode)


def collect_state(dist_state, n_global):
    """Gather a :class:`DistState` back to host, in original pid order.

    Returns a :class:`CollectedState` ``(x, v, rho)``; ``rho`` is
    ``None`` for summation-mode states and the carried density for
    continuity-mode ones (so a resume can reseed it).
    """
    x = np.asarray(dist_state.x)
    v = np.asarray(dist_state.v)
    pid = np.asarray(dist_state.pid)
    alive = pid >= 0
    out_x = np.zeros((n_global, 3), np.float32)
    out_v = np.zeros((n_global, 3), np.float32)
    out_x[pid[alive]] = x[alive]
    out_v[pid[alive]] = v[alive]
    if dist_state.rho is None:
        return CollectedState(x=out_x, v=out_v, rho=None)
    out_rho = np.zeros(n_global, np.float32)
    out_rho[pid[alive]] = np.asarray(dist_state.rho)[alive]
    return CollectedState(x=out_x, v=out_v, rho=out_rho)


def collect_aux(dist_state, aux, n_global, params=None):
    """Gather a :class:`DistAux`'s per-particle fields to host pid order.

    The slot-array analogue of :func:`collect_state` for the step's
    outputs: returns ``(rho, p)`` numpy ``[n_global]`` arrays (plus
    ``dudt`` when the step was built with ``compute_energy=True`` -
    always returned, zeros otherwise).  Rows of particles currently
    absent (dead everywhere - should not happen unless migration
    overflowed) hold ``rho0``/0; pass ``params`` to use its ``rho0``,
    else 0.
    """
    pid = np.asarray(dist_state.pid)
    alive = pid >= 0
    rho0 = float(params.rho0) if params is not None else 0.0
    out_rho = np.full(n_global, rho0, np.float32)
    out_p = np.zeros(n_global, np.float32)
    out_du = np.zeros(n_global, np.float32)
    out_rho[pid[alive]] = np.asarray(aux.rho)[alive]
    out_p[pid[alive]] = np.asarray(aux.p)[alive]
    out_du[pid[alive]] = np.asarray(aux.dudt)[alive]
    return out_rho, out_p, out_du
