"""Slab-sequential SPH step for particle counts whose dense cell layout
exceeds one device's memory.

The standard step (``tpgsd.sph.step.make_step_fn``) materializes the
whole domain's dense cell layout at once: ~6.6 slots/particle across up
to 9 field planes, a few hundred bytes/particle of peak device memory,
while the state itself (x, v = 24 B/particle) is far smaller.

This module trades wall time for memory: the x-major cell order makes
every x-slab a CONTIGUOUS cell range AND (after the global cell sort) a
contiguous range of sorted particles, so a ``lax.scan`` over slabs can

1. build only ONE slab's dense layout (+2 halo cell-planes each side)
   per iteration with one gather from the sorted features,
2. run the same pair sweeps as the global step (Triton kernels or jnp
   blocks, :func:`tpgsd.sph.step.pair_sweeps`) on the slab's extended
   grid - positions shifted into the slab frame,
3. compact the core cells' results through a fixed-size window row
   gather and ``dynamic_update_slice`` them into a full-length
   sorted-order output.  Ascending slab order makes each region's last
   writer its owning slab, so window rows past a slab's true particle
   count are harmlessly overwritten by the next slab.  A window
   narrower than some slab's population is COUNTED per step
   (``aux[3]``, slab window overflow), never silent - re-slab with a
   wider window (the default is ``3 n / n_slabs``).

Peak memory is the sorted state plus one slab's dense planes.  There is
no inter-slab communication at all - halos are rebuilt from the global
sorted array each step, which costs ~4/nxl extra planes of pair math;
the multi-device version of the same decomposition (with real ppermute
halos and migration instead of a global sort) is
``tpgsd.sph.distributed``.  Where one device holds the global step's
layout, that step is the simpler choice; where the crossover lies on a
given card is not yet measured.

Matches ``make_step_fn`` semantics: same sweeps, same wall/gravity/
n_fixed treatment, same counted cell overflow; ``periodic`` and
``xsph`` are not supported here (use the distributed step for periodic
scale-out).  Parity with the global step is exact up to float
reassociation (``tests/test_bigstep.py``).
"""

import numpy as np

import jax
import jax.numpy as jnp

from .cells import CellGrid, cell_id, neighbor_table
from .kernels import WendlandC2
from .step import (
    SPHState,
    _renormalize_density,
    pair_sweeps,
    resolve_use_pallas,
    tait_pressure,
)

#: halo planes on each side of a slab (2: one so density is valid one
#: plane into the halo, one more so those densities see their neighbors)
_PAD = 2


def _with_sentinel(a, fill):
    """Append the all-``fill`` sentinel row the neighbour table points
    out-of-range cells at."""
    row = jnp.full((1,) + a.shape[1:], fill, a.dtype)
    return jnp.concatenate([a, row])


def make_slab_step_fn(
    grid,
    params,
    n_slabs,
    window=None,
    kernel=WendlandC2,
    block=32,
    use_pallas="auto",
    pallas_interpret=False,
    n_fixed=0,
    density_renorm=False,
    slab_emit=None,
    density_mode="summation",
    delta_sph=0.1,
):
    """Build the memory-bounded slab-sequential step.

    Args:
        grid: global :class:`CellGrid`; ``dims[0]`` must be a multiple
            of ``n_slabs``.
        n_slabs: sequential x-slabs per step.  More slabs = less peak
            memory, slightly more recomputed halo pair math
            (``4 / (dims[0] / n_slabs)`` extra cell-planes per slab).
        window: compaction window rows per slab (default
            ``ceil(3 n / n_slabs)`` at trace time).  Must be >= the
            largest per-slab particle population; shortfalls are
            counted in ``aux[3]``.
        use_pallas / pallas_interpret / block / kernel / n_fixed /
            density_renorm: as in :func:`tpgsd.sph.step.make_step_fn`.
        slab_emit: optional host callback
            ``(step, slab, p0, rows, pids, payload) -> None`` wired
            through an ordered ``jax.experimental.io_callback`` INSIDE
            the slab scan: as soon as slab ``s`` finishes, its window
            of FINAL integrated results - ``payload[w_rows, 8]``
            columns ``x(3), v(3), rho, p`` with ``pids[w_rows]`` the
            global particle ids (pid ``-1`` marks rows past the
            particle count) and ``rows`` the slab's true sorted-row
            count (``rows > w_rows`` = the counted window overflow:
            the excess rows appear in NO emission, so the receiver
            must surface the gap - ``SlabDumpChannel`` warns and
            counts it in ``gap_rows``) - streams device->host while
            later slabs are still computing.  Sorted rows ``[p0_s, p0_{s+1})`` are final
            after slab ``s`` (later slabs write only at higher
            offsets), and ordered emission means a later slab's
            overlap rows overwrite an earlier slab's halo values
            host-side, so scattering every window by pid reconstructs
            the exact post-step frame (the integration is the same
            shared helper the full-array epilogue uses).  This
            overlaps the frame's D2H with compute instead of
            serializing a whole-frame transfer after the step - the
            pipelined dump at >HBM scale
            (:class:`tpgsd.io_runtime.SlabDumpChannel`).  With
            ``slab_emit`` the returned step takes a second traced
            argument: ``step(state, dump) -> ...`` where ``dump`` is
            ``(emit_flag, step_number)`` - emission happens only when
            ``emit_flag`` is nonzero.
        density_mode: ``"summation"`` (default) or ``"continuity"`` -
            as in :func:`tpgsd.sph.step.make_step_fn`.  Continuity
            carries ``state.rho`` (seed with
            :func:`slab_init_density`), rides it through the sorted
            features (7 columns), and runs the fused accel+drho sweep
            per slab - ONE neighbor pass per step instead of two.
        delta_sph: Molteni-Colagrossi diffusion strength (continuity
            mode only).

    Returns:
        ``step(state) -> (state, (rho, p, cell_overflow, window_overflow))``
        (with ``slab_emit``: ``step(state, dump)``, same outputs).
    """
    if density_mode not in ("summation", "continuity"):
        raise ValueError("density_mode must be summation or continuity")
    continuity = density_mode == "continuity"
    if continuity and density_renorm:
        raise ValueError(
            "density_renorm corrects summation's free-surface support "
            "deficit; continuity mode has no deficit to correct - use "
            "delta_sph for its noise control instead"
        )

    nx, ny, nz = grid.dims
    S = int(n_slabs)
    if nx % S != 0:
        raise ValueError("grid nx=%d must be a multiple of n_slabs=%d" % (nx, S))
    nxl = nx // S
    nynz = ny * nz
    k = grid.capacity
    c = grid.n_cells
    c_ext = (nxl + 2 * _PAD) * nynz
    cell = grid.cell_size

    ext_grid = CellGrid(
        lo=(0.0, 0.0, 0.0),
        cell_size=cell,
        dims=(nxl + 2 * _PAD, ny, nz),
        capacity=k,
    )
    sweeps = pair_sweeps(
        resolve_use_pallas(use_pallas), block, interpret=pallas_interpret
    )
    nbr_ext = neighbor_table(ext_grid)

    lo_g = np.asarray(grid.lo, np.float32)
    hi_g = lo_g + cell * np.asarray(grid.dims, np.float32)
    gravity = np.asarray(params.gravity, np.float32)
    # slab-frame origin of slab s: global lo shifted to the first halo
    # plane (kernels see positions relative to their own ext grid)
    core0 = _PAD * nynz  # first core cell within the ext range

    nf = 7 if continuity else 6  # sorted feature columns (x, v[, rho])


    def step(state, dump=None):
        if slab_emit is not None:
            if dump is None:
                raise TypeError(
                    "this step was built with slab_emit: call "
                    "step(state, dump) where dump is chan.dump(step) "
                    "for an emitting step or chan.no_dump() for a "
                    "silent one (SlabDumpChannel)"
                )
            emit_flag, dump_step = dump
        x, v = state.x, state.v
        if continuity and state.rho is None:
            raise ValueError(
                "density_mode='continuity' needs state.rho - seed it "
                "with tpgsd.sph.slab_init_density(state, grid, params, "
                "n_slabs)"
            )
        n = x.shape[0]
        w_rows = int(window) if window else -(-3 * n // S)
        iota = jnp.arange(n, dtype=jnp.int32)

        # ---- global cell sort (the only full-domain pass) ----
        cid = cell_id(x, grid)
        cid_s, order = jax.lax.sort((cid, iota), num_keys=1)
        starts = jnp.searchsorted(
            cid_s, jnp.arange(c, dtype=cid_s.dtype), method="sort"
        ).astype(jnp.int32)
        counts = jnp.diff(
            jnp.concatenate([starts, jnp.full((1,), n, jnp.int32)])
        )
        boundary = jnp.concatenate(
            [jnp.ones((1,), bool), cid_s[1:] != cid_s[:-1]]
        )
        run_start = jax.lax.cummax(jnp.where(boundary, iota, 0))
        slot = iota - run_start
        dropped = slot >= k
        cell_ovf = dropped.sum().astype(jnp.int32)

        # sorted features (continuity rides the carried density as a
        # 7th column); rows past n are zeros - the empty-slot source of
        # the per-slab layout gather and the window slices
        feats = [x, v] + ([state.rho[:, None]] if continuity else [])
        vs = jnp.concatenate(feats, axis=-1)[order]
        vs_pad = jnp.concatenate([vs, jnp.zeros((w_rows, nf), vs.dtype)])

        # ext-range helpers padded with _PAD virtual planes each side
        starts_ext = jnp.concatenate(
            [
                jnp.zeros(_PAD * nynz, jnp.int32),
                starts,
                jnp.full(_PAD * nynz, n, jnp.int32),
            ]
        )
        counts_ext = jnp.concatenate(
            [
                jnp.zeros(_PAD * nynz, jnp.int32),
                counts,
                jnp.zeros(_PAD * nynz, jnp.int32),
            ]
        )
        # window slices of cid/slot can overhang the particle count
        cid_pad = jnp.concatenate([cid_s, jnp.full(w_rows, c, jnp.int32)])
        slot_pad = jnp.concatenate([slot, jnp.zeros(w_rows, jnp.int32)])
        if slab_emit is not None:
            # per-slab emission needs the global pids window-sliceable;
            # pid -1 marks rows past n
            pid_pad = jnp.concatenate(
                [order.astype(jnp.int32), jnp.full(w_rows, -1, jnp.int32)]
            )

        kslots = jnp.arange(k, dtype=jnp.int32)

        def integrate(xw, vw, out6, fixed_mask, rho_cur=None):
            """Symplectic Euler + reflective walls from a result bundle.

            Shared by the full-array epilogue and the per-slab emission
            so the streamed frame rows are EXACTLY the post-step state.
            ``out6`` columns: [acc3 | rho | p | live] (summation) or
            [acc3 | drho | - | live] (continuity, with the carried
            density in ``rho_cur``).
            """
            valid = out6[..., 5] > 0.5
            acc = jnp.where(valid[:, None], out6[..., :3], 0.0) + gravity
            if continuity:
                # dropped/overflowed rows carry drho = 0 and keep
                # their density (as the global step's sentinel gather)
                drho = jnp.where(valid, out6[..., 3], 0.0)
                rho_w = jnp.maximum(
                    rho_cur + params.dt * drho, 0.1 * params.rho0
                )
                p_w = tait_pressure(rho_w, params)
            else:
                rho_w = jnp.where(valid, out6[..., 3], params.rho0)
                p_w = jnp.where(valid, out6[..., 4], 0.0)
            v_new = (vw + params.dt * acc) * params.velocity_damping
            x_new = xw + params.dt * v_new
            under = x_new < lo_g
            over = x_new > hi_g
            x_new = jnp.where(under, 2.0 * lo_g - x_new, x_new)
            x_new = jnp.where(over, 2.0 * hi_g - x_new, x_new)
            x_new = jnp.clip(x_new, lo_g, hi_g)
            bounce = under | over
            v_new = jnp.where(bounce, -params.wall_damping * v_new, v_new)
            if fixed_mask is not None:
                x_new = jnp.where(fixed_mask[:, None], xw, x_new)
                v_new = jnp.where(fixed_mask[:, None], 0.0, v_new)
            return x_new, v_new, rho_w, p_w

        def body(out, s):
            c0e = s * nxl * nynz  # ext-range start (starts_ext coords)
            st = jax.lax.dynamic_slice(starts_ext, (c0e,), (c_ext,))
            ct = jax.lax.dynamic_slice(counts_ext, (c0e,), (c_ext,))
            mask = kslots[None, :] < jnp.minimum(ct, k)[:, None]

            dense = vs_pad[jnp.where(mask, st[:, None] + kslots, n)]
            # shift positions into the slab frame
            origin = jnp.stack(
                [
                    lo_g[0] + (s * nxl - _PAD) * cell,
                    jnp.float32(lo_g[1]),
                    jnp.float32(lo_g[2]),
                ]
            )
            dense_x = _with_sentinel(dense[..., :3] - origin, 0.0)
            dense_v = _with_sentinel(dense[..., 3:6], 0.0)
            mask_s = _with_sentinel(mask, False)
            live = mask.astype(jnp.float32)[..., None]

            if continuity:
                # carried density rides column 6; ONE fused accel+drho
                # sweep per slab replaces the density+accel pair
                rho_d = jnp.where(
                    mask, jnp.maximum(dense[..., 6], 0.1 * params.rho0),
                    params.rho0,
                )
                p_d = jnp.where(mask, tait_pressure(rho_d, params), 0.0)
                out4 = sweeps.accel_drho(
                    dense_x, dense_v, _with_sentinel(rho_d, params.rho0),
                    _with_sentinel(p_d, 0.0), mask_s, nbr_ext, params,
                    kernel, delta_sph,
                )
                # bundle columns [acc3 | drho | - | live]
                bundle = jnp.concatenate(
                    [out4, jnp.zeros_like(live), live], axis=-1
                )
            else:
                rho_d = sweeps.density(
                    dense_x, mask_s, nbr_ext, params, kernel
                )
                rho_d = jnp.where(
                    mask, jnp.maximum(rho_d, 0.1 * params.rho0), params.rho0
                )
                if density_renorm:
                    rho_d = _renormalize_density(rho_d, params)
                p_d = jnp.where(mask, tait_pressure(rho_d, params), 0.0)
                acc_d = sweeps.accel(
                    dense_x, dense_v, _with_sentinel(rho_d, params.rho0),
                    _with_sentinel(p_d, 0.0), mask_s, nbr_ext, params,
                    kernel,
                )
                bundle = jnp.concatenate(
                    [acc_d, rho_d[..., None], p_d[..., None], live], axis=-1
                )  # [c_ext, k, 6]

            # ---- compact core results through the window ----
            p0 = starts_ext[c0e + core0]  # sorted position of slab base
            cw = jax.lax.dynamic_slice(cid_pad, (p0,), (w_rows,)) - (
                s * nxl - _PAD
            ) * nynz
            sw = jax.lax.dynamic_slice(slot_pad, (p0,), (w_rows,))
            win = bundle[
                jnp.clip(cw, 0, c_ext - 1), jnp.clip(sw, 0, k - 1)
            ]  # [w_rows, 6]
            # dropped (cell-overflow) particles have slot >= k: the
            # clamped gather read a LIVE particle's row - zero it so
            # they fall back to the ballistic defaults (valid=0),
            # matching the global step's sentinel-row treatment
            win = jnp.where((sw < k)[:, None], win, 0.0)
            out = jax.lax.dynamic_update_slice(out, win, (p0, 0))
            rows_s = starts_ext[c0e + core0 + nxl * nynz] - p0

            if slab_emit is not None:
                # stream this slab's FINAL rows to the host while later
                # slabs compute.  Rows [p0_s, p0_{s+1}) are final after
                # slab s; overlap rows beyond that carry halo values a
                # later (ordered) emission overwrites host-side.
                pids_w = jax.lax.dynamic_slice(pid_pad, (p0,), (w_rows,))
                xv_w = jax.lax.dynamic_slice(vs_pad, (p0, 0), (w_rows, nf))
                fixed_w = (
                    (pids_w >= 0) & (pids_w < n_fixed)
                    if n_fixed > 0
                    else None
                )
                xw, vw, rho_w, p_w = integrate(
                    xv_w[:, :3], xv_w[:, 3:6], win, fixed_w,
                    rho_cur=xv_w[:, 6] if continuity else None,
                )
                payload = jnp.concatenate(
                    [xw, vw, rho_w[:, None], p_w[:, None]], axis=-1
                )

                def _do(op):
                    pids_op, payload_op, rows_op = op
                    jax.experimental.io_callback(
                        slab_emit,
                        None,
                        dump_step,
                        s,
                        p0,
                        rows_op,
                        pids_op,
                        payload_op,
                        ordered=True,
                    )
                    return jnp.int32(0)

                def _skip(op):
                    return jnp.int32(0)

                jax.lax.cond(
                    emit_flag != 0, _do, _skip, (pids_w, payload, rows_s)
                )

            return out, jnp.maximum(rows_s - w_rows, 0)

        out0 = jnp.zeros((n + w_rows, 6), jnp.float32)
        out_sorted, win_short = jax.lax.scan(
            body, out0, jnp.arange(S, dtype=jnp.int32)
        )
        win_ovf = win_short.sum().astype(jnp.int32)

        inv = jnp.argsort(order)
        out_p = out_sorted[:n][inv]  # [n, 6] particle order
        fixed_mask = (
            jnp.arange(n, dtype=jnp.int32) < n_fixed if n_fixed > 0 else None
        )
        # symplectic Euler + reflective walls (as make_step_fn), via the
        # same helper the per-slab emission uses
        x_new, v_new, rho, p = integrate(
            x, v, out_p, fixed_mask,
            rho_cur=state.rho if continuity else None,
        )

        return (
            SPHState(x=x_new, v=v_new, rho=rho if continuity else None),
            (rho, p, cell_ovf, win_ovf),
        )

    return step


def slab_init_density(state, grid, params, n_slabs, **kw):
    """Seed continuity's carried density at >HBM scale.

    The big-step twin of :func:`tpgsd.sph.init_density` (whose dense
    layout would not fit): one jitted summation slab pass evaluates the
    SPH density at ``state.x`` (the returned aux density is computed
    from the PRE-step positions) and attaches it as ``state.rho``.
    Extra ``kw`` forward to :func:`make_slab_step_fn` (e.g.
    ``use_pallas``, ``window``).
    """
    import jax as _jax

    step = make_slab_step_fn(
        grid, params, n_slabs, density_mode="summation", **kw
    )
    rho = _jax.jit(lambda st: step(st)[1][0])(state)
    return state._replace(rho=rho)
