"""Neighbour-pair sweeps of the WCSPH step as Pallas kernels (Triton route).

Drop-in replacements for the jnp pair blocks of :mod:`tpgsd.sph.step`
(``_density_blocks``, ``_accel_blocks``, ``_accel_drho_blocks``): the
same dense ``[n_cells + 1, K, ...]`` cell layout with its sentinel row,
the same ``[n_cells, 27]`` neighbour table, the same pair formulas and
the same outputs.  What differs is where the pair block lives.  The jnp
path gathers ``[B, K, 27K]`` pair tensors for a block of cells into
device memory and reduces them; here one program owns one cell, walks
its 27 neighbour cells in a loop, keeps each pair block in registers
and writes only the per-slot sums.

Program layout (``pl.pallas_call(..., backend="triton")``):

* fields are passed as flat structure-of-arrays planes of
  ``(n_cells + 1) * Kp`` floats, ``Kp`` = the capacity padded to a power
  of two (48 -> 64), so a cell's slots are one unmasked ``Kp``-wide load;
* a program owns 32 slots of one cell (a 64-slot cell is two
  programs); it loads its own 27 neighbour ids and each cell's extent,
  one past its last live slot (no scalar prefetch on a GPU);
* a program whose slots are all empty stores zeros and exits, and
  neighbour slots are visited in chunks of 16, each skipped when it
  lies past that cell's extent - padding costs loads, not pair math;
* periodic axes use the minimum image of the jnp path
  (:func:`tpgsd.sph.step._min_image`: ``d - m * round(d / m)``, ties to
  even), applied in the kernel;
* divisions and square roots are correctly rounded (``div.rn.f32``,
  ``sqrt.rn.f32``) and the image rounds as ``jnp.round`` does
  (``cvt.rni.f32.f32``); there is no approximate reciprocal and no
  ``dot``.

``interpret=True`` runs the same kernel body in the Pallas interpreter
(how the CPU tests exercise it).  A compiled call on a backend without
Triton raises; nothing falls back silently.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .kernels import WendlandC2

#: own slots per program: a cell of ``Kp`` slots is split over
#: ``Kp / _OWN`` programs, and a program whose slots are all past the
#: cell's last live slot stores zeros and exits
_OWN = 32

#: neighbour slots per inner chunk; a chunk past the neighbour cell's
#: last live slot is skipped, so a cell of 17 particles costs two
#: chunks whatever the capacity
_CHUNK = 16

#: warps per program.  The pair block is ``_OWN x _CHUNK`` elements per
#: live temporary; register pressure (255 a thread) bounds it, not
#: shared memory.
NUM_WARPS = 8

#: software-pipelining stages of the neighbour loop.  ``NUM_WARPS`` and
#: this are read when a sweep is traced;
#: ``benchmarks/benchmark_sph.py --num-warps/--num-stages`` times the
#: alternatives.
NUM_STAGES = 1


def padded_capacity(k):
    """Power-of-two lane width a capacity ``k`` runs at (at least 8)."""
    return max(8, 1 << (int(k) - 1).bit_length())


def _exact(interpret):
    """``(div, sqrt, rint)`` with IEEE round-to-nearest results.

    Triton lowers ``/`` to ``div.full.f32`` and ``sqrt`` to the
    approximate form, and has no rounding to the nearest even integer;
    the compiled kernel asks for the correctly rounded instructions
    instead, so its pair terms match XLA's arithmetic.  The
    interpreter's ``/``, ``sqrt`` and ``round`` are already exact.
    """
    if interpret:
        return jnp.divide, jnp.sqrt, jnp.round

    def _asm(op, *args):
        shape = jnp.broadcast_shapes(*(jnp.shape(a) for a in args))
        args = [jnp.broadcast_to(jnp.asarray(a, jnp.float32), shape) for a in args]
        srcs = ", ".join("$%d" % (i + 1) for i in range(len(args)))
        (out,) = plgpu.elementwise_inline_asm(
            "%s $0, %s;" % (op, srcs),
            args=args,
            constraints=",".join(["=r"] + ["r"] * len(args)),
            pack=1,
            result_shape_dtypes=[jax.ShapeDtypeStruct(shape, jnp.float32)],
        )
        return out

    return (
        partial(_asm, "div.rn.f32"), partial(_asm, "sqrt.rn.f32"),
        partial(_asm, "cvt.rni.f32.f32"),
    )


def _separation(xi, xj, mimage, ops):
    """Pair separations ``x_i - x_j`` per axis, minimum-imaged on the
    wrapped axes (``mimage`` as :func:`tpgsd.sph.step._mimage_of`)."""
    div, _, rint = ops
    out = []
    for a in range(3):
        d = xi[a][:, None] - xj[a][None, :]
        if mimage is not None and float(mimage[a]) < 1e29:
            m = float(mimage[a])
            d = d - m * rint(div(d, m))
        out.append(d)
    return out


def _density_terms(fi, fj, params, kernel, mimage, ops):
    div, sqrt, _ = ops
    dx = _separation(fi, fj, mimage, ops)
    r = sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
    return [kernel.w(r, params.h, dim=params.dim, div=div)]


def _pair_terms(fi, fj, params, kernel, mimage, ops):
    """Kernel form of :func:`tpgsd.sph.step._pair_terms`:
    ``(dx, dwr, press_plus_pi, vdotx, r2)`` over a ``[Kp, J]`` block."""
    div, sqrt, _ = ops
    xi, vi, rhoi, pi_ = fi[:3], fi[3:6], fi[6], fi[7]
    xj, vj, rhoj, pj = fj[:3], fj[3:6], fj[6], fj[7]
    h2eps = params.eps * params.h * params.h
    dx = _separation(xi, xj, mimage, ops)
    dv = [vi[a][:, None] - vj[a][None, :] for a in range(3)]
    r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    dwr = kernel.dw_over_r(sqrt(r2), params.h, dim=params.dim, div=div)
    press = (
        div(pi_, rhoi * rhoi)[:, None] + div(pj, rhoj * rhoj)[None, :]
    )
    vdotx = dv[0] * dx[0] + dv[1] * dx[1] + dv[2] * dx[2]
    rho_bar = 0.5 * (rhoi[:, None] + rhoj[None, :])
    visc = jnp.where(
        vdotx < 0.0, div(-params.alpha * params.c0 * params.h * vdotx,
                         (r2 + h2eps) * rho_bar), 0.0
    )
    return dx, dwr, press + visc, vdotx, r2


def _accel_terms(fi, fj, params, kernel, mimage, ops):
    dx, dwr, press_pi, _, _ = _pair_terms(fi, fj, params, kernel, mimage, ops)
    scale = -params.mass * press_pi * dwr
    return [scale * d for d in dx]


def _accel_drho_terms(fi, fj, params, kernel, mimage, ops, delta_sph):
    div = ops[0]
    dx, dwr, press_pi, vdotx, r2 = _pair_terms(
        fi, fj, params, kernel, mimage, ops
    )
    mdwr = params.mass * dwr
    acc = [(-press_pi * mdwr) * d for d in dx]
    drho = params.mass * dwr * vdotx
    if delta_sph > 0.0:
        rhoi, rhoj = fi[6][:, None], fj[6][None, :]
        eta2 = (0.1 * params.h) ** 2
        dcoef = 2.0 * delta_sph * params.h * params.c0 * params.mass
        drho = drho + div(
            dcoef * (rhoi - rhoj) * dwr * r2, rhoj * (r2 + eta2)
        )
    return acc + [drho]


def _sweep_kernel(terms, n_fields, n_out, kp, scale):
    """Pallas kernel body.  Program ``(c, b)`` owns slots
    ``[b * own, (b + 1) * own)`` of cell ``c``, walks the 27 neighbour
    cells in a loop and reduces ``own x _CHUNK`` pair blocks into
    ``n_out`` per-slot sums."""
    own = min(kp, _OWN)
    jb = min(kp, _CHUNK)

    def body(nbr_ref, ext_ref, live_ref, *refs):
        f_refs, o_refs = refs[:n_fields], refs[n_fields:]
        c = pl.program_id(0)
        b = pl.program_id(1)
        mine = pl.ds(c * kp + b * own, own)
        zero = jnp.zeros((own,), jnp.float32)

        @pl.when(b * own >= ext_ref[c])
        def _empty():
            for o in o_refs:
                o[mine] = zero

        @pl.when(b * own < ext_ref[c])
        def _sweep():
            fi = [r[mine] for r in f_refs]
            live_i = live_ref[mine] > 0.5

            def visit(j, acc):
                nc = nbr_ref[c * 27 + j]
                ext = ext_ref[nc]
                for s in range(0, kp, jb):

                    def add(acc, s=s):
                        sl = pl.ds(nc * kp + s, jb)
                        fj = [r[sl] for r in f_refs]
                        live_j = live_ref[sl] > 0.5
                        return tuple(
                            a + jnp.sum(jnp.where(live_j[None, :], t, 0.0), axis=1)
                            for a, t in zip(acc, terms(fi, fj))
                        )

                    acc = jax.lax.cond(s < ext, add, lambda a: a, acc)
                return acc

            acc = jax.lax.fori_loop(0, 27, visit, (zero,) * n_out)
            for o, a in zip(o_refs, acc):
                o[mine] = jnp.where(live_i, scale * a, 0.0)

    return body


def _planes(a, rows, kp, fill):
    """``[rows, K(, d)]`` -> list of ``d`` flat ``[rows * kp]`` planes."""
    a = a[:rows].astype(jnp.float32)
    if a.ndim == 2:
        a = a[..., None]
    k = a.shape[1]
    a = jnp.pad(a, ((0, 0), (0, kp - k), (0, 0)), constant_values=fill)
    return list(jnp.moveaxis(a, -1, 0).reshape(a.shape[-1], rows * kp))


def _sweep(name, terms, fields, n_out, mask, nbr, kp_scale, interpret):
    """Lay ``fields`` out as padded planes, run the kernel over every
    cell of ``nbr``, and return ``[n_cells, K, n_out]`` per-slot sums."""
    n_cells = nbr.shape[0]
    rows = n_cells + 1
    k = mask.shape[1]
    kp = padded_capacity(k)
    planes = []
    for arr, fill in fields + [(mask, 0.0)]:
        if arr.shape[0] < rows:
            raise ValueError(
                "dense fields need the sentinel row: %d rows for %d cells"
                % (arr.shape[0], n_cells)
            )
    for arr, fill in fields:
        planes += _planes(arr, rows, kp, fill)
    mask = mask[:rows]
    live = _planes(mask, rows, kp, 0.0)[0]
    # one past each cell's last live slot: chunks at or beyond it hold
    # no live particle (a prefix count would miss a gap in the mask)
    slots = jnp.arange(1, k + 1, dtype=jnp.int32)
    extent = jnp.max(jnp.where(mask, slots, 0), axis=1)
    nbr_flat = jnp.asarray(nbr, jnp.int32).reshape(-1)
    body = _sweep_kernel(terms, len(planes), n_out, kp, kp_scale)
    outs = pl.pallas_call(
        body,
        out_shape=[jax.ShapeDtypeStruct((n_cells * kp,), jnp.float32)] * n_out,
        grid=(n_cells, kp // min(kp, _OWN)),
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        name="sph_%s_k%d" % (name, kp),
    )(nbr_flat, extent, live, *planes)
    out = jnp.stack(outs, axis=-1).reshape(n_cells, kp, n_out)
    return out[:, :k]


def density(dense_x, mask, nbr, params, kernel=WendlandC2, mimage=None,
            interpret=False):
    """Per-slot summation density ``[n_cells, K]`` (as
    ``step._density_blocks``)."""
    terms = partial(
        _density_terms, params=params, kernel=kernel, mimage=mimage,
        ops=_exact(interpret),
    )
    out = _sweep(
        "density", terms, [(dense_x, 0.0)], 1, mask, nbr, params.mass,
        interpret,
    )
    return out[..., 0]


def accel(dense_x, dense_v, dense_rho, dense_p, mask, nbr, params,
          kernel=WendlandC2, mimage=None, interpret=False):
    """Per-slot pressure + viscosity acceleration ``[n_cells, K, 3]``
    (as ``step._accel_blocks``)."""
    terms = partial(
        _accel_terms, params=params, kernel=kernel, mimage=mimage,
        ops=_exact(interpret),
    )
    fields = [
        (dense_x, 0.0), (dense_v, 0.0), (dense_rho, params.rho0),
        (dense_p, 0.0),
    ]
    return _sweep("accel", terms, fields, 3, mask, nbr, 1.0, interpret)


def accel_drho(dense_x, dense_v, dense_rho, dense_p, mask, nbr, params,
               kernel=WendlandC2, delta_sph=0.1, mimage=None,
               interpret=False):
    """Fused momentum + continuity sweep ``[n_cells, K, 4]``, columns
    ``[acc_x, acc_y, acc_z, drho/dt]`` (as ``step._accel_drho_blocks``)."""
    terms = partial(
        _accel_drho_terms, params=params, kernel=kernel, mimage=mimage,
        ops=_exact(interpret), delta_sph=delta_sph,
    )
    fields = [
        (dense_x, 0.0), (dense_v, 0.0), (dense_rho, params.rho0),
        (dense_p, 0.0),
    ]
    return _sweep("accel_drho", terms, fields, 4, mask, nbr, 1.0, interpret)

