"""Fixed-capacity cell list for neighbor search.

No dynamic shapes under jit: the cell list is a dense
``[n_cells + 1, capacity]`` slot array built with one sort + gathers;
slot overflow drops particles from *neighbor interactions only* (they keep
integrating ballistically) and is reported via the returned overflow count
so callers can size ``capacity``.  Row ``n_cells`` is a zero sentinel: the
static 27-neighbor table points out-of-range neighbors at it, making
boundary cells branch-free.

Linear cell index is x-major (``c = ix*ny*nz + iy*nz + iz``) so sharding
the cell axis over devices yields contiguous x-slabs - halo traffic
between slabs is the SPH analogue of context-parallel halo exchange.
"""

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp


class CellGrid(NamedTuple):
    """Static cell-grid geometry (all fields trace-time constants)."""

    lo: tuple  # domain lower corner (3,)
    cell_size: float  # == interaction support radius (2h)
    dims: tuple  # (nx, ny, nz)
    capacity: int  # max particles per cell

    @property
    def n_cells(self):
        nx, ny, nz = self.dims
        return nx * ny * nz


def make_grid(lo, hi, support, capacity):
    """Build a CellGrid covering [lo, hi] with cells >= ``support`` wide."""
    lo = tuple(float(v) for v in lo)
    hi = tuple(float(v) for v in hi)
    dims = tuple(max(1, int(np.floor((h - l) / support))) for l, h in zip(lo, hi))
    # stretch cells slightly so the grid tiles the domain exactly
    cell_size = max((h - l) / d for l, h, d in zip(lo, hi, dims))
    return CellGrid(lo=lo, cell_size=float(cell_size), dims=dims, capacity=int(capacity))


def auto_capacity(x, lo, hi, support, headroom=1.5):
    """Occupancy-matched cell capacity for an initial configuration.

    Dense-slot waste is the single biggest SPH cost factor: pair math
    scales with ``capacity^2`` per cell, so a capacity 2x larger than
    the real occupancy costs ~4x the FLOPs.  This picks the smallest
    multiple of 8 >= ``headroom`` x the densest cell of ``x`` - WCSPH
    holds density within a few percent of rest, so 1.5x headroom covers
    transients; any residual overflow is counted (never silent) and
    only removes the dropped particle from neighbor sums for that step.

    The jnp pair path runs any capacity; the Triton kernels pad it to
    the next power of two (``tpgsd.sph.pair_kernel.padded_capacity``).
    """
    x = np.asarray(x)
    lo_a = np.asarray(lo, np.float64)
    dims = tuple(
        max(1, int(np.floor((h - l) / support))) for l, h in zip(lo, hi)
    )
    cell = max((h - l) / d for l, h, d in zip(lo, hi, dims))
    idx = np.clip(
        np.floor((x - lo_a) / cell).astype(np.int64), 0, np.asarray(dims) - 1
    )
    cid = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    m0 = int(np.bincount(cid, minlength=1).max())
    return max(8, int(-(-headroom * m0 // 8) * 8))


def neighbor_table(grid, periodic=False):
    """Static ``[n_cells, 27]`` int32 table of neighbor cell ids.

    Out-of-range neighbors point at the sentinel row ``n_cells``; with
    ``periodic=True`` they wrap around instead - on every axis with at
    least 3 cells (fewer would make a cell its own neighbor through
    the seam and double-count pairs; such axes stay non-periodic,
    which is exactly right for the collapsed-z 2-D layout).  A 3-tuple
    of bools selects axes explicitly (the slab-decomposed step wraps
    y/z locally but handles x through its ring halo).

    Returned as a host (numpy) array: it is a trace-time constant, and
    eager device placement would cost a host->device transfer at trace
    time for no benefit - embedded constants ship with the compiled
    executable.
    """
    nx, ny, nz = grid.dims
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    coords = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1)  # [C,3]
    offsets = np.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    )  # [27,3]
    nbr = coords[:, None, :] + offsets[None, :, :]  # [C,27,3]
    dims = np.array(grid.dims)
    if periodic is not False:
        if periodic is True:
            wrap = dims >= 3
        else:
            wrap = np.asarray(periodic, bool) & (dims >= 3)
        nbr = np.where(wrap, nbr % dims, nbr)
    valid = ((nbr >= 0) & (nbr < dims)).all(axis=2)
    lin = nbr[..., 0] * (ny * nz) + nbr[..., 1] * nz + nbr[..., 2]
    lin = np.where(valid, lin, grid.n_cells)  # sentinel
    return lin.astype(np.int32)


def cell_id(x, grid):
    """Linear (x-major) cell id of each position, clipped into the grid."""
    lo = jnp.asarray(grid.lo, dtype=x.dtype)
    dims = jnp.asarray(grid.dims, dtype=jnp.int32)
    idx3 = jnp.floor((x - lo) / grid.cell_size).astype(jnp.int32)
    idx3 = jnp.clip(idx3, 0, dims - 1)
    _, ny, nz = grid.dims
    return idx3[:, 0] * (ny * nz) + idx3[:, 1] * nz + idx3[:, 2]


class CellList(NamedTuple):
    """Dense cell decomposition of one particle set.

    ``order`` sorts particles by cell; ``cid``/``slot`` are each sorted
    particle's dense coordinates; ``gidx`` is the dense gather map INTO
    THE SORTED ORDER (sorted position occupying each slot, N for empty
    slots - elementwise from the cell starts, no gather to build);
    ``mask`` marks live slots; ``overflow`` counts particles dropped
    from neighbor sums (capacity exceeded).
    """

    order: jax.Array  # [N] permutation: particle index in sorted order
    cid: jax.Array  # [N] cell id per sorted particle
    slot: jax.Array  # [N] slot per sorted particle (== capacity if dropped)
    gidx: jax.Array  # [n_cells+1, capacity] int32 sorted-order gather map
    mask: jax.Array  # [n_cells+1, capacity] bool
    overflow: jax.Array  # [] int32
    starts: jax.Array  # [n_cells] int32 first sorted position of each cell



def _sorted_slot_map(cid, n_query, capacity, live_rows=None):
    """Shared scatter-free slot assignment (single-device AND slab
    paths): sort by cell id, locate each cell's first sorted position
    by vectorized binary search, and build the elementwise sorted-order
    gather map.

    Args:
        cid: ``[n]`` cell id per particle, values in ``[0, n_query)``.
        n_query: number of cells to map (may include sentinel cells).
        capacity: slots per cell.
        live_rows: optional count of leading rows eligible for live
            slots (rows past it - sentinel cells - map to empty).

    Returns:
        ``(order, cid_s, valid, gidx, slot, starts)`` where
        ``gidx[q, k]`` is the sorted position filling slot ``(q, k)``
        (``n`` = empty), ``slot`` is each SORTED particle's slot within
        its cell (unclamped - callers apply their own overflow rule),
        and ``starts[q]`` is cell q's first sorted position.
    """
    n = cid.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    # two-operand sort returns the sorted keys AND the permutation in one
    # pass, with no separate `cid[order]` gather
    cid_s, order = jax.lax.sort((cid, iota), num_keys=1)
    # method="sort" lowers to one extra O(n+C) sort; the default binary
    # search lowers to a log2(n)-iteration while loop of thin gathers
    starts = jnp.searchsorted(
        cid_s, jnp.arange(n_query, dtype=cid_s.dtype), method="sort"
    ).astype(jnp.int32)
    counts = jnp.diff(jnp.concatenate([starts, jnp.full((1,), n, jnp.int32)]))
    kslots = jnp.arange(capacity, dtype=jnp.int32)
    valid = kslots[None, :] < jnp.minimum(counts, capacity)[:, None]
    if live_rows is not None and live_rows < n_query:
        valid = valid & (jnp.arange(n_query) < live_rows)[:, None]
    gidx = jnp.where(valid, starts[:, None] + kslots[None, :], n)
    # slot = position within the cell's sorted run; the run start comes
    # from a cummax over boundary positions (associative scan) instead
    # of the thin `starts[cid_s]` gather
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), cid_s[1:] != cid_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(boundary, iota, 0))
    slot = iota - run_start
    return order, cid_s, valid, gidx, slot, starts


@partial(jax.jit, static_argnums=1)
def build_cells(x, grid):
    """Assign particles to cells, scatter-free: one sort, one binary
    search, then pure gathers.

    The dense layout is a GATHER: slot (cell, j) reads sorted position
    ``starts[cell] + j``, and the ``gidx`` map encoding that is pure
    elementwise arithmetic - no scatter, no extra ``[c, K]`` index
    gather.

    Returns a :class:`CellList`; use :func:`scatter_to_cells` to lay
    per-particle quantities out densely and :func:`gather_from_cells` to
    bring per-slot results back to particle order.
    """
    n = x.shape[0]
    c = grid.n_cells
    k = grid.capacity
    cid = cell_id(x, grid)
    order, cid_s, valid, gidx, slot, starts = _sorted_slot_map(cid, c, k)
    gidx = jnp.concatenate([gidx, jnp.full((1, k), n, jnp.int32)])
    mask = jnp.concatenate([valid, jnp.zeros((1, k), bool)])

    # per-sorted-particle coordinates (the gather_from_cells inverse map)
    dropped = slot >= k
    slot = jnp.where(dropped, k, slot)  # out-of-bounds -> dropped
    return CellList(
        order=order,
        cid=cid_s,
        slot=slot,
        gidx=gidx,
        mask=mask,
        overflow=dropped.sum().astype(jnp.int32),
        starts=starts,
    )


def scatter_to_cells(values, cells, grid, fill=0.0):
    """Lay per-particle ``values`` (particle order) out in the dense
    ``[n_cells+1, capacity, ...]`` layout (sentinel row stays ``fill``).

    Despite the name this is gathers, not scatters: one N-row gather
    into sorted order, then one dense gather through the elementwise
    ``cells.gidx`` map (see :func:`build_cells`)."""
    trailing = values.shape[1:]
    pad = jnp.full((1,) + trailing, fill, values.dtype)
    vs = jnp.concatenate([values[cells.order], pad])
    return vs[cells.gidx]


def gather_from_cells(dense, cells, grid):
    """Gather per-slot ``dense`` values back to particle order.

    Dropped (overflow) particles read the sentinel row.
    """
    kc = grid.capacity
    slot = jnp.minimum(cells.slot, kc - 1)
    cid = jnp.where(cells.slot >= kc, grid.n_cells, cells.cid)
    sorted_vals = dense[cid, slot]
    # inverse permutation by sorting the permutation instead of the
    # scatter `zeros.at[order].set(iota)`
    inv = jnp.argsort(cells.order)
    return sorted_vals[inv]
