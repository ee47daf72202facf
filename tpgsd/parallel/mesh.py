"""Device-mesh helpers for particle-axis sharding.

The reference's parallel axis is the particle row partition
(reference: pgsd/scripts/benchmark-write.cc:30-45 uneven row split).  Here
that is a 1-D mesh axis named ``"shard"``; arrays carry a
``NamedSharding`` partitioned on axis 0.
"""

import numpy as np


def make_mesh(n_devices=None, axis_name="shard", devices=None):
    """A 1-D :class:`jax.sharding.Mesh` over ``n_devices`` devices.

    Raises when fewer than ``n_devices`` are available - a silently
    smaller mesh would change every downstream sharding decision
    (e.g. ``make_step_fn``'s GSPMD-aware auto policies).
    """
    import jax
    from jax.sharding import Mesh

    if devices is None:
        avail = jax.devices()
        if n_devices is not None and len(avail) < n_devices:
            raise ValueError(
                "make_mesh(n_devices=%d): only %d device(s) available "
                "(force a virtual CPU mesh with "
                "jax.config.update('jax_platforms', 'cpu'); "
                "jax.config.update('jax_num_cpu_devices', %d))"
                % (n_devices, len(avail), n_devices)
            )
        devices = avail[: n_devices or len(avail)]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh2d(shape=None, axis_names=("sx", "sy"), devices=None):
    """A 2-D :class:`jax.sharding.Mesh` for block-decomposed domains.

    ``shape`` defaults to the most-square factorization of the device
    count (8 devices -> ``(4, 2)``).
    """
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    if shape is None:
        n = len(devices)
        px = int(np.sqrt(n))
        while n % px != 0:
            px -= 1
        shape = (max(px, n // px), min(px, n // px))
    px, py = shape
    return Mesh(np.asarray(devices[: px * py]).reshape(px, py), tuple(axis_names))


def make_mesh3d(shape=None, axis_names=("sx", "sy", "sz"), devices=None):
    """A 3-D :class:`jax.sharding.Mesh` for block-decomposed domains.

    ``shape`` defaults to the most-cubic factorization of the device
    count (8 devices -> ``(2, 2, 2)``).
    """
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    if shape is None:
        n = len(devices)
        px = max(d for d in range(1, int(round(n ** (1 / 3))) + 1) if n % d == 0)
        rem = n // px
        py = int(np.sqrt(rem))
        while rem % py != 0:
            py -= 1
        dims = sorted((px, max(py, rem // py), min(py, rem // py)),
                      reverse=True)
        shape = tuple(dims)
    px, py, pz = shape
    return Mesh(
        np.asarray(devices[: px * py * pz]).reshape(px, py, pz),
        tuple(axis_names),
    )


def row_sharding(mesh, axis_name="shard"):
    """NamedSharding that partitions axis 0 over ``axis_name``."""
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec(axis_name))


def pad_rows(array, n_shards):
    """Zero-pad axis 0 up to a multiple of ``n_shards``.

    Returns ``(padded, n_valid)``.  XLA shardings must divide evenly; the
    reference instead spreads uneven remainders over low ranks
    (reference: pgsd/scripts/benchmark-write.cc:33-37) - under XLA the
    idiomatic equivalent is pad+mask with the true count carried alongside
    (the writer's ``n_rows`` argument strips the padding on disk).
    """
    import jax.numpy as jnp

    n = array.shape[0]
    rem = (-n) % n_shards
    if rem == 0:
        return array, n
    pad_widths = [(0, rem)] + [(0, 0)] * (array.ndim - 1)
    return jnp.pad(array, pad_widths), n


def shard_rows(array, mesh=None, axis_name="shard"):
    """Place ``array`` with axis 0 partitioned over the mesh.

    The sharded equivalent of the reference's per-rank row partition
    (reference: pgsd/scripts/benchmark-write.cc:30-45).  Uneven row counts
    are zero-padded to the mesh size; pass the true count as ``n_rows``
    when writing so the padding never reaches the file.
    """
    import jax

    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    n_shards = mesh.devices.size
    padded, _ = pad_rows(array, n_shards)
    return jax.device_put(padded, row_sharding(mesh, axis_name))
