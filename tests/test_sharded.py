"""Multi-shard write/read tests on a virtual 8-device CPU mesh.

The automated multi-shard coverage the reference never had (its only
multi-rank exercisers are manual mpirun benchmarks;
reference: CHANGELOG.md:172-194).
"""

import numpy
import numpy.testing
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tpgsd.fl  # noqa: E402
import tpgsd.hoomd  # noqa: E402
import tpgsd.pypgsd  # noqa: E402
from tpgsd.parallel import (  # noqa: E402
    ShardedFrameWriter,
    array_shards,
    make_mesh,
    read_sharded_chunk,
    write_sharded_chunk,
)
from tpgsd.parallel.mesh import row_sharding, shard_rows  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests need the 8-device CPU mesh"
    return make_mesh()


def test_array_shards_even(mesh):
    x = shard_rows(jnp.arange(64 * 3, dtype=jnp.float32).reshape(64, 3), mesh)
    shards, shape = array_shards(x)
    assert shape == (64, 3)
    assert [s[0] for s in shards] == [0, 8, 16, 24, 32, 40, 48, 56]
    recon = numpy.concatenate([a for _, a in shards])
    numpy.testing.assert_array_equal(recon, numpy.asarray(x))


def test_array_shards_uneven(tmp_path, mesh):
    """Uneven row counts: pad+mask with the true count (the reference
    instead spreads remainders over low ranks; under XLA padding is the
    idiomatic equivalent)."""
    full = numpy.arange(61 * 2, dtype=numpy.float32).reshape(61, 2)
    x = shard_rows(jnp.asarray(full), mesh)  # pads to 64 rows
    assert x.shape == (64, 2)

    fname = tmp_path / "uneven.gsd"
    with tpgsd.fl.open(
        name=fname, mode="w", application="t", schema="none", schema_version=[1, 0]
    ) as f:
        write_sharded_chunk(f, "d", x, n_rows=61)
        f.end_frame()

    # padding never reaches the file
    with tpgsd.pypgsd.PGSDFile(open(str(fname), "rb")) as f:
        got = f.read_chunk(0, "d")
        assert got.shape == (61, 2)
        numpy.testing.assert_array_equal(got, full)

    # sharded read of the uneven chunk pads the trailing shard back
    with tpgsd.fl.open(name=fname, mode="r") as f:
        sharding = row_sharding(mesh)
        with pytest.raises(ValueError):
            read_sharded_chunk(f, 0, "d", sharding)
        out = read_sharded_chunk(f, 0, "d", sharding, pad=True)
        assert out.shape == (64, 2)
        numpy.testing.assert_array_equal(numpy.asarray(out)[:61], full)
        numpy.testing.assert_array_equal(
            numpy.asarray(out)[61:], numpy.zeros((3, 2), numpy.float32)
        )


def test_array_shards_replicated(mesh):
    """Fully replicated arrays write exactly one copy."""
    from jax.sharding import NamedSharding, PartitionSpec

    x = jax.device_put(
        jnp.ones((16, 3), jnp.float32), NamedSharding(mesh, PartitionSpec())
    )
    shards, shape = array_shards(x)
    assert len(shards) == 1
    assert shards[0][0] == 0
    assert shards[0][1].shape == (16, 3)


def test_write_read_roundtrip_sharded(tmp_path, mesh):
    """8-shard parallel write -> read back into a sharded jax.Array."""
    fname = tmp_path / "sharded.gsd"
    n = 1024
    pos = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    vel = -pos
    pos_s = shard_rows(pos, mesh)
    vel_s = shard_rows(vel, mesh)

    with tpgsd.fl.open(
        name=fname, mode="w", application="t", schema="hoomd", schema_version=[1, 4]
    ) as f:
        write_sharded_chunk(f, "particles/position", pos_s)
        write_sharded_chunk(f, "particles/velocity", vel_s)
        f.end_frame()

    # plain full read matches
    with tpgsd.pypgsd.PGSDFile(open(str(fname), "rb")) as f:
        numpy.testing.assert_array_equal(
            f.read_chunk(0, "particles/position"), numpy.asarray(pos)
        )

    # sharded zero-gather read matches and carries the right sharding
    with tpgsd.fl.open(name=fname, mode="r") as f:
        sharding = row_sharding(mesh)
        out = read_sharded_chunk(f, 0, "particles/position", sharding)
        assert out.sharding == sharding
        numpy.testing.assert_array_equal(numpy.asarray(out), numpy.asarray(pos))


def test_sharded_1d_and_int_chunks(tmp_path, mesh):
    fname = tmp_path / "sharded1d.gsd"
    n = 640
    density = jnp.linspace(0.0, 1.0, n)
    typeid = jnp.arange(n, dtype=jnp.uint32)
    with tpgsd.fl.open(
        name=fname, mode="w", application="t", schema="none", schema_version=[1, 0]
    ) as f:
        write_sharded_chunk(f, "density", shard_rows(density, mesh))
        write_sharded_chunk(f, "typeid", shard_rows(typeid, mesh))
        f.end_frame()

    with tpgsd.pypgsd.PGSDFile(open(str(fname), "rb")) as f:
        numpy.testing.assert_allclose(
            f.read_chunk(0, "density"), numpy.asarray(density), rtol=1e-6
        )
        got = f.read_chunk(0, "typeid")
        assert got.dtype == numpy.uint32
        numpy.testing.assert_array_equal(got, numpy.asarray(typeid))

    with tpgsd.fl.open(name=fname, mode="r") as f:
        sharding = row_sharding(mesh)
        out = read_sharded_chunk(f, 0, "density", sharding)
        assert out.shape == (n,)
        numpy.testing.assert_allclose(numpy.asarray(out), numpy.asarray(density), rtol=1e-6)


def test_sharded_frame_writer(tmp_path, mesh):
    """The production dump loop: static chunks + per-frame device arrays."""
    fname = tmp_path / "dump.gsd"
    n = 512
    box = numpy.array([10, 10, 10, 0, 0, 0], dtype=numpy.float32)

    with ShardedFrameWriter(fname, static={"configuration/box": box}) as w:
        for step in range(5):
            x = shard_rows(
                jnp.full((n, 3), float(step), dtype=jnp.float32), mesh
            )
            rho = shard_rows(jnp.full((n,), 1000.0 + step, jnp.float32), mesh)
            w.write_frame(
                {"particles/position": x, "particles/density": rho}, step=step
            )

    # the hoomd schema layer reads the dump like any other trajectory
    with tpgsd.hoomd.open(fname, mode="r") as traj:
        assert len(traj) == 5
        s = traj[3]
        assert s.configuration.step == 3
        assert s.particles.N == n
        numpy.testing.assert_array_equal(s.configuration.box, box)
        numpy.testing.assert_array_equal(
            s.particles.position, numpy.full((n, 3), 3.0, numpy.float32)
        )
        numpy.testing.assert_array_equal(
            s.particles.density, numpy.full(n, 1003.0, numpy.float32)
        )

    # and the pure-Python reader agrees
    with tpgsd.pypgsd.PGSDFile(open(str(fname), "rb")) as f:
        assert f.nframes == 5
        numpy.testing.assert_array_equal(
            f.read_chunk(4, "particles/density"),
            numpy.full(n, 1004.0, numpy.float32),
        )


def test_bfloat16_upcast(tmp_path, mesh):
    """bfloat16 has no GSD type code -> upcast to float32 on write."""
    fname = tmp_path / "bf16.gsd"
    x = shard_rows(jnp.ones((64, 3), jnp.bfloat16), mesh)
    with tpgsd.fl.open(
        name=fname, mode="w", application="t", schema="none", schema_version=[1, 0]
    ) as f:
        write_sharded_chunk(f, "x", x)
        f.end_frame()
    with tpgsd.pypgsd.PGSDFile(open(str(fname), "rb")) as f:
        got = f.read_chunk(0, "x")
        assert got.dtype == numpy.float32
        numpy.testing.assert_array_equal(got, numpy.ones((64, 3), numpy.float32))
