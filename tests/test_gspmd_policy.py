"""Sharding-aware resolution of the pair-sweep policy.

A ``pallas_call`` is a custom call that GSPMD cannot partition, so
``make_step_fn(..., sharding=...)`` pins the jnp pair path whenever the
step will run under GSPMD-partitioned inputs - REGARDLESS of backend,
so the configuration validated on the virtual CPU mesh here is the same
one a multi-GPU mesh resolves.  The kernels on a mesh run inside
``shard_map`` in the decomposed steps (``tests/test_distributed*.py``).

The parallel path being first-class is the reference's whole point
(reference: pgsd/pgsd/pgsd.c:1121-1152); these tests pin that tpgsd's
default is valid there, not just on one device.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import tpgsd.sph.step as step_mod
from tpgsd.parallel import make_mesh
from tpgsd.sph import (
    SPHState,
    dam_break,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
)


@pytest.fixture
def fake_gpu(monkeypatch):
    """Pretend the backend is a GPU so the auto policy faces the real
    decision (on the CPU test backend it resolves off trivially)."""
    monkeypatch.setattr(step_mod.jax, "default_backend", lambda: "gpu")


def _db():
    return dam_break(n_side=6, capacity="auto")


def test_auto_resolves_champion_on_single_device(fake_gpu):
    """No sharding hint + GPU backend = the Triton pair kernels, in both
    density formulations."""
    db = _db()
    step = make_step_fn(db.grid, db.params)
    assert step.resolved == {
        "use_pallas": True,
        "density_mode": "summation",
        "gspmd": False,
    }
    step_c = make_step_fn(db.grid, db.params, density_mode="continuity")
    assert step_c.resolved["use_pallas"] is True


@pytest.mark.parametrize("hint", ["mesh", "named_sharding", "int"])
def test_auto_resolves_jnp_under_gspmd(fake_gpu, hint):
    """A multi-device hint pins the GSPMD-partitionable jnp path even
    on a GPU backend, where a pallas_call under GSPMD cannot be
    partitioned."""
    db = _db()
    mesh = make_mesh(n_devices=8)
    sharding = {
        "mesh": mesh,
        "named_sharding": NamedSharding(mesh, P("shard")),
        "int": 8,
    }[hint]
    for mode in ("summation", "continuity"):
        step = make_step_fn(
            db.grid, db.params, density_mode=mode, sharding=sharding
        )
        assert step.resolved == {
            "use_pallas": False,
            "density_mode": mode,
            "gspmd": True,
        }


def test_single_device_hint_keeps_champion(fake_gpu):
    """A 1-device hint (or None) is not GSPMD - the kernels stay on."""
    db = _db()
    for sharding in (None, 1):
        step = make_step_fn(db.grid, db.params, sharding=sharding)
        assert step.resolved["use_pallas"] is True
        assert step.resolved["gspmd"] is False


def test_explicit_pallas_under_gspmd_raises(fake_gpu):
    """Explicit use_pallas=True + a multi-device hint must fail at BUILD
    time with guidance, not at XLA lowering time."""
    db = _db()
    with pytest.raises(ValueError, match="shard_map"):
        make_step_fn(db.grid, db.params, use_pallas=True, sharding=8)
    with pytest.raises(ValueError, match="make_distributed_step_fn"):
        make_step_fn(db.grid, db.params, use_pallas=True, sharding=8)


def test_bad_hint_type_raises():
    db = _db()
    with pytest.raises(TypeError, match="sharding hint"):
        make_step_fn(db.grid, db.params, sharding="8 devices")


def test_adaptive_forwards_resolved(fake_gpu):
    db = _db()
    step = make_adaptive_step_fn(db.grid, db.params, sharding=8)
    assert step.resolved["gspmd"] is True
    assert step.resolved["use_pallas"] is False


def _pad_to(db, n_dev):
    n = db.n
    pad = (-n) % n_dev
    x = jnp.pad(db.state.x, ((0, pad), (0, 0)))
    x = x.at[n:].set(jnp.asarray(db.box, jnp.float32) * 0.999)
    v = jnp.pad(db.state.v, ((0, pad), (0, 0)))
    return x, v, pad


def test_hinted_step_runs_sharded_with_parity():
    """The hinted auto step executes under GSPMD-sharded inputs and
    reproduces the single-device physics (the dryrun contract, pinned
    in the suite)."""
    db = dam_break(n_side=4, capacity=32)
    mesh = make_mesh(n_devices=8)
    sharding = NamedSharding(mesh, P("shard"))
    x, v, _pad = _pad_to(db, 8)

    step_fn = make_step_fn(db.grid, db.params, sharding=sharding)
    assert step_fn.resolved["gspmd"] is True
    step = jax.jit(
        step_fn,
        in_shardings=(SPHState(x=sharding, v=sharding),),
        out_shardings=(
            SPHState(x=sharding, v=sharding),
            (sharding, sharding, None),
        ),
    )
    state = SPHState(
        x=jax.device_put(x, sharding), v=jax.device_put(v, sharding)
    )
    state, (rho, _p, _o) = step(state)
    s1, (rho1, _p1, _o1) = jax.jit(make_step_fn(db.grid, db.params))(
        SPHState(x=x, v=v)
    )
    numpy.testing.assert_allclose(
        numpy.asarray(state.x), numpy.asarray(s1.x), rtol=1e-5, atol=1e-6
    )
    numpy.testing.assert_allclose(
        numpy.asarray(rho), numpy.asarray(rho1), rtol=1e-4, atol=1e-2
    )


def test_hinted_continuity_runs_sharded_with_parity():
    """Continuity mode under GSPMD: rho rides the sharded state (the
    demo's --sharded --density-mode continuity path, previously
    refused)."""
    db = dam_break(n_side=4, capacity=32)
    mesh = make_mesh(n_devices=8)
    sharding = NamedSharding(mesh, P("shard"))
    x, v, pad = _pad_to(db, 8)
    st = init_density(SPHState(x=x, v=v), db.grid, db.params)
    # padded corner rows carry rest density (isolated -> floor anyway)
    rho0 = st.rho if pad == 0 else st.rho.at[db.n :].set(db.params.rho0)
    st = st._replace(rho=rho0)

    step_fn = make_step_fn(
        db.grid, db.params, density_mode="continuity", sharding=sharding
    )
    st_sh = SPHState(x=sharding, v=sharding, rho=sharding)
    step = jax.jit(
        step_fn,
        in_shardings=(st_sh,),
        out_shardings=(st_sh, (sharding, sharding, None)),
    )
    dist = SPHState(
        x=jax.device_put(st.x, sharding),
        v=jax.device_put(st.v, sharding),
        rho=jax.device_put(st.rho, sharding),
    )
    dist, (rho, _p, _o) = step(dist)
    s1, (rho1, _p1, _o1) = jax.jit(
        make_step_fn(db.grid, db.params, density_mode="continuity")
    )(st)
    numpy.testing.assert_allclose(
        numpy.asarray(dist.x), numpy.asarray(s1.x), rtol=1e-5, atol=1e-6
    )
    numpy.testing.assert_allclose(
        numpy.asarray(rho), numpy.asarray(rho1), rtol=1e-4, atol=1e-2
    )
