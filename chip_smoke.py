#!/usr/bin/env python3
"""Smoke test of the main path on a GPU: the quickest proof that the
system still starts on the card.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, in order (each phase prints one line; any failure ends the
run with a non-zero exit code):

* ``device``    - JAX must find a GPU; prints its kind and the card's
  name and power limit from ``nvidia-smi``.
* ``step``      - the ~1e6-particle dam break (``dam_break(n_side=86)``)
  through ``make_step_fn``'s default policy, 20 steps in each density
  mode: finite state, no cell overflow; ms/step as information.
* ``reference`` - the jnp step on the GPU against the same step on the
  CPU backend of this process at ~1e5 particles.
* ``kernel``    - each compiled Triton sweep against the jnp blocks at
  1e6 particles, with walls and periodic.
* ``dump``      - 40 steps with ``AsyncDumpRunner(ShardedFrameWriter)``
  dumps every 5; read back by ``tpgsd.hoomd``, the vendored reference
  reader and ``read_sharded_chunk``; ``tpgsd.pypgsd.verify``.
* ``slab``      - ``make_slab_step_fn(n_slabs=4)`` with a
  ``SlabDumpChannel``: the assembled frame equals the step's state.

``--four`` runs the GSPMD-sharded step, the slab decomposition and the
(2, 2) block decomposition against the one-card step, and a sharded
dump against a one-device dump of the same state.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, ".scratch", "chip_smoke")

#: ~1.0e6 particles: the BASELINE.json config-4 dam break
N_SIDE = 86
#: ~1.0e5 particles for the GPU-vs-CPU reference
N_SIDE_REF = 40

#: GPU vs CPU jnp step, max |diff| / max |ref| of x, v and rho after 3
#: steps.  Both run the same float32 jnp program; XLA:GPU reassociates
#: the 27K-term neighbour sums and contracts multiply-adds differently
#: from XLA:CPU, a few float32 roundoffs of the largest term per step.
REF_TOL = 1e-4

#: compiled kernel vs jnp blocks, max |diff| / max |ref| per sweep: the
#: kernel sums neighbour cells chunk by chunk, XLA in one reduction
#: (measured <= 7e-7 on the H100)
KERNEL_TOL = 1e-5

#: four-card paths vs the one-card step after 3 steps, as REF_TOL: the
#: GSPMD step runs the jnp blocks and the one-card step the kernels,
#: and the halo/migration paths sum in another order
FOUR_TOL = 1e-4

DUMP_KEYS = ("position", "velocity", "density", "pressure", "slength")


def say(phase, msg):
    print("phase %s: %s" % (phase, msg), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return "; ".join(line.strip() for line in out.splitlines())


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def padded_grid(grid, multiples):
    """The grid with each axis extended (upwards) to a multiple of the
    mesh extent along it - a decomposed step needs whole cell planes
    per device, and the dam break has 82 x 41 x 41 cells."""
    dims = tuple(-(-d // m) * m for d, m in zip(grid.dims, multiples))
    return grid._replace(dims=dims)


def fresh_state(db, mode):
    import jax.numpy as jnp

    from tpgsd.sph import SPHState, init_density

    state = SPHState(x=jnp.asarray(db.state.x), v=jnp.asarray(db.state.v))
    if mode == "continuity":
        state = init_density(state, db.grid, db.params)
    return state


def phase_step(card):
    import jax

    from tpgsd.sph import dam_break, make_step_fn

    db = dam_break(n_side=N_SIDE, capacity="auto")
    dev = jax.devices()[0]
    for mode in ("summation", "continuity"):
        fn = make_step_fn(db.grid, db.params, density_mode=mode)
        if not fn.resolved["use_pallas"]:
            raise AssertionError("auto policy did not pick the kernels")
        step = jax.jit(fn)
        state = fresh_state(db, mode)
        state, aux = step(state)
        jax.block_until_ready(state)
        times, overflow = [], 0
        for _ in range(20):
            t0 = time.perf_counter()
            state, (rho, p, ovf) = step(state)
            jax.block_until_ready(state)
            times.append(time.perf_counter() - t0)
            overflow = max(overflow, int(ovf))
        for name, a in (("x", state.x), ("v", state.v), ("rho", rho)):
            if not bool(np.isfinite(np.asarray(a)).all()):
                raise AssertionError("%s %s is not finite" % (mode, name))
        if overflow:
            raise AssertionError("%s cell overflow %d" % (mode, overflow))
        ms = float(np.median(times)) * 1e3
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        say("step", "%s n=%d K=%d triton kernels: %.3f ms/step (median "
            "of 20), %.4g particle-steps/s, peak %.2f GiB [%s]"
            % (mode, db.n, db.grid.capacity, ms, db.n / ms * 1e3,
               peak / 2**30, card))


def phase_reference():
    import jax

    from tpgsd.sph import SPHState, dam_break, init_density, make_step_fn

    db = dam_break(n_side=N_SIDE_REF, capacity="auto")
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    errs = {}
    for mode in ("summation", "continuity"):
        step = jax.jit(make_step_fn(db.grid, db.params, use_pallas=False,
                                    density_mode=mode))

        def run(device):
            state = SPHState(x=jax.device_put(db.state.x, device),
                             v=jax.device_put(db.state.v, device))
            if mode == "continuity":
                state = init_density(state, db.grid, db.params)
            for _ in range(3):
                state, aux = step(state)
            return [np.asarray(a) for a in (state.x, state.v, aux[0])]

        g, c = run(gpu), run(cpu)
        errs[mode] = [rel_err(a, b) for a, b in zip(g, c)]
        if max(errs[mode]) > REF_TOL:
            raise AssertionError("%s GPU vs CPU %r > %g"
                                 % (mode, errs[mode], REF_TOL))
    say("reference", "n=%d, 3 jnp steps GPU vs CPU, max|diff|/max|ref| "
        "(x, v, rho): summation %s, continuity %s (tol %g)"
        % (db.n, ["%.2e" % e for e in errs["summation"]],
           ["%.2e" % e for e in errs["continuity"]], REF_TOL))


def sweep_inputs(x, v, grid, params, periodic=False):
    """``((dense_x, dense_v, rho, p, mask), nbr, mimage)``: the three
    sweeps' inputs for one state, laid out on ``grid`` with the jnp
    density and the step's floor, sentinel row and Tait pressure."""
    import jax
    import jax.numpy as jnp

    from tpgsd.sph.cells import build_cells, neighbor_table, scatter_to_cells
    from tpgsd.sph.kernels import WendlandC2
    from tpgsd.sph.step import _mimage_of, pair_sweeps, tait_pressure

    nbr = neighbor_table(grid, periodic=periodic)
    mimage = _mimage_of(grid, periodic)

    @jax.jit
    def layout(x, v):
        cells = build_cells(x, grid)
        dx = scatter_to_cells(x, cells, grid)
        dv = scatter_to_cells(v, cells, grid)
        m = cells.mask
        rho = pair_sweeps(False).density(dx, m, nbr, params, WendlandC2,
                                         mimage=mimage)
        rho = jnp.concatenate(
            [rho, jnp.full((1, grid.capacity), params.rho0, rho.dtype)])
        rho = jnp.where(m, jnp.maximum(rho, 0.1 * params.rho0), params.rho0)
        p = jnp.where(m, tait_pressure(rho, params), 0.0)
        return dx, dv, rho, p, m

    return layout(x, v), nbr, mimage


def sweep_fns(use_pallas, nbr, params, mimage, delta_sph=0.1,
              interpret=False):
    """``{"density", "accel", "accel_drho"}``: one path's sweeps, each
    jitted over the arrays of :func:`sweep_inputs`."""
    import jax

    from tpgsd.sph.kernels import WendlandC2
    from tpgsd.sph.step import pair_sweeps

    sw = pair_sweeps(use_pallas, interpret=interpret)
    kw = dict(mimage=mimage)
    return {
        "density": jax.jit(lambda dx, dv, rho, p, m: sw.density(
            dx, m, nbr, params, WendlandC2, **kw)),
        "accel": jax.jit(lambda dx, dv, rho, p, m: sw.accel(
            dx, dv, rho, p, m, nbr, params, WendlandC2, **kw)),
        "accel_drho": jax.jit(lambda dx, dv, rho, p, m: sw.accel_drho(
            dx, dv, rho, p, m, nbr, params, WendlandC2, delta_sph, **kw)),
    }


def sweep_parity(x, v, grid, params, periodic=False, delta_sph=0.1,
                 interpret=False):
    """Deviation of each Triton sweep from the jnp blocks on one state.

    Returns ``{"density": e, "accel": e, "accel_drho_acc": e,
    "accel_drho_drho": e}``: the largest absolute difference relative
    to the largest magnitude of the jnp result (the acceleration as one
    group of three columns).  The kernel sums in another order, so the
    deviation is a few float32 roundoffs of the largest term, not zero.
    """
    args, nbr, mimage = sweep_inputs(x, v, grid, params, periodic)
    a, b = ({k: np.asarray(f(*args)) for k, f in sweep_fns(
        use, nbr, params, mimage, delta_sph, interpret=interpret).items()}
        for use in (False, True))
    if not all(np.isfinite(t).all() for t in b.values()):
        raise FloatingPointError("a kernel sweep returned a non-finite value")
    return {
        "density": rel_err(b["density"], a["density"]),
        "accel": rel_err(b["accel"], a["accel"]),
        "accel_drho_acc": rel_err(b["accel_drho"][..., :3],
                                  a["accel_drho"][..., :3]),
        "accel_drho_drho": rel_err(b["accel_drho"][..., 3],
                                   a["accel_drho"][..., 3]),
    }


def phase_kernel():
    import jax.numpy as jnp

    from tpgsd.sph import dam_break

    db = dam_break(n_side=N_SIDE, capacity="auto")
    x = jnp.asarray(db.state.x)
    v = jnp.asarray(np.random.default_rng(0).normal(
        scale=0.1, size=db.state.x.shape).astype(np.float32))
    parts = []
    for periodic in (False, True):
        errs = sweep_parity(x, v, db.grid, db.params, periodic=periodic)
        if max(errs.values()) > KERNEL_TOL:
            raise AssertionError("periodic=%s %r" % (periodic, errs))
        parts.append("%s %s" % (
            "periodic" if periodic else "walls",
            " ".join("%s=%.2e" % kv for kv in sorted(errs.items()))))
    say("kernel", "n=%d K=%d compiled vs jnp: %s (tol %g)"
        % (db.n, db.grid.capacity, "; ".join(parts), KERNEL_TOL))


def load_oracle():
    path = os.path.join(REPO, "tests", "oracle", "vendored_pypgsd.py")
    spec = importlib.util.spec_from_file_location("vendored_pypgsd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_dump():
    import jax
    import jax.numpy as jnp
    from jax.sharding import SingleDeviceSharding

    import tpgsd.fl
    import tpgsd.hoomd
    import tpgsd.pypgsd
    from tpgsd.io_runtime import AsyncDumpRunner
    from tpgsd.parallel import ShardedFrameWriter
    from tpgsd.parallel.shard_io import read_sharded_chunk
    from tpgsd.sph import dam_break, make_step_fn

    db = dam_break(n_side=N_SIDE, capacity="auto")
    step = jax.jit(make_step_fn(db.grid, db.params))
    path = os.path.join(SCRATCH, "dump.gsd")
    box = np.array(list(db.box) + [0, 0, 0], np.float32)
    writer = ShardedFrameWriter(path, static={
        "configuration/box": box,
        "particles/N": np.array([db.n], np.uint32),
    })
    state = fresh_state(db, "summation")
    slength = jnp.full(db.n, db.params.h, jnp.float32)
    last = None
    with AsyncDumpRunner(writer) as dump:
        for i in range(40):
            state, (rho, p, _ovf) = step(state)
            if i % 5 == 0:
                frame = {
                    "particles/position": state.x,
                    "particles/velocity": state.v,
                    "particles/density": rho,
                    "particles/pressure": p,
                    "particles/slength": slength,
                }
                dump.submit(frame, step=i)
                last = (i, frame)
        dump.flush()
    stats = dump.stats
    step_i, frame = last
    host = {k: np.asarray(a) for k, a in frame.items()}

    with tpgsd.hoomd.open(path, mode="r") as traj:
        if len(traj) != 8:
            raise AssertionError("hoomd reader sees %d frames" % len(traj))
        snap = traj[-1]
        if snap.configuration.step != step_i:
            raise AssertionError("last step %r" % snap.configuration.step)
        for key in DUMP_KEYS:
            got = getattr(snap.particles, key)
            if not np.array_equal(got, host["particles/" + key]):
                raise AssertionError("hoomd %s differs" % key)
    oracle = load_oracle()
    with open(path, "rb") as fh:
        ref = oracle.PGSDFile(fh)
        if ref.nframes != 8:
            raise AssertionError("reference reader sees %d" % ref.nframes)
        for key in DUMP_KEYS:
            got = ref.read_chunk(7, "particles/" + key)
            want = host["particles/" + key]
            if got.tobytes() != want.tobytes():
                raise AssertionError("reference reader %s differs" % key)
    report = tpgsd.pypgsd.verify(path, deep=True)
    if not report["ok"]:
        raise AssertionError(report["errors"])
    dev = jax.devices()[0]
    with tpgsd.fl.open(name=path, mode="r") as f:
        arr = read_sharded_chunk(f, 7, "particles/position",
                                 SingleDeviceSharding(dev))
    if arr.devices() != {dev}:
        raise AssertionError("read_sharded_chunk placed %r" % arr.devices())
    if not np.array_equal(np.asarray(arr), host["particles/position"]):
        raise AssertionError("read_sharded_chunk position differs")
    say("dump", "40 steps, %d frames %.1f MB, writer %.1f MB/s, overlapped "
        "%.1f MB/s, overlap efficiency %.3f; last frame (step %d) "
        "bit-equal in tpgsd.hoomd, the reference reader and "
        "read_sharded_chunk; verify ok"
        % (stats.frames, stats.bytes / 1e6, stats.write_mb_s,
           stats.effective_mb_s, stats.overlap_efficiency, step_i))
    os.unlink(path)


def phase_slab():
    import jax

    import tpgsd.pypgsd
    from tpgsd.io_runtime import SlabDumpChannel
    from tpgsd.parallel import ShardedFrameWriter
    from tpgsd.sph import dam_break, make_slab_step_fn

    n_slabs = 4
    db = dam_break(n_side=N_SIDE, capacity="auto")
    grid = padded_grid(db.grid, (n_slabs, 1, 1))
    path = os.path.join(SCRATCH, "slab.gsd")
    keys = ("position", "velocity", "density", "pressure")
    chan = SlabDumpChannel(ShardedFrameWriter(path), n=db.n,
                           n_slabs=n_slabs, keys=keys)
    step = jax.jit(make_slab_step_fn(grid, db.params, n_slabs=n_slabs,
                                     slab_emit=chan.slab_emit))
    state = fresh_state(db, "summation")
    for i in range(3):
        state, (rho, p, covf, wovf) = step(
            state, chan.dump(i) if i == 2 else chan.no_dump())
    jax.block_until_ready(state.x)
    chan.close()
    if int(covf) or int(wovf):
        raise AssertionError("overflow cell=%d window=%d"
                             % (int(covf), int(wovf)))
    want = {"position": state.x, "velocity": state.v, "density": rho,
            "pressure": p}
    with tpgsd.pypgsd.PGSDFile(open(path, "rb")) as f:
        if f.nframes != 1:
            raise AssertionError("slab dump has %d frames" % f.nframes)
        for key in keys:
            got = f.read_chunk(0, "particles/" + key)
            if not np.array_equal(got, np.asarray(want[key])):
                raise AssertionError("slab frame %s differs" % key)
    say("slab", "n=%d grid %s, %d slabs, pipelined per-slab frame equals "
        "the whole-frame state of the same step" % (db.n, grid.dims, n_slabs))
    os.unlink(path)


def one_card_reference(db, grid, steps):
    import jax

    from tpgsd.sph import make_step_fn

    step = jax.jit(make_step_fn(grid, db.params))
    state = fresh_state(db, "summation")
    for _ in range(steps):
        state, aux = step(state)
    return [np.asarray(a) for a in (state.x, state.v, aux[0])]


def phase_four():
    """The paths that exist only across cards, each against one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import tpgsd.fl
    from tpgsd.parallel import ShardedFrameWriter, make_mesh, make_mesh2d
    from tpgsd.sph import (
        SPHState,
        collect_aux,
        collect_state,
        dam_break,
        distribute_state,
        distribute_state_2d,
        make_distributed2d_step_fn,
        make_distributed_step_fn,
        make_step_fn,
    )

    steps = 3
    devices = jax.devices()[:4]
    db = dam_break(n_side=N_SIDE, capacity="auto")
    grid = padded_grid(db.grid, (4, 2, 1))
    db = db._replace(grid=grid)
    ref = one_card_reference(db, grid, steps)

    def check(label, got, extra=""):
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        if max(errs) > FOUR_TOL:
            raise AssertionError("%s vs one card %r" % (label, errs))
        say("four", "%s n=%d grid %s%s: %d steps, max|diff|/max|ref| vs "
            "one card (x, v, rho) %s (tol %g)"
            % (label, db.n, grid.dims, extra, steps,
               ["%.2e" % e for e in errs], FOUR_TOL))

    # GSPMD: the particle axis sharded over a 1-D mesh
    mesh = make_mesh(n_devices=4, devices=devices)
    sh = NamedSharding(mesh, P("shard"))
    fn = make_step_fn(grid, db.params, sharding=sh)
    step = jax.jit(fn, in_shardings=(SPHState(x=sh, v=sh),),
                   out_shardings=(SPHState(x=sh, v=sh), (sh, sh, None)))
    if db.n % 4:
        raise AssertionError("n=%d does not divide over 4 cards" % db.n)
    state = SPHState(x=jax.device_put(db.state.x, sh),
                     v=jax.device_put(db.state.v, sh))
    for _ in range(steps):
        state, (rho, p, _ovf) = step(state)
    check("gspmd", [np.asarray(a) for a in (state.x, state.v, rho)],
          " (jnp pair path)")
    sharded = {"particles/position": state.x, "particles/velocity": state.v,
               "particles/density": rho, "particles/pressure": p}

    # the slab decomposition: shard_map + ppermute halos + migration
    dist, cap = distribute_state(fresh_state(db, "summation"), grid, mesh)
    dstep = make_distributed_step_fn(grid, db.params, mesh, capacity=cap)
    for _ in range(steps):
        dist, aux = dstep(dist)
    x, v, _ = collect_state(dist, db.n)
    rho_d, _p, _du = collect_aux(dist, aux, db.n, params=db.params)
    check("slab", [x, v, rho_d], " mesh (4,)")

    # the (2, 2) block decomposition
    mesh2 = make_mesh2d(shape=(2, 2), devices=devices)
    dist2, cap2 = distribute_state_2d(fresh_state(db, "summation"), grid,
                                      mesh2)
    dstep2 = make_distributed2d_step_fn(grid, db.params, mesh2,
                                        capacity=cap2)
    for _ in range(steps):
        dist2, aux2 = dstep2(dist2)
    x2, v2, _ = collect_state(dist2, db.n)
    rho2, _p2, _du2 = collect_aux(dist2, aux2, db.n, params=db.params)
    check("block2d", [x2, v2, rho2], " mesh (2, 2)")

    # sharded dump into one file vs a one-device dump of the same state
    one = {k: jax.device_put(a, devices[0]) for k, a in sharded.items()}
    paths = {}
    for label, frame in (("sharded", sharded), ("one", one)):
        paths[label] = os.path.join(SCRATCH, "four_%s.gsd" % label)
        with ShardedFrameWriter(paths[label]) as writer:
            writer.write_frame(frame, step=0)
    with tpgsd.fl.open(name=paths["sharded"], mode="r") as fa, \
            tpgsd.fl.open(name=paths["one"], mode="r") as fb:
        for key in sharded:
            a, b = fa.read_chunk(0, key), fb.read_chunk(0, key)
            if a.tobytes() != b.tobytes():
                raise AssertionError("sharded dump %s differs" % key)
    say("four", "sharded dump of the gspmd state from 4 cards: every "
        "chunk byte-equal to a one-device dump (%d keys)" % len(sharded))
    for path in paths.values():
        os.unlink(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run the four-card paths (needs 4 GPUs) and "
                        "nothing else")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print("chip_smoke: JAX found no GPU (devices: %s)" % devices,
              file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print("chip_smoke: --four needs 4 GPUs, JAX found %d"
              % len(devices), file=sys.stderr)
        return 1
    from tpgsd.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    dev = devices[0]
    say("device", "%s %s x%d; card %s; compile cache %s"
        % (dev.platform, dev.device_kind, len(devices), card, cache))

    os.makedirs(SCRATCH, exist_ok=True)
    try:
        if args.four:
            phase_four()
        else:
            phase_step(card)
            phase_reference()
            phase_kernel()
            phase_dump()
            phase_slab()
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)

    print("card: %s" % card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
