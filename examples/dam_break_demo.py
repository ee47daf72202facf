#!/usr/bin/env python3
"""End-to-end demo: WCSPH simulation with overlapped trajectory dumps.

Runs the jitted SPH step on any scenario from the zoo (3-D dam break,
planar 2-D dam break, periodic Taylor-Green vortex, hydrostatic tank
with fixed floor particles), optionally sharded over all available
devices, streams every Nth frame to a hoomd-schema GSD file through
the async dump runtime, prints throughput stats, and (optionally)
converts the result to VTK point clouds.

    python examples/dam_break_demo.py --steps 200 --every 5 --vtu
    python examples/dam_break_demo.py --scenario taylor_green --steps 300

The output file is readable by upstream GSD tooling (OVITO, gsd-vmd)
and by `python -m tpgsd read/info`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--every", type=int, default=5, help="dump cadence")
    p.add_argument("--n-side", type=int, default=14)
    p.add_argument(
        "--scenario",
        default="dam_break",
        choices=["dam_break", "dam_break_2d", "taylor_green", "hydrostatic"],
        help="which flow to run (taylor_green runs with periodic "
             "boundaries; hydrostatic uses fixed floor particles)",
    )
    p.add_argument("--out", default=None,
                   help="output file (default <scenario>.gsd)")
    p.add_argument("--sharded", action="store_true",
                   help="shard the particle axis over all devices")
    p.add_argument("--decomp", choices=["slab", "2d", "3d"], default=None,
                   help="explicit domain decomposition over the device "
                        "mesh (shard_map + ppermute halos + migration): "
                        "1-D slabs, (px,py) blocks, or (px,py,pz) blocks")
    p.add_argument("--vtu", action="store_true", help="convert to .vtu after")
    p.add_argument("--adaptive", action="store_true",
                   help="CFL-adaptive dt (Monaghan force/Courant "
                        "controller; dt flows as a traced scalar, so "
                        "no recompiles)")
    p.add_argument("--cfl", type=float, default=0.25,
                   help="safety factor for --adaptive (default 0.25)")
    p.add_argument("--xsph", type=float, default=0.0,
                   help="XSPH drift-smoothing strength (e.g. 0.5)")
    p.add_argument("--surface-tension", type=float, default=0.0,
                   help="strength gamma of the Akinci surface-tension "
                        "model (cohesion + curvature, momentum-exact; "
                        "drops contract and merge)")
    p.add_argument("--density-renorm", action="store_true",
                   help="free-surface density floor (no negative "
                        "surface pressures)")
    p.add_argument("--density-mode", choices=["summation", "continuity"],
                   default="summation",
                   help="density formulation: continuity evolves rho as "
                        "carried state (one fused accel+drho sweep; "
                        "composes with every --decomp)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on N virtual CPU devices")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    import jax.numpy as jnp
    import numpy

    from tpgsd.io_runtime import AsyncDumpRunner
    from tpgsd.parallel import ShardedFrameWriter, make_mesh
    from tpgsd.sph import (
        SPHState,
        dam_break,
        dam_break_2d,
        hydrostatic_tank,
        make_adaptive_step_fn,
        make_step_fn,
        taylor_green,
    )

    periodic = args.scenario == "taylor_green"
    n_fixed = 0
    if args.scenario == "dam_break":
        db = dam_break(n_side=args.n_side, capacity="auto")
    elif args.scenario == "dam_break_2d":
        db = dam_break_2d(n_side=args.n_side, capacity="auto")
    elif args.scenario == "taylor_green":
        db = taylor_green(n_side=max(args.n_side, 12))
    else:
        db = hydrostatic_tank(n_side=args.n_side)
        n_fixed = db.n_fixed
    if args.out is None:
        args.out = args.scenario + ".gsd"
    box3 = tuple(db.box) + (0.0,) * (3 - len(db.box))
    print("scenario: %s  particles: %d  grid: %s cells  dt: %.2e"
          % (args.scenario, db.n, db.grid.dims, db.params.dt))

    if args.decomp and args.sharded:
        raise SystemExit("--decomp and --sharded are exclusive")
    if args.sharded and args.scenario != "dam_break":
        # padding rows are parked in the 3-D box's far corner, which is
        # only safely out of interaction range for the 3-D dam break; a
        # periodic box would couple them to the flow, the 2-D plane has
        # no far corner, and the hydrostatic corner sits above the
        # settled surface
        print("--sharded supports the dam_break scenario only; running "
              "unsharded (see tpgsd.sph.distributed for the general "
              "slab-decomposed path)")
        args.sharded = False

    state = db.state
    if args.density_mode == "continuity":
        from tpgsd.sph import init_density

        state = init_density(state, db.grid, db.params)
    decomp = args.decomp
    if decomp:
        from tpgsd.parallel import make_mesh2d, make_mesh3d
        from tpgsd.sph import (
            collect_aux,
            collect_state,
            distribute_state,
            distribute_state_2d,
            distribute_state_3d,
            make_adaptive_distributed_step_fn,
            make_adaptive_distributed2d_step_fn,
            make_adaptive_distributed3d_step_fn,
            make_distributed_step_fn,
            make_distributed2d_step_fn,
            make_distributed3d_step_fn,
        )

        n_dev = len(jax.devices())
        dims = db.grid.dims

        def _fit_mesh(nd):
            # best mesh shape: maximize devices used, then balance
            # (divisibility: each factor must divide its grid axis)
            best = [(1,) * nd]

            def rec(ax, rem, cur):
                if ax == nd:
                    key = (int(numpy.prod(cur)), -sum(cur))
                    bkey = (int(numpy.prod(best[0])), -sum(best[0]))
                    if key > bkey:
                        best[0] = tuple(cur)
                    return
                for d in range(1, rem + 1):
                    if rem % d == 0 and dims[ax] % d == 0:
                        rec(ax + 1, rem // d, cur + [d])

            rec(0, n_dev, [])
            return best[0]

        kw = dict(n_fixed=n_fixed, periodic=periodic, xsph=args.xsph,
                  density_renorm=args.density_renorm,
                  surface_tension=args.surface_tension,
                  density_mode=args.density_mode)
        if args.adaptive:
            kw["cfl"] = args.cfl
        if decomp == "slab":
            shape = _fit_mesh(1)
            mesh = make_mesh(n_devices=shape[0])
            state, cap = distribute_state(state, db.grid, mesh)
            build = (make_adaptive_distributed_step_fn if args.adaptive
                     else make_distributed_step_fn)
        elif decomp == "2d":
            shape = _fit_mesh(2)
            mesh = make_mesh2d(shape=shape)
            state, cap = distribute_state_2d(state, db.grid, mesh)
            build = (make_adaptive_distributed2d_step_fn if args.adaptive
                     else make_distributed2d_step_fn)
        else:
            shape = _fit_mesh(3)
            mesh = make_mesh3d(shape=shape)
            state, cap = distribute_state_3d(state, db.grid, mesh)
            build = (make_adaptive_distributed3d_step_fn if args.adaptive
                     else make_distributed3d_step_fn)
        step = build(db.grid, db.params, mesh, capacity=cap, **kw)
        print("decomposed (%s) over mesh %s: %d of %d devices, %d "
              "slots/device"
              % (decomp, shape, int(numpy.prod(shape)), n_dev, cap))
    elif args.sharded and len(jax.devices()) > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh()
        sharding = NamedSharding(mesh, P("shard"))
        n_dev = mesh.devices.size
        pad = (-db.n) % n_dev
        x = jnp.pad(state.x, ((0, pad), (0, 0)))
        x = x.at[db.n:].set(jnp.asarray(box3, jnp.float32) * 0.999)
        v = jnp.pad(state.v, ((0, pad), (0, 0)))
        rho = state.rho
        if rho is not None:  # continuity: padded rows carry rho0
            rho = jnp.pad(rho, ((0, pad),), constant_values=db.params.rho0)
        rho_sh = None if rho is None else sharding
        state_sh = SPHState(x=sharding, v=sharding, rho=rho_sh)
        aux_sh = (sharding, sharding, None)
        # the sharding hint makes the "auto" policy GSPMD-aware: the
        # jnp pair path is what XLA partitions (GSPMD does not partition
        # a pallas_call)
        kw = dict(
            n_fixed=n_fixed, xsph=args.xsph,
            density_renorm=args.density_renorm,
            surface_tension=args.surface_tension,
            density_mode=args.density_mode,
            sharding=sharding,
        )
        if args.adaptive:
            step_fn = make_adaptive_step_fn(
                db.grid, db.params, cfl=args.cfl, **kw
            )
            step = jax.jit(
                step_fn,
                in_shardings=(state_sh, None),
                out_shardings=(state_sh, aux_sh, None),
            )
        else:
            step_fn = make_step_fn(db.grid, db.params, **kw)
            step = jax.jit(
                step_fn,
                in_shardings=(state_sh,),
                out_shardings=(state_sh, aux_sh),
            )
        state = SPHState(
            x=jax.device_put(x, sharding),
            v=jax.device_put(v, sharding),
            rho=None if rho is None else jax.device_put(rho, sharding),
        )
        print(
            "sharded over %d devices (resolved: %s)"
            % (n_dev, step_fn.resolved)
        )
    else:
        build = make_adaptive_step_fn if args.adaptive else make_step_fn
        kw = dict(
            n_fixed=n_fixed, periodic=periodic,
            xsph=args.xsph, density_renorm=args.density_renorm,
            surface_tension=args.surface_tension,
            density_mode=args.density_mode,
        )
        if args.adaptive:
            kw["cfl"] = args.cfl
        step = jax.jit(build(db.grid, db.params, **kw))

    writer = ShardedFrameWriter(
        args.out,
        static={
            "configuration/box": numpy.array(
                list(box3) + [0, 0, 0], numpy.float32
            ),
            "particles/N": numpy.array([db.n], numpy.uint32),
        },
    )
    dt = jnp.float32(db.params.dt)
    t_sim = jnp.float32(0.0)  # device-side accumulator: no per-step sync
    with AsyncDumpRunner(writer) as dump:
        for i in range(args.steps):
            if args.adaptive:
                t_sim = t_sim + dt
                if decomp:
                    state, aux, dt = step(state, dt)
                else:
                    state, (rho, pres, overflow), dt = step(state, dt)
            else:
                if decomp:
                    state, aux = step(state)
                else:
                    state, (rho, pres, overflow) = step(state)
            if i % args.every == 0:
                if decomp:
                    # gather the compact global frame (demo-simple; the
                    # cross-process production path streams the sharded
                    # slot arrays directly - see
                    # tests/test_multiprocess.py dump-cycle test)
                    xh, vh, _ = collect_state(state, db.n)
                    rho_h, pres_h, _du = collect_aux(
                        state, aux, db.n, params=db.params
                    )
                    frame = {
                        "particles/position": xh,
                        "particles/velocity": vh,
                        "particles/density": rho_h,
                        "particles/pressure": pres_h,
                        "particles/slength": numpy.full(
                            db.n, db.params.h, numpy.float32
                        ),
                    }
                else:
                    frame = {
                        "particles/position": state.x,
                        "particles/velocity": state.v,
                        "particles/density": rho,
                        "particles/pressure": pres,
                        "particles/slength": jnp.full(
                            state.x.shape[0], db.params.h, jnp.float32
                        ),
                    }
                dump.submit(frame, step=i)
        dump.flush()

    if args.adaptive:
        print(
            "adaptive dt: simulated %.4f s in %d steps (fixed dt would "
            "cover %.4f s); final dt %.2e (seed %.2e)"
            % (float(t_sim), args.steps, args.steps * db.params.dt,
               float(dt), db.params.dt)
        )

    s = dump.stats
    print(
        "dumped %d frames, %.1f MB: writer %.1f MB/s, overlapped %.1f MB/s "
        "(overlap efficiency %.0f%%)"
        % (s.frames, s.bytes / 1e6, s.write_mb_s, s.effective_mb_s,
           100 * s.overlap_efficiency)
    )

    import tpgsd.hoomd

    with tpgsd.hoomd.open(args.out, mode="r") as traj:
        last = traj[-1]
        print(
            "trajectory: %d frames; last frame step=%d, max|v|=%.3f, "
            "rho in [%.0f, %.0f]"
            % (
                len(traj),
                last.configuration.step,
                float(numpy.abs(last.particles.velocity).max()),
                float(last.particles.density.min()),
                float(last.particles.density.max()),
            )
        )

    if args.vtu:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
        import pgsd2vtu

        written = pgsd2vtu.convert(args.out, quiet=True)
        print("wrote %d .vtu files" % len(written))


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
