#!/usr/bin/env python3
"""SPH stepper benchmark: steps/sec and particle-steps/sec.

Runs the dam-break workload with the jnp pair loops and (optionally)
the Triton pair kernels, reporting the median wall time per step after
a warm-up, each step ended by ``block_until_ready``.  The frame-producer
speed bounds the overlapped dump rate (BASELINE north star: frames/sec
with the SPH step fully overlapped).

    python benchmarks/benchmark_sph.py --n-side 20 --steps 30 --pallas
    python benchmarks/benchmark_sph.py --n-side 86 --steps 12 --pallas \
        --num-warps 4,8 --num-stages 1,2,3   # one Triton row per pair
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def bench_step(step, state, steps):
    """Median per-step wall time; every step ends in
    ``block_until_ready``, after a compile step and two warm-up steps."""
    import jax
    import numpy

    for _ in range(3):
        state, aux = step(state)
    jax.block_until_ready(state)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, aux = step(state)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
    return float(numpy.median(times)), state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-side", type=int, default=20)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--block", type=int, default=32, help="jnp cell block")
    p.add_argument("--pallas", action="store_true",
                   help="also benchmark the Triton pair kernels")
    p.add_argument("--num-warps", default=None, metavar="W[,W...]",
                   help="Triton rows at these warps per program (default: "
                        "pair_kernel.NUM_WARPS)")
    p.add_argument("--num-stages", default=None, metavar="S[,S...]",
                   help="Triton rows at these pipelining stages (default: "
                        "pair_kernel.NUM_STAGES)")
    p.add_argument("--sweeps", action="store_true",
                   help="also time the cell layout and each pair sweep "
                        "alone, jnp blocks vs Triton kernels (median of "
                        "--steps calls)")
    p.add_argument("--capacity", default="auto",
                   help='cell slot capacity (int or "auto", the default: '
                        "sized to the initial lattice occupancy)")
    p.add_argument("--slabs", type=int, default=0, metavar="S",
                   help="also benchmark the slab-sequential big step "
                        "with S slabs (0 = skip)")
    p.add_argument("--decomp", choices=["slab", "2d", "3d"], default=None,
                   help="also benchmark the explicit domain decomposition "
                        "(shard_map + ppermute halos + migration) on a "
                        "best-fit mesh over the available devices - on one "
                        "device this measures the pure halo-machinery "
                        "overhead vs the global step")
    p.add_argument("--density-mode", choices=["summation", "continuity"],
                   default="summation",
                   help="density formulation for the jnp/pallas/decomp "
                        "rows (continuity seeds rho with init_density; "
                        "the fused accel+drho sweep)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="force N virtual CPU devices")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    from tpgsd.sph import dam_break, init_density, make_step_fn

    cap = args.capacity if args.capacity == "auto" else int(args.capacity)
    db = dam_break(n_side=args.n_side, capacity=cap)
    if args.density_mode == "continuity":
        db = db._replace(state=init_density(db.state, db.grid, db.params))
    dev = jax.devices()[0]
    print(
        "device=%s %s x%d particles=%d cells=%s capacity=%d"
        % (dev.platform, dev.device_kind, len(jax.devices()), db.n,
           db.grid.dims, db.grid.capacity)
    )

    # the explicit jnp reference row: pin the path
    step = jax.jit(make_step_fn(db.grid, db.params, block=args.block,
                                use_pallas=False, density_mode=args.density_mode))
    dt, _ = bench_step(step, db.state, args.steps)
    print(
        "jnp    : %8.2f ms/step  %12.3g particle-steps/s"
        % (dt * 1e3, db.n / dt)
    )

    if args.pallas:
        from tpgsd.sph import pair_kernel

        def ints(arg, default):
            return [default] if arg is None else [int(a) for a in arg.split(",")]

        for warps in ints(args.num_warps, pair_kernel.NUM_WARPS):
            for stages in ints(args.num_stages, pair_kernel.NUM_STAGES):
                # read when the sweeps are traced: each pair is its own
                # step function and compile
                pair_kernel.NUM_WARPS, pair_kernel.NUM_STAGES = warps, stages
                step_p = jax.jit(
                    make_step_fn(
                        db.grid, db.params, use_pallas=True,
                        density_mode=args.density_mode,
                    )
                )
                dt_p, _ = bench_step(step_p, db.state, args.steps)
                print(
                    "triton w%d s%d: %8.2f ms/step  %12.3g particle-steps/s"
                    "  (%.2fx)"
                    % (warps, stages, dt_p * 1e3, db.n / dt_p, dt / dt_p)
                )

    if args.sweeps:
        import numpy

        import chip_smoke
        from tpgsd.sph.cells import build_cells, scatter_to_cells

        def med_ms(fn, *a):
            jax.block_until_ready(fn(*a))
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*a))
                times.append(time.perf_counter() - t0)
            return float(numpy.median(times)) * 1e3

        g = db.grid

        @jax.jit
        def layout(x, v):
            cells = build_cells(x, g)
            return (scatter_to_cells(x, cells, g),
                    scatter_to_cells(v, cells, g), cells.mask)

        x = jax.numpy.asarray(db.state.x)
        v = jax.numpy.asarray(numpy.random.default_rng(0).normal(
            scale=0.1, size=x.shape).astype(numpy.float32))
        print("layout : %8.3f ms" % med_ms(layout, x, v))
        inputs, nbr, mimage = chip_smoke.sweep_inputs(x, v, g, db.params)
        for label, use in (("jnp", False), ("triton", True)):
            fns = chip_smoke.sweep_fns(use, nbr, db.params, mimage)
            print("%-7s: %s" % (label, "  ".join(
                "%s %.3f ms" % (name, med_ms(fn, *inputs))
                for name, fn in fns.items())))

    if args.decomp:
        import numpy
        from tpgsd.parallel import make_mesh, make_mesh2d, make_mesh3d
        from tpgsd.sph import (
            distribute_state,
            distribute_state_2d,
            distribute_state_3d,
            make_distributed_step_fn,
            make_distributed2d_step_fn,
            make_distributed3d_step_fn,
        )

        n_dev = len(jax.devices())
        dims = db.grid.dims
        nd = {"slab": 1, "2d": 2, "3d": 3}[args.decomp]
        best = [(1,) * nd]

        def rec(ax, rem, cur):
            if ax == nd:
                key = (int(numpy.prod(cur)), -sum(cur))
                if key > (int(numpy.prod(best[0])), -sum(best[0])):
                    best[0] = tuple(cur)
                return
            for d in range(1, rem + 1):
                if rem % d == 0 and dims[ax] % d == 0:
                    rec(ax + 1, rem // d, cur + [d])

        rec(0, n_dev, [])
        shape = best[0]
        if nd == 1:
            mesh = make_mesh(n_devices=shape[0])
            dist, dcap = distribute_state(db.state, db.grid, mesh)
            builder = make_distributed_step_fn
        elif nd == 2:
            mesh = make_mesh2d(shape=shape)
            dist, dcap = distribute_state_2d(db.state, db.grid, mesh)
            builder = make_distributed2d_step_fn
        else:
            mesh = make_mesh3d(shape=shape)
            dist, dcap = distribute_state_3d(db.state, db.grid, mesh)
            builder = make_distributed3d_step_fn
        step_d = builder(db.grid, db.params, mesh, capacity=dcap,
                         use_pallas=False,
                         density_mode=args.density_mode)
        dt_d, _ = bench_step(step_d, dist, args.steps)
        print(
            "%s%-5s: %7.2f ms/step  %12.3g particle-steps/s  "
            "(%.2fx vs global; mesh %s, %d slots/device)"
            % (args.decomp, str(shape), dt_d * 1e3, db.n / dt_d,
               dt / dt_d, shape, dcap)
        )

    if args.slabs:
        from tpgsd.sph import make_slab_step_fn

        step_s = jax.jit(
            make_slab_step_fn(db.grid, db.params, n_slabs=args.slabs)
        )
        dt_s, _ = bench_step(step_s, db.state, args.steps)
        print(
            "slab%-3d: %8.2f ms/step  %12.3g particle-steps/s"
            % (args.slabs, dt_s * 1e3, db.n / dt_s)
        )


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
