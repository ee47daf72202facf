#!/usr/bin/env python3
"""Overlapped simulate+dump benchmark: the BASELINE north-star metric.

Runs the WCSPH dam break while streaming every frame through the async
dump runtime and reports frames/sec, dump MB/s, and overlap efficiency
(writer busy-time / wall-time; 1.0 = I/O-bound, lower = fully hidden
behind compute).

    python benchmarks/benchmark_overlap.py --n-side 24 --steps 100
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-side", type=int, default=20)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--every", type=int, default=1, help="dump cadence")
    p.add_argument("--file", default="overlap_bench.gsd")
    p.add_argument("--jnp", action="store_true",
                   help="pin the jnp pair path (default: the auto policy, "
                        "the Triton kernels on a GPU)")
    p.add_argument("--cpu", type=int, default=0, metavar="N")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    import numpy

    from tpgsd.io_runtime import AsyncDumpRunner
    from tpgsd.parallel import ShardedFrameWriter
    from tpgsd.sph import dam_break, make_step_fn

    db = dam_break(n_side=args.n_side)
    use_pallas = False if args.jnp else "auto"
    step = jax.jit(make_step_fn(db.grid, db.params, use_pallas=use_pallas))
    state, aux = step(db.state)  # compile
    jax.block_until_ready(state.x)
    # transfer-path warmup outside the timing (first D2H pays setup)
    numpy.asarray(state.x)

    bytes_per_frame = db.n * (3 + 3 + 1 + 1) * 4
    dev = jax.devices()[0]
    print(
        "device=%s %s x%d particles=%d frame=%.2f MB dump every %d"
        % (dev.platform, dev.device_kind, len(jax.devices()), db.n,
           bytes_per_frame / 1e6, args.every)
    )

    t0 = time.perf_counter()
    with AsyncDumpRunner(ShardedFrameWriter(args.file)) as dump:
        for i in range(args.steps):
            state, (rho, pres, _) = step(state)
            if i % args.every == 0:
                dump.submit(
                    {
                        "particles/position": state.x,
                        "particles/velocity": state.v,
                        "particles/density": rho,
                        "particles/pressure": pres,
                    },
                    step=i,
                )
        dump.flush()
        jax.block_until_ready(state.x)
    wall = time.perf_counter() - t0

    s = dump.stats
    print(
        "steps/sec:           %8.1f  (%.2f ms/step incl. dump)"
        % (args.steps / wall, wall / args.steps * 1e3)
    )
    print("frames dumped:       %8d  (%.1f MB)" % (s.frames, s.bytes / 1e6))
    print("writer busy:         %7.1f%%  (1.0 = I/O bound)" % (100 * s.overlap_efficiency))
    print("dump throughput:     %8.1f MB/s effective" % s.effective_mb_s)

    if not args.keep:
        try:
            os.unlink(args.file)
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
