#!/usr/bin/env python3
"""One-device production cycle with the slab-sequential step.

The BASELINE.md north-star workload on ONE device: an SPH dam break run
via the slab-sequential step (``tpgsd.sph.bigstep``, for layouts larger
than device memory), with HOOMD frames streamed through the async dump
runtime, a mid-run close + ``resume()``, and a final fsck
(``tpgsd.pypgsd.PGSDFile.verify``).

    python benchmarks/benchmark_bigcycle.py --n-side 400 --slabs 32 \
        --steps 6 --dump-every 3 --resume-steps 2

Reports steps/s, sustained dump MB/s, and the fsck verdict.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-side", type=int, default=400)
    p.add_argument("--slabs", type=int, default=32)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--dump-every", type=int, default=3)
    p.add_argument("--resume-steps", type=int, default=1)
    p.add_argument("--file", default="bigcycle.gsd")
    p.add_argument("--keep", action="store_true")
    p.add_argument(
        "--dump-keys", default="position,velocity,density",
        help="comma list of position,velocity,density,pressure",
    )
    p.add_argument("--density-mode", choices=["summation", "continuity"],
                   default="summation",
                   help="continuity carries rho through the sorted "
                        "features and runs ONE fused accel+drho sweep "
                        "per slab (seeded by slab_init_density; resume "
                        "reloads the dumped density)")
    p.add_argument("--whole-frame-dump", action="store_true",
                   help="dump whole frames after each step instead of the "
                        "default pipelined per-slab emission, which "
                        "streams each slab's rows device->host while "
                        "later slabs compute")
    args = p.parse_args(argv)

    import jax
    import numpy

    from tpgsd.io_runtime import AsyncDumpRunner, SlabDumpChannel
    from tpgsd.parallel import ShardedFrameWriter
    from tpgsd.sph import (
        dam_break,
        make_slab_step_fn,
        resume,
        slab_init_density,
    )

    t0 = time.perf_counter()
    db = dam_break(n_side=args.n_side, capacity="auto", on_device=True)
    print(
        "n=%.3e dims=%s capacity=%d slabs=%d (built %.0f s)"
        % (db.n, db.grid.dims, db.grid.capacity, args.slabs,
           time.perf_counter() - t0),
        flush=True,
    )
    keys = args.dump_keys.split(",")
    pipelined = not args.whole_frame_dump
    chan = None
    if pipelined:
        chan = SlabDumpChannel(
            ShardedFrameWriter(args.file), n=db.n, n_slabs=args.slabs,
            keys=tuple(keys), depth=2,
        )
    # donate the state: without donation two full states plus the
    # step's working set exceed HBM at 1e8.  Donation means dumped
    # arrays must be fetched to host numpy BEFORE the next step call
    # (the donated buffer is reused) - sync D2H below.  The pipelined
    # channel sidesteps the whole-frame fetch: each slab's rows stream
    # through the ordered io_callback while later slabs compute.
    step = jax.jit(
        make_slab_step_fn(
            db.grid, db.params, n_slabs=args.slabs,
            slab_emit=chan.slab_emit if pipelined else None,
            density_mode=args.density_mode,
        ),
        donate_argnums=0,
    )
    if pipelined:
        _base_step = step

        def step(state, dump=None):  # noqa: F811 - uniform call shape
            return _base_step(state, dump if dump is not None else chan.no_dump())

    state0 = db.state
    if args.density_mode == "continuity":
        t0 = time.perf_counter()
        state0 = slab_init_density(state0, db.grid, db.params, args.slabs)
        jax.block_until_ready(state0.rho)
        print(
            "slab_init_density (compile + seed pass): %.0f s"
            % (time.perf_counter() - t0),
            flush=True,
        )

    def frame_of(state, rho, pres):
        # synchronous D2H: the state buffers are donated to the next
        # step call, so they must be safely on the host first
        f = {}
        if "position" in keys:
            f["particles/position"] = numpy.asarray(state.x)
        if "velocity" in keys:
            f["particles/velocity"] = numpy.asarray(state.v)
        if "density" in keys:
            f["particles/density"] = numpy.asarray(rho)
        if "pressure" in keys:
            f["particles/pressure"] = numpy.asarray(pres)
        return f

    t0 = time.perf_counter()
    state, (rho, pres, covf, wovf) = step(state0)
    jax.block_until_ready(state.x)
    print(
        "compile+first step %.0f s  cell_ovf=%d win_ovf=%d"
        % (time.perf_counter() - t0, int(covf), int(wovf)),
        flush=True,
    )

    # ---- phase 1: simulate + overlapped dumps ----
    t0 = time.perf_counter()
    step_s = 0.0
    if pipelined:
        # per-slab emission: the dump's D2H rides the slab scan; the
        # only serialized tail is the final slab's window + disk drain
        for i in range(1, args.steps):
            ts = time.perf_counter()
            emitting = i % args.dump_every == 0
            state, (rho, pres, covf, wovf) = step(
                state, chan.dump(i) if emitting else chan.no_dump()
            )
            jax.block_until_ready(state.x)
            step_s += time.perf_counter() - ts
            print(
                "  step %d: %.1f s (ovf %d/%d)%s"
                % (i, time.perf_counter() - ts, int(covf), int(wovf),
                   " [emitting]" if emitting else ""),
                flush=True,
            )
        chan.flush()
        s = chan.stats
        chan.close()
    else:
        with AsyncDumpRunner(ShardedFrameWriter(args.file), depth=2) as dump:
            for i in range(1, args.steps):
                ts = time.perf_counter()
                state, (rho, pres, covf, wovf) = step(state)
                jax.block_until_ready(state.x)
                if i % args.dump_every == 0:
                    td = time.perf_counter()
                    dump.submit(frame_of(state, rho, pres), step=i)
                    print(
                        "    D2H+enqueue %.0f s" % (time.perf_counter() - td),
                        flush=True,
                    )
                step_s += time.perf_counter() - ts
                print(
                    "  step %d: %.1f s (ovf %d/%d)"
                    % (i, time.perf_counter() - ts, int(covf), int(wovf)),
                    flush=True,
                )
            dump.flush()
        s = dump.stats
    wall = time.perf_counter() - t0
    print(
        "phase1 (%s): %d steps in %.0f s (%.1f s/step incl. overlapped "
        "dump), %d frames %.2f GB, dump %.1f MB/s sustained, writer "
        "busy %.0f%% of wall (overlap efficiency)"
        % (
            "pipelined per-slab" if pipelined else "whole-frame",
            args.steps - 1,
            wall,
            step_s / max(args.steps - 1, 1),
            s.frames,
            s.bytes / 1e9,
            s.bytes / 1e6 / wall,
            100.0 * s.overlap_efficiency,
        ),
        flush=True,
    )

    # ---- phase 2: resume and continue ----
    # free phase 1's device references first: the resumed state needs
    # that room
    del state, rho, pres
    state2, last_step, writer, _ = resume(
        args.file, density_mode=args.density_mode
    )
    print(
        "resumed at step %d (%d frames)" % (last_step, writer.file.nframes),
        flush=True,
    )
    with AsyncDumpRunner(writer, depth=2) as dump:
        for i in range(args.resume_steps):
            state2, (rho, pres, covf, wovf) = step(state2)
        dump.submit(frame_of(state2, rho, pres), step=int(last_step) + args.resume_steps)
        dump.flush()
    print("post-resume frames: %d" % dump.stats.frames, flush=True)

    # ---- phase 3: fsck ----
    import tpgsd.pypgsd

    with open(args.file, "rb") as fh:
        report = tpgsd.pypgsd.verify(fh, deep=True)
    print(
        "fsck: %d frames %d chunks %.2f GB, %s"
        % (
            report["frames"],
            report["chunks"],
            report["data_bytes"] / 1e9,
            "CLEAN" if report["ok"] else report["errors"],
        ),
        flush=True,
    )

    if not args.keep:
        try:
            os.unlink(args.file)
        except OSError:
            pass
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
