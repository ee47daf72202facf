#!/usr/bin/env python3
"""North-star scale benchmark: 1e8-row chunks (1.2 GB positions/frame).

Writes BASELINE.md-scale HOOMD frames - ``--rows 100000000`` float32x3
positions (1.2 GB/chunk) plus a velocity chunk - through the sharded
writer and the async dump runner, then verifies a readback sample.
Reports GB/s sustained and per-frame wall time.

    python benchmarks/benchmark_scale.py --rows 100000000 --frames 3

Memory: one reusable host block per chunk (~2.4 GB total at 1e8 rows);
data is synthesized once with the arange trick so first-touch page
faults land outside the timed region.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows", type=int, default=100_000_000)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--file", default="benchmark_scale.gsd")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args(argv)

    from tpgsd.io_runtime import AsyncDumpRunner
    from tpgsd.parallel import ShardedFrameWriter

    n = args.rows
    # synthesize + touch every page outside the timed region
    pos = (
        numpy.arange(3 * n, dtype=numpy.float32).reshape(n, 3) * numpy.float32(1e-6)
    )
    vel = pos[::-1].copy()
    bytes_per_frame = pos.nbytes + vel.nbytes
    print(
        "rows=%d  chunk=%.2f GB  frame=%.2f GB  frames=%d"
        % (n, pos.nbytes / 1e9, bytes_per_frame / 1e9, args.frames)
    )

    t0 = time.perf_counter()
    writer = ShardedFrameWriter(args.file)
    with AsyncDumpRunner(writer, depth=2) as dump:
        for f in range(args.frames):
            dump.submit(
                {"particles/position": pos, "particles/velocity": vel},
                step=f,
            )
    elapsed = time.perf_counter() - t0
    total = bytes_per_frame * args.frames
    print(
        "wrote %.2f GB in %.1f s  =  %.0f MB/s  (%.1f s/frame)"
        % (total / 1e9, elapsed, total / 1e6 / elapsed, elapsed / args.frames)
    )

    # verify: index integrity + a strided sample of the last frame
    import tpgsd.fl

    with tpgsd.fl.open(args.file, "r") as f:
        assert f.nframes == args.frames, f.nframes
        entry = f._find_chunk(args.frames - 1, "particles/position")
        assert int(entry["N"]) == n
        sample = f.read_chunk(
            args.frames - 1, "particles/position", N=2, M=3,
            offset=n - 2, r_all=True,
        )
        numpy.testing.assert_allclose(sample, pos[-2:], rtol=1e-6)
    print("readback verified (tail stripe of frame %d)" % (args.frames - 1))

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
