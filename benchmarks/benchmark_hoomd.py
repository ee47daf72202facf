#!/usr/bin/env python3
"""HOOMD-schema benchmark: mirrors the reference's ``benchmark-hoomd.py``
methodology (reference: pgsd/scripts/benchmark-hoomd.py:97-210).

For each particle count N in {32^2, 128^2, 1024^2} and a target file
size, measures:

* write MB/s (frame append through the schema layer - which actually
  works here; the reference's own harness calls the disabled
  ``append()``, reference: pgsd/pgsd/hoomd.py:568),
* sequential-read MB/s,
* random-read MB/s,
* open latency (ms).

FS-cache dropping requires root + sysctl and is skipped unless
``--drop-caches`` (the reference shells out to sudo unconditionally,
reference: benchmark-hoomd.py:97-107).
"""

import argparse
import os
import random
import sys
import time

import numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import tpgsd.hoomd  # noqa: E402


def drop_caches():
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
    except OSError as e:
        print("  (cannot drop caches: %s)" % e, file=sys.stderr)


def make_frame(n, seed=42):
    rng = numpy.random.RandomState(seed)
    frame = tpgsd.hoomd.Frame()
    frame.particles.N = n
    frame.particles.position = rng.rand(n, 3).astype(numpy.float32)
    frame.particles.velocity = rng.rand(n, 3).astype(numpy.float32)
    frame.particles.density = rng.rand(n).astype(numpy.float32)
    frame.particles.pressure = rng.rand(n).astype(numpy.float32)
    frame.particles.slength = numpy.full(
        n, 0.1 + rng.rand() * 0.01, numpy.float32
    )
    frame.configuration.box = numpy.array([1, 1, 1, 0, 0, 0], numpy.float32)
    return frame


def bench_one(n, size, path, caches=False):
    bytes_per_frame = n * (3 + 3 + 1 + 1 + 1) * 4
    nframes = max(2, int(size // bytes_per_frame))

    # frame 0 and the appended frame must DIFFER: append() elides
    # chunks equal to frame 0's (sticky-frame-0 dedup), so appending
    # one frame object repeatedly writes ~no data and the column
    # measured metadata appends instead of bulk I/O
    frame0 = make_frame(n, seed=42)
    frame = make_frame(n, seed=43)
    t0 = time.perf_counter()
    with tpgsd.hoomd.open(path, "w") as traj:
        frame0.configuration.step = 0
        traj.append(frame0)
        for i in range(1, nframes):
            frame.configuration.step = i
            traj.append(frame)
    t_write = time.perf_counter() - t0
    actual = os.path.getsize(path)

    if caches:
        drop_caches()
    t0 = time.perf_counter()
    with tpgsd.hoomd.open(path, "r") as traj:
        t_open = time.perf_counter() - t0
        t0 = time.perf_counter()
        for f in traj:
            f.particles.position
        t_seq = time.perf_counter() - t0

        order = list(range(nframes))
        random.Random(7).shuffle(order)
        if caches:
            drop_caches()
        t0 = time.perf_counter()
        for i in order:
            traj[i].particles.position
        t_rand = time.perf_counter() - t0

    os.unlink(path)
    return dict(
        nframes=nframes,
        size_mb=actual / 1e6,
        open_ms=t_open * 1e3,
        write=actual / 1e6 / t_write,
        seq_read=actual / 1e6 / t_seq,
        rand_read=actual / 1e6 / t_rand,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default="128MiB",
                   help="comma list of target file sizes (e.g. 128MiB,1GiB)")
    p.add_argument("--counts", default="1024,16384,1048576",
                   help="comma list of particle counts")
    p.add_argument("--file", default="benchmark_hoomd.gsd")
    p.add_argument("--drop-caches", action="store_true")
    args = p.parse_args(argv)

    units = {"KiB": 1 << 10, "MiB": 1 << 20, "GiB": 1 << 30}

    def parse_size(s):
        for u, m in units.items():
            if s.endswith(u):
                return int(float(s[: -len(u)]) * m)
        return int(s)

    print("%10s %10s %8s %9s %9s %9s %9s"
          % ("N", "size", "frames", "open/ms", "write", "seq_rd", "rand_rd"))
    for size_s in args.sizes.split(","):
        size = parse_size(size_s)
        for n_s in args.counts.split(","):
            n = int(n_s)
            r = bench_one(n, size, args.file, caches=args.drop_caches)
            print("%10d %9.0fM %8d %9.2f %7.1fMB/s %7.1fMB/s %7.1fMB/s"
                  % (n, r["size_mb"], r["nframes"], r["open_ms"],
                     r["write"], r["seq_read"], r["rand_read"]))
    return 0


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
