#!/usr/bin/env python3
"""Write benchmark: mirrors the reference's ``benchmark-write`` harness.

Workload (reference: pgsd/scripts/benchmark-write.cc:20-130): ``keys``
chunk names x ``frames`` frames x ``elems`` float64 elements per chunk,
row-partitioned over ``shards`` (uneven remainder spread over low shards,
reference: benchmark-write.cc:33-37).  Reports microseconds/key,
microseconds/frame, MB/s, then reopens read-only and verifies
nframes/nnames (reference: benchmark-write.cc:140-190).

Shard writes go through the per-shard offset protocol
(``write_chunk(offset=counts, rank=r)``) exactly like the reference's
per-rank path (reference: pgsd/pgsd/fl.pyx:593-598).
"""

import argparse
import os
import sys
import time

import numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import tpgsd.fl  # noqa: E402


def partition(n, shards):
    """Per-shard row counts: even split, remainder over low shards."""
    counts = numpy.full(shards, n // shards, dtype=numpy.uint64)
    counts[: n % shards] += 1
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--keys", type=int, default=17)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--elems", type=int, default=1 << 20,
                   help="float64 elements per key")
    p.add_argument("--shards", type=int, default=1,
                   help="row partitions per chunk (the reference's ranks)")
    p.add_argument("--file", default="benchmark_write.gsd")
    p.add_argument("--keep", action="store_true", help="do not delete the file")
    args = p.parse_args(argv)

    counts = partition(args.elems, args.shards)
    rng = numpy.random.RandomState(0)
    shard_data = [rng.rand(int(c)).astype(numpy.float64) for c in counts]
    names = ["data/key%04d" % i for i in range(args.keys)]
    total_bytes = args.keys * args.frames * args.elems * 8

    t0 = time.perf_counter()
    with tpgsd.fl.open(
        args.file, "w", application="benchmark-write", schema="none",
        schema_version=[1, 0],
    ) as f:
        for _ in range(args.frames):
            for name in names:
                for r, data in enumerate(shard_data):
                    f.write_chunk(
                        name, data, offset=counts, rank=r, write_all=True
                    )
            f.end_frame()
    elapsed = time.perf_counter() - t0

    us_per_key = elapsed * 1e6 / (args.keys * args.frames)
    print("keys/frame:        %d" % args.keys)
    print("frames:            %d" % args.frames)
    print("shards:            %d" % args.shards)
    print("bytes/key:         %d" % (args.elems * 8))
    print("time per key:      %.1f us" % us_per_key)
    print("time per frame:    %.1f us" % (elapsed * 1e6 / args.frames))
    print("total time:        %.2f s" % elapsed)
    print("write throughput:  %.1f MB/s" % (total_bytes / 1e6 / elapsed))

    # readback verification (reference: benchmark-write.cc:176-190)
    with tpgsd.fl.open(args.file, "r") as f:
        ok = f.nframes == args.frames and f.nnames == args.keys
        print("readback: nframes=%d nnames=%d %s"
              % (f.nframes, f.nnames, "OK" if ok else "MISMATCH"))
        if not ok:
            return 1
    if not args.keep:
        os.unlink(args.file)
    return 0


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
