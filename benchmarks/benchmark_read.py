#!/usr/bin/env python3
"""Read benchmark: mirrors the reference's ``benchmark-read`` harness.

Opens a file written by ``benchmark_write.py`` and reads every chunk of
every frame as strided per-shard stripes, recomputing the partition per
chunk from the global row count (reference:
pgsd/scripts/benchmark-read.cc:46-119).  Reports microseconds/key and
total GB (reference: benchmark-read.cc:140-146).
"""

import argparse
import os
import sys
import time

import numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import tpgsd.fl  # noqa: E402
from benchmark_write import partition  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--file", default="benchmark_write.gsd")
    p.add_argument("--shards", type=int, default=1)
    args = p.parse_args(argv)

    total_bytes = 0
    n_reads = 0
    t0 = time.perf_counter()
    with tpgsd.fl.open(args.file, "r") as f:
        names = f.find_matching_chunk_names("")
        for frame in range(f.nframes):
            for name in names:
                entry = f._find_chunk(frame, name)
                counts = partition(int(entry["N"]), args.shards)
                row = 0
                for c in counts:
                    data = f.read_chunk(
                        frame, name, N=int(c), M=int(entry["M"]),
                        offset=row, r_all=True,
                    )
                    total_bytes += data.nbytes
                    row += int(c)
                n_reads += 1
    elapsed = time.perf_counter() - t0

    print("chunks read:       %d x %d shards" % (n_reads, args.shards))
    print("time per key:      %.1f us" % (elapsed * 1e6 / max(n_reads, 1)))
    print("total data:        %.3f GB" % (total_bytes / 1e9))
    print("read throughput:   %.1f MB/s" % (total_bytes / 1e6 / elapsed))
    return 0


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
