"""Smoke-run every Python benchmark harness at tiny sizes.

A bitrotted benchmark fails silently until someone runs it by hand (the
repo's own timing-methodology fix in CHANGELOG 1.1.0 shows how easy that
is to miss); these tests execute each harness's real main() so the code
paths stay green in CI.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks")
sys.path.insert(0, BENCH_DIR)


def test_benchmark_write_then_read_smoke(tmp_path, capsys):
    import benchmark_read
    import benchmark_write

    f = str(tmp_path / "bench.gsd")
    assert (
        benchmark_write.main(
            ["--keys", "3", "--frames", "2", "--elems", "64", "--file", f,
             "--keep"]
        )
        == 0
    )
    assert benchmark_read.main(["--file", f, "--shards", "2"]) == 0
    out = capsys.readouterr().out
    assert "read throughput" in out


def test_benchmark_write_sharded_smoke(tmp_path):
    import benchmark_write

    f = str(tmp_path / "bench_sh.gsd")
    assert (
        benchmark_write.main(
            ["--keys", "2", "--frames", "2", "--elems", "64", "--shards",
             "3", "--file", f]
        )
        == 0
    )


def test_benchmark_hoomd_smoke(tmp_path, capsys):
    import benchmark_hoomd

    f = str(tmp_path / "bench_h.gsd")
    assert (
        benchmark_hoomd.main(
            ["--sizes", "64KiB", "--counts", "128", "--file", f]
        )
        == 0
    )
    out = capsys.readouterr().out
    assert "MB/s" in out


@pytest.mark.skipif(
    not os.path.exists(os.path.join(BENCH_DIR, "benchmark_overlap.py")),
    reason="overlap benchmark absent",
)
def test_benchmark_overlap_smoke(tmp_path):
    import benchmark_overlap

    assert (
        benchmark_overlap.main(
            ["--n-side", "4", "--steps", "2", "--file",
             str(tmp_path / "ov.gsd")]
        )
        == 0
    )


def test_benchmark_sph_decomp_smoke(capsys):
    import benchmark_sph

    benchmark_sph.main(["--n-side", "8", "--steps", "2", "--decomp", "3d"])
    out = capsys.readouterr().out
    assert "jnp" in out and "3d" in out


def test_benchmark_scale_smoke(tmp_path, capsys):
    import benchmark_scale

    assert (
        benchmark_scale.main(
            ["--rows", "10000", "--frames", "2", "--file",
             str(tmp_path / "sc.gsd")]
        )
        == 0
    )
    out = capsys.readouterr().out
    assert "readback verified" in out


@pytest.mark.parametrize("mode", ["summation", "continuity"])
def test_benchmark_bigcycle_smoke(tmp_path, mode, capsys):
    """Full bigcycle harness at toy size: slab step + pipelined per-slab
    dumps + resume + deep fsck."""
    import benchmark_bigcycle

    assert (
        benchmark_bigcycle.main(
            ["--n-side", "9", "--slabs", "2", "--steps", "3",
             "--dump-every", "2", "--resume-steps", "1",
             "--density-mode", mode,
             "--file", str(tmp_path / "bc.gsd")]
        )
        == 0
    )
    out = capsys.readouterr().out
    assert "pipelined per-slab" in out and "CLEAN" in out


def test_benchmark_bigcycle_whole_frame_smoke(tmp_path, capsys):
    import benchmark_bigcycle

    assert (
        benchmark_bigcycle.main(
            ["--n-side", "9", "--slabs", "2", "--steps", "3",
             "--dump-every", "2", "--resume-steps", "1",
             "--whole-frame-dump",
             "--file", str(tmp_path / "bw.gsd")]
        )
        == 0
    )
    assert "whole-frame" in capsys.readouterr().out
