"""The tpgsd command line interface.

Primary entry point is an interactive interpreter with a file pre-loaded
(capability parity with the reference CLI; reference:
pgsd/pgsd/__main__.py:52-171)::

    $ python -m tpgsd read trajectory.gsd

plus scriptable subcommands the reference lacks::

    $ python -m tpgsd info trajectory.gsd          # file + frame summary
    $ python -m tpgsd dump trajectory.gsd -n particles/position -f 0

Options for ``read``:

* ``-s/--schema {hoomd,none}`` - schema layer to load (default hoomd).
* ``-m/--mode`` - open mode, as accepted by :func:`tpgsd.fl.open`.
"""

import argparse
import code
import sys

from . import fl
from .hoomd import open as hoomd_open
from .version import version


def _print_err(msg=None, *args):
    print(msg, *args, file=sys.stderr)


SHELL_BANNER = """Python {python_version}
tpgsd {tpgsd_version}

File: {fn}
{extras}
The file handle is available via the "handle" variable.
For supported schema, you may access the trajectory using the "traj" variable.
Type "help(handle)" or "help(traj)" for more information."""


def main_read(args):
    """Launch a Python interpreter with an open file (reference:
    pgsd/pgsd/__main__.py:52-85)."""
    import tpgsd
    import tpgsd.hoomd

    local_ns = {
        "tpgsd": tpgsd,
        "tpgsd.hoomd": tpgsd.hoomd,
        "tpgsd.fl": fl,
    }
    attributes = {}

    if args.schema == "hoomd":
        traj = hoomd_open(args.file, mode=args.mode)
        handle = traj.file
        local_ns.update({"handle": handle, "traj": traj})
        attributes["Number of frames"] = len(traj)
    else:
        if args.mode not in ["r", "r+", "a"]:
            raise ValueError("Unsupported schema for creating a file.")
        handle = fl.open(args.file, args.mode)
        local_ns.update({"handle": handle})

    extras = "\n".join("{}: {}".format(k, v) for k, v in attributes.items())

    code.interact(
        local=local_ns,
        banner=SHELL_BANNER.format(
            python_version=sys.version,
            tpgsd_version=version,
            fn=args.file,
            extras=extras + "\n",
        ),
    )


def main_info(args):
    """Print a summary: header fields, frame count, chunk names."""
    with fl.open(args.file, "r") as f:
        print("name:", f.name)
        print("file version: %d.%d" % f.pgsd_version)
        print("application:", f.application)
        print("schema:", f.schema, "%d.%d" % f.schema_version)
        print("frames:", f.nframes)
        names = f.find_matching_chunk_names("")
        print("chunk names (%d):" % len(names))
        nframes = f.nframes
        for name in names:
            # shape from the first frame holding the chunk
            desc = ""
            for frame in range(nframes):
                if f.chunk_exists(frame, name):
                    chunk = f._find_chunk(frame, name)
                    from .format.structs import TYPE_TO_DTYPE

                    desc = "[%d x %d] %s" % (
                        int(chunk["N"]),
                        int(chunk["M"]),
                        TYPE_TO_DTYPE[int(chunk["type"])].name,
                    )
                    break
            print("  %-40s %s" % (name, desc))


def main_convert(args):
    """Export the trajectory to per-frame VTK .vtu point clouds."""
    from .vtu import DEFAULT_FIELDS, convert

    frames = None
    if args.frames:
        parts = [int(p) if p else None for p in args.frames.split(":")]
        frames = slice(*parts)
    fields = (
        [f for f in args.fields.split(",") if f] if args.fields else DEFAULT_FIELDS
    )
    convert(
        args.file,
        outdir=args.outdir,
        fields=fields,
        frames=frames,
        ascii_format=args.ascii,
    )


def main_dump(args):
    """Print one chunk of one frame as a numpy array."""
    import numpy

    with fl.open(args.file, "r") as f:
        data = f.read_chunk(frame=args.frame, name=args.name)
        numpy.set_printoptions(threshold=args.limit, edgeitems=8)
        print(data)


def main_verify(args):
    """fsck-style integrity walk; exit code 1 on any finding."""
    from . import pypgsd

    with open(args.file, "rb") as fh:
        report = pypgsd.verify(fh, deep=not args.shallow)
    print(
        "%s: %d frames, %d chunks, %d names, %.1f MB data of %.1f MB file"
        % (
            args.file,
            report["frames"],
            report["chunks"],
            report["names"],
            report["data_bytes"] / 1e6,
            report["file_size"] / 1e6,
        )
    )
    for e in report["errors"]:
        print("ERROR: " + e)
    print("OK" if report["ok"] else "CORRUPT (%d errors)" % len(report["errors"]))
    if not report["ok"]:
        sys.exit(1)


def main():
    """Entry point of the tpgsd command-line interface
    (reference: pgsd/pgsd/__main__.py:88-171)."""
    parser = argparse.ArgumentParser(
        prog="tpgsd",
        description="Readers and writers for the GSD/PGSD "
        "trajectory file format.",
    )
    parser.add_argument(
        "--version", action="store_true", help="Display the version number and exit."
    )
    parser.add_argument(
        "--debug", action="store_true", help="Show traceback on error for debugging."
    )
    subparsers = parser.add_subparsers()

    parser_read = subparsers.add_parser("read")
    parser_read.add_argument("file", type=str, help="GSD file to read.")
    parser_read.add_argument(
        "-s", "--schema", type=str, default="hoomd", choices=["hoomd", "none"],
        help="The file schema.",
    )
    parser_read.add_argument(
        "-m", "--mode", type=str, default="r",
        choices=["w", "r", "r+", "x", "a"], help="The file mode.",
    )
    parser_read.set_defaults(func=main_read)

    parser_info = subparsers.add_parser("info")
    parser_info.add_argument("file", type=str, help="GSD file to inspect.")
    parser_info.set_defaults(func=main_info)

    parser_convert = subparsers.add_parser("convert")
    parser_convert.add_argument("file", type=str, help="trajectory .gsd file")
    parser_convert.add_argument("-o", "--outdir", default=None)
    parser_convert.add_argument(
        "--fields", default=None,
        help="comma-separated particle fields (default: SPH set)",
    )
    parser_convert.add_argument("--frames", default=None,
                                help="frame slice start:stop[:step]")
    parser_convert.add_argument("--ascii", action="store_true")
    parser_convert.set_defaults(func=main_convert)

    parser_verify = subparsers.add_parser("verify")
    parser_verify.add_argument("file", type=str, help="GSD file to check.")
    parser_verify.add_argument(
        "--shallow", action="store_true",
        help="skip reading chunk payloads (index/bounds checks only)",
    )
    parser_verify.set_defaults(func=main_verify)

    parser_dump = subparsers.add_parser("dump")
    parser_dump.add_argument("file", type=str, help="GSD file to read.")
    parser_dump.add_argument("-n", "--name", type=str, required=True,
                             help="Chunk name.")
    parser_dump.add_argument("-f", "--frame", type=int, default=0,
                             help="Frame index (default 0).")
    parser_dump.add_argument("--limit", type=int, default=1000,
                             help="Print threshold before summarizing.")
    parser_dump.set_defaults(func=main_dump)

    if "--version" in sys.argv:
        print("tpgsd", version)
        sys.exit(0)

    args = parser.parse_args()

    if not hasattr(args, "func"):
        parser.print_usage()
        sys.exit(2)
    try:
        args.func(args)
    except KeyboardInterrupt:
        _print_err()
        _print_err("Interrupted.")
        if args.debug:
            raise
        sys.exit(1)
    except RuntimeWarning as warning:
        _print_err("Warning: {}".format(warning))
        if args.debug:
            raise
        sys.exit(1)
    except Exception as error:
        _print_err("Error: {}".format(error))
        if args.debug:
            raise
        sys.exit(1)
    sys.exit(0)


if __name__ == "__main__":
    main()
