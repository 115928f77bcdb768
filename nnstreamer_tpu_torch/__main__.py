"""``python -m nnstreamer_tpu_torch "<pipeline>"``: the gst-launch analog.

The port of the JAX package's CLI (``nns-launch``).  The reference's main
habit is ``gst-launch-1.0 videotestsrc ! ... ! tensor_sink``; this is the
same one-liner for the port:

    python -m nnstreamer_tpu_torch "videotestsrc num-buffers=16 width=224 \\
        height=224 ! tensor_converter ! tensor_transform \\
        mode=arithmetic option=typecast:float32,div:255.0 ! \\
        tensor_sink name=out"

Every named ``tensor_sink`` gets a one-line report a frame (shapes, pts;
the ``-v`` habit); ``--quiet`` silences it.  ``--dot FILE`` writes the
negotiated graph (the GST_DEBUG_DUMP_DOT_DIR analog), ``--stats`` prints
each node's invoke latencies after EOS.  ``--device`` (``cuda`` by
default; ``cpu`` for the host) sets ``[filter] torch_device``, where a
model named in the string loads, before the string is parsed; with no GPU,
``--device cuda`` raises as ``resolve_device`` does.  Elements that take
``device=`` themselves (``tensor_transform``) are given it in the string.
Exit codes: 0 on success, 1 on a pipeline error or an unwritable
``--dot``, 2 on a parse error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("pipeline", help="pipeline description (parse_launch grammar)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="max seconds to run (default 300)")
    ap.add_argument("--quiet", action="store_true", help="no per-frame sink reports")
    ap.add_argument("--dot", metavar="FILE", default=None,
                    help="write the negotiated pipeline graph (Graphviz)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-node invoke latencies after EOS")
    ap.add_argument("--device", default="cuda", metavar="NAME",
                    help="where models named in the string live: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .device import resolve_device

    os.environ["NNSTPU_FILTER_TORCH_DEVICE"] = resolve_device(args.device).type

    from . import parse_launch
    from .elements.sink import TensorSink
    from .spec import dtype_name

    if args.stats:
        from .utils import profiling

        profiling.enable(True)

    try:
        p = parse_launch(args.pipeline)
    except Exception as exc:  # noqa: BLE001 - CLI surface: message, rc 2
        print(f"parse error: {exc}", file=sys.stderr)
        return 2

    counts = {}
    if not args.quiet:
        def reporter(name):
            def cb(frame):
                counts[name] = counts.get(name, 0) + 1
                shapes = " ".join(f"{dtype_name(t.dtype)}{tuple(t.shape)}"
                                  for t in frame.tensors)
                print(f"{name}: frame {counts[name]} pts={frame.pts} {shapes}")
            return cb

        for name, node in p.nodes.items():
            if isinstance(node, TensorSink):
                node.connect("new-data", reporter(name))

    def dump_debug() -> bool:
        """On success and on a pipeline error alike (a failing run is when
        the graph and the latencies are wanted).  False if a requested
        file could not be written: the success path then exits 1."""
        ok = True
        if args.dot:
            try:
                with open(args.dot, "w") as f:
                    f.write(p.to_dot())
                print(f"pipeline graph -> {args.dot}")
            except Exception as exc:  # noqa: BLE001
                print(f"dot dump failed: {exc}", file=sys.stderr)
                ok = False
        if args.stats:
            for name, st in sorted(p.stats().items()):
                print(f"{name}: {st}")
        return ok

    t0 = time.perf_counter()
    try:
        p.run(timeout=args.timeout)
    except Exception as exc:  # noqa: BLE001
        print(f"pipeline error: {exc}", file=sys.stderr)
        dump_debug()
        return 1
    wall = time.perf_counter() - t0
    total = sum(counts.values())
    if not args.quiet:
        print(f"EOS after {wall:.2f}s" + (f"; {total} sink frames" if total else ""))
    return 0 if dump_debug() else 1


if __name__ == "__main__":
    sys.exit(main())
