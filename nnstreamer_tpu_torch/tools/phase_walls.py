"""Wall seconds of each phase of a ``chip_smoke.py``, on the card.

    python nnstreamer_tpu_torch/tools/phase_walls.py [PATH/chip_smoke.py]

Runs the script's ``main()`` with every module-level function whose name
ends in ``_phase`` timed (a phase that another calls is timed inside it
too), and prints, after the script's own output, one JSON line: the
seconds of each phase, the kernels' build (from the script's ``kernels
built in`` line) and the whole run.  It imports nothing of the port
itself, so the script under test imports the port beside it: run it by
path, not with ``-m``, to time another checkout's script (a parent commit
unpacked under ``build/``).  Exits with the script's code.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
import sys
import time
from pathlib import Path


class _Tee(io.TextIOBase):
    """Standard output passed through, and kept for the build line."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    path = Path(args[0] if args else Path(__file__).resolve().parents[2] / "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path.resolve())
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    walls = {}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                walls[name] = walls.get(name, 0.0) + time.perf_counter() - t
        return run

    for name, fn in list(vars(mod).items()):
        if name.endswith("_phase") and callable(fn):
            setattr(mod, name, timed(name, fn))
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = mod.main()
    total = time.perf_counter() - t0
    built = re.search(r"kernels built in ([0-9.]+) s", "".join(tee.text))
    print(json.dumps({"script": str(path), "rc": rc, "total_s": total,
                      "build_s": float(built.group(1)) if built else None,
                      "phase_s": walls}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
