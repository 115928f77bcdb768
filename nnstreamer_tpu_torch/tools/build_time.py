"""Time ``nvcc`` on kernel sources, one at a time, split by compiler phase.

    python -m nnstreamer_tpu_torch.tools.build_time [--rounds N] SRC.cu [SRC.cu ...]

Each source is compiled alone, with the port's flags
(``ops/build.py::NVCC_FLAGS``), into a library under a temporary directory
that is removed afterwards; with ``--rounds 2`` the sources run in the order
given and then in reverse, so that a drift of the machine's speed falls on
all of them alike.  ``nvcc --time`` writes each phase's time (``cicc``: C++
to PTX; ``ptxas``: PTX to SASS; the host compiler and the rest), and the
``ptxas -v`` report gives the number of kernel entries.  Prints one line a
compilation, then one JSON line: for each source its wall seconds and
seconds by phase (and nvcc's own file), a list with one entry a round,
and its entries.  Needs ``nvcc``; no GPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

from ..ops import build


def phase_seconds(csv_text: str) -> Dict[str, float]:
    """Seconds by phase from an ``nvcc --time`` file, whose header names
    the ``phase name``, ``metric`` and ``unit`` columns."""
    rows = [[c.strip() for c in row] for row in csv.reader(csv_text.splitlines()) if row]
    if not rows:
        return {}
    head = rows[0]
    phase, metric, unit = (head.index(k) for k in ("phase name", "metric", "unit"))
    scale = {"ms": 1e-3, "s": 1.0, "us": 1e-6}
    out: Dict[str, float] = {}
    for row in rows[1:]:
        name = row[phase]
        out[name] = out.get(name, 0.0) + float(row[metric]) * scale[row[unit]]
    return out


def compile_once(src: Path, work: Path) -> dict:
    times = work / "time.csv"
    times.unlink(missing_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "--time", str(times),
           "-o", str(work / "lib.so"), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{log[-4000:]}")
    text = times.read_text()
    return dict(wall_s=wall, phases_s=phase_seconds(text), csv=text,
                entries=len(build.ptxas_report(log)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=1, choices=(1, 2))
    args = ap.parse_args(argv)
    result = {str(s): dict(rounds=[]) for s in args.sources}
    order = list(args.sources) + (list(reversed(args.sources)) if args.rounds == 2 else [])
    with tempfile.TemporaryDirectory() as tmp:
        for src in order:
            r = compile_once(src, Path(tmp))
            entry = result[str(src)]
            entry["entries"] = r.pop("entries")
            entry["rounds"].append(r)
            phases = ", ".join(f"{k} {v:.3f}" for k, v in sorted(r["phases_s"].items()))
            print(f"{src}: {r['wall_s']:.3f} s wall, {entry['entries']} entries; "
                  f"by phase (s): {phases}", flush=True)
    print(json.dumps({"build_time": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
