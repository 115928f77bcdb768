"""Time the port's kernels against an earlier version of their sources, in turns.

    python -m nnstreamer_tpu_torch.tools.kernel_ab --parent DIR

``DIR`` holds an earlier checkout of the repository, for example one
unpacked with ``git archive <commit> | tar -x -C build/parent``.  Its
``nnstreamer_tpu_torch/csrc/nms_keep.cu`` and ``int8_matmul.cu`` are built
with the same nvcc flags as the current sources (under other library
names) and called through their plain C entry points; the current kernels
are called through their wrappers.  At the main path's shapes (``nms_keep``
at K=100 and K=1280, ``int8_matmul`` at (1,1280,1001)), each case first
checks that both versions give the same output, then times them in the
order old, new, new, old for each round: device time per call from a CUPTI
trace (``torch.profiler``, the one kernel of each of ``--calls``
back-to-back calls, L2 warm), and reports the median of the rounds.  It
prints the card's name and power limit and, last, one JSON line.  Needs
one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import build
from ..ops import kernels as K
from ..ops import nms as N


def device_ms(fn, calls: int) -> float:
    """Device time per call of ``fn`` (one kernel launch each) from a CUPTI
    trace of ``calls`` calls.  A trace that does not hold exactly one device
    activity per call has lost records (a lost record would pass for a fast
    kernel) and is taken again, up to five times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(device) == calls:
            return sum(e.device_time_total for e in device) / 1e3 / calls
    raise RuntimeError(f"the trace holds {len(device)} device activities for {calls} calls")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def nms_case(parent_lib, k: int, seed: int):
    """Random integer boxes at K=k, all valid: the chip smoke test's timed recipe."""
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 300, k), rng.integers(0, 300, k),
              rng.integers(1, 150, k), rng.integers(1, 150, k)]
    args = [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]
    args.append(torch.ones(k, dtype=torch.bool, device="cuda"))
    out = torch.empty(k, dtype=torch.bool, device="cuda")

    def old():
        err = parent_lib.nns_nms_keep(*(t.data_ptr() for t in args), out.data_ptr(), k, _stream())
        if err:
            raise RuntimeError(f"parent nms_keep: CUDA error {err}")
        return out

    def new():
        return N.pallas_nms_keep(*args)

    return f"nms_keep K={k}", old, new


def int8_case(parent_lib, m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).cuda()
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
    xs = torch.tensor(np.float32(0.01), device="cuda")
    ws = torch.from_numpy((rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")

    def old():
        err = parent_lib.nns_int8_matmul(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                                         ws.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         m, k, n, _stream())
        if err:
            raise RuntimeError(f"parent int8_matmul: CUDA error {err}")
        return out

    def new():
        return K.int8_matmul(xq, wq, xs, ws, b)

    return f"int8_matmul ({m},{k},{n})", old, new


def parent_libs(parent: Path):
    csrc = parent / "nnstreamer_tpu_torch" / "csrc"
    nms = build.load("parent_nms_keep", csrc / "nms_keep.cu")
    nms.nns_nms_keep.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    nms.nns_nms_keep.restype = ctypes.c_int
    mm = build.load("parent_int8_matmul", csrc / "int8_matmul.cu")
    mm.nns_int8_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    mm.nns_int8_matmul.restype = ctypes.c_int
    return nms, mm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of an earlier checkout of the repository")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    nms_lib, mm_lib = parent_libs(args.parent)
    cases = [nms_case(nms_lib, 100, 2), nms_case(nms_lib, 1280, 3),
             int8_case(mm_lib, 1, 1280, 1001, 4)]
    rows = []
    for name, old, new in cases:
        want, got = old().clone(), new()
        torch.cuda.synchronize()
        if not torch.equal(want, got):
            print(f"kernel_ab: {name}: the two versions disagree", file=sys.stderr)
            return 1
        times = {"old": [], "new": []}
        for _ in range(args.rounds):
            for which in ("old", "new", "new", "old"):
                times[which].append(device_ms(old if which == "old" else new, args.calls))
        old_ms, new_ms = float(np.median(times["old"])), float(np.median(times["new"]))
        rows.append(dict(case=name, old_ms=times["old"], new_ms=times["new"],
                         old_median_ms=old_ms, new_median_ms=new_ms, speedup=old_ms / new_ms))
        print(f"{name}: old {old_ms:.8f} ms, new {new_ms:.8f} ms (median of {2 * args.rounds} "
              f"each; old/new {rows[-1]['speedup']:.2f}x)", flush=True)
    print(json.dumps({"card": card, "timer": "cupti", "calls": args.calls, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
