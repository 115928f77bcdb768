"""Stop ``torch.profiler`` while another thread replays a CUDA graph (ROADMAP C17).

    python -m nnstreamer_tpu_torch.tools.profiler_stop_probe [--runs 2]

Each run is a child process with a time limit, in one of two forms, taken
in turns (plain, gated, plain, gated, ...):

- it opens 18 short profiler sessions over 16 replays each of a graph of
  10 kernels, opened in turns by nothing, a 0.25 s sleep, 8 eager kernels,
  3 replays of a one-kernel graph, 2 of another 10-kernel graph (the graphs
  captured before the first session), and reads each session's events;
  then it captures a graph of 750 kernels and starts a thread that replays
  it every 2 ms, and a thread that ticks every 5 ms;
- it then profiles 0.5 s of those replays twice: the session's start, a
  ``torch.cuda.synchronize``, the session's stop, the stop's wall time, and
  the longest gap between two ticks (how long the stop held the GIL);
- ``gated``: each replay runs inside ``obs.launch_gate.launching`` and the
  start and stop inside ``obs.launch_gate.switching``, as the port does.

A child still running at the limit is killed and reported as a hang.  It
prints the card's name and power limit, a line a run, and last one JSON
line.  Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

LIMIT_S = 75
WINDOW_S = 0.5


def make_graph(torch, kernels: int, n: int):
    x = torch.zeros(n, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            y = x
            for _ in range(kernels):
                y = y * 1.0001
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x
        for _ in range(kernels):
            y = y * 1.0001
    torch.cuda.synchronize()
    return g


def child(gated: bool) -> None:
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.obs.launch_gate import launching, switching

    launch = launching if gated else contextlib.nullcontext
    switch = switching if gated else contextlib.nullcontext
    graph, other, one = (make_graph(torch, k, 1 << 16) for k in (10, 10, 1))
    for opening in ("none", "sleep", "eager", "one", "other", "none"):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if opening == "sleep":
                    time.sleep(0.25)
                elif opening == "eager":
                    z = torch.zeros(16, device="cuda")
                    for _ in range(8):
                        z.add_(1)
                    torch.cuda.synchronize()
                elif opening in ("one", "other"):
                    g, n = (one, 3) if opening == "one" else (other, 2)
                    for _ in range(n):
                        g.replay()
                    torch.cuda.synchronize()
                for _ in range(16):
                    graph.replay()
                torch.cuda.synchronize()
            prof.events()
    big = make_graph(torch, 750, 1 << 12)
    for _ in range(2):
        done = threading.Event()
        launches, gap = [0], [0.0]

        def replay():
            while not done.is_set():
                with launch():
                    big.replay()
                launches[0] += 1
                time.sleep(0.002)

        def tick():
            last = time.perf_counter()
            while not done.is_set():
                time.sleep(0.005)
                now = time.perf_counter()
                gap[0] = max(gap[0], now - last)
                last = now

        replayer = threading.Thread(target=replay)
        replayer.start()
        time.sleep(0.3)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with switch():
            prof.start()
        ticker = threading.Thread(target=tick)
        ticker.start()
        time.sleep(WINDOW_S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with switch():
            prof.stop()
        stop_s = time.perf_counter() - t0
        done.set()
        replayer.join()
        ticker.join()
        print(json.dumps({"stop_s": stop_s, "gil_gap_s": gap[0], "launches": launches[0]}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2, help="runs of each form")
    ap.add_argument("--child", choices=("plain", "gated"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child == "gated")
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profiler_stop_probe: no CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    runs = []
    for i in range(2 * args.runs):
        form = ("plain", "gated")[i % 2]
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.tools.profiler_stop_probe",
                                "--child", form], capture_output=True, text=True, timeout=LIMIT_S)
            windows = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
            run = dict(form=form, outcome="ok" if r.returncode == 0 else f"rc {r.returncode}",
                       windows=windows)
        except subprocess.TimeoutExpired:
            run = dict(form=form, outcome=f"hang (killed at {LIMIT_S} s)", windows=[])
        run["wall_s"] = time.perf_counter() - t0
        runs.append(run)
        print(f"{form}: {run['outcome']}, {run['wall_s']:.1f} s; windows {run['windows']} "
              f"[{card}]", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
