"""Time a captured training step with the two forms of ReLU6's gradient.

    python -m nnstreamer_tpu_torch.tools.relu6_ab [--batch 32] [--rounds 4]

The port's ``models/layers.relu6`` gives ``jnp.clip``'s gradient (half at
exactly 0 and 6) through a custom autograd function over one ``clamp``.
The other way to the same gradient is ``jnp.clip``'s own construction,
``torch.minimum(torch.maximum(x, 0), 6)``.  This tool captures MobileNet-v2
1.0's training step (224x224, bfloat16 apply, ``sgd,lr=0.001,momentum=0.9``,
``training.make_train_step``) once with each form, checks that the two
give the same loss, and times ``--steps`` replays of each with CUDA events,
the forms in turns (A, B, then B, A) for ``--rounds`` rounds.  It prints
the card's name and power limit and, last, one JSON line with the medians.
Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import training
from ..models import layers, mobilenet_v2

OPTIMIZER = "sgd,lr=0.001,momentum=0.9"
CLASSES = 1001


def relu6_maxmin(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def captured_step(relu6, x, y):
    """A warm captured step of a fresh model with ``relu6`` as the layers'
    ReLU6 (looked up at each call, so the capture holds it), its state and
    its first loss."""
    layers.relu6, saved = relu6, layers.relu6
    try:
        params = mobilenet_v2.init_params(seed=0, num_classes=CLASSES, device="cuda")
        init, step = training.make_train_step(
            lambda p, a: mobilenet_v2.apply(p, a, dtype=torch.bfloat16), "softmax_ce",
            OPTIMIZER)
        state = [params, init(params)]
        state[0], state[1], loss = step(state[0], state[1], x, y)
        return step, state, float(loss)
    finally:
        layers.relu6 = saved


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("relu6_ab: no CUDA GPU")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (args.batch, 224, 224, 3)).astype(np.float32))
    x = x.cuda()
    y = torch.from_numpy(rng.integers(0, CLASSES, args.batch).astype(np.int32))
    forms = {"function": layers.relu6, "maxmin": relu6_maxmin}
    steps = {name: captured_step(f, x, y) for name, f in forms.items()}
    first = {name: s[2] for name, s in steps.items()}
    if first["function"] != first["maxmin"]:
        raise SystemExit(f"relu6_ab: the two forms' first losses differ: {first}")
    ms = {name: [] for name in forms}
    for r in range(args.rounds):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            step, state, _ = steps[name]
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.steps):
                state[0], state[1], _ = step(state[0], state[1], x, y)
            stop.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(stop) / args.steps)
    out = {"card": card, "batch": args.batch, "first_loss": first, "ms_a_step": ms,
           "median_ms_a_step": {k: float(np.median(v)) for k, v in ms.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
