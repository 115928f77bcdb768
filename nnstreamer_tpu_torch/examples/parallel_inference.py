"""Model-parallel streaming inference: the three in-model sharding modes.

The port of the JAX package's ``examples/pipelines/parallel_inference.py``:
the same streaming surface three ways, each through the ordinary
``tensor_filter`` element (model parallelism is a property of the model's
function, not of the graph):

1. **ep**: a switch-MoE transformer (``transformer.build(moe_experts=n)``)
   with its experts split over an ``ep`` mesh; tokens route by
   capacity-bounded dispatch;
2. **pp**: the same encoder depth pipelined over a ``pp`` mesh
   (``transformer.build_pipelined``): GPipe microbatches move stage to
   stage while the stream keeps feeding;
3. **sp**: ring attention over the sequence of long windows
   (``attn="ring"``), fed from ``tensor_aggregator``.

The meshes span ``n`` devices: every card there is, or with ``--shards n``
that many copies of one device (``parallel.mesh.force_device_count``), so
one card, or the CPU, runs the real n-shard algorithms.

Run: ``python -m nnstreamer_tpu_torch.examples.parallel_inference`` (on the
card; ``--device cpu`` on the host).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import nnstreamer_tpu_torch as nns
from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.models import transformer
from nnstreamer_tpu_torch.parallel import mesh as pmesh


def stream(desc: str, model, frames, label: str) -> list:
    """``frames`` through ``desc`` (a ``datasrc name=s`` … ``tensor_filter
    name=f`` … ``tensor_sink name=out`` string) with ``model``; the outputs
    on the host."""
    got = []
    p = nns.parse_launch(desc)
    p["s"].data = [torch.from_numpy(f) for f in frames]
    p["f"].model = model
    p["out"].connect("new-data", lambda f: got.append(f.tensors[0].float().cpu().numpy()))
    p.run(timeout=300)
    print(f"{label}: {len(got)} frames, out {got[0].shape}")
    return got


def main(device: str = "cuda", shards: int = 0) -> dict:
    dev = resolve_device(device)
    if shards:
        pmesh.force_device_count(shards, dev)
    try:
        devs = pmesh.visible_devices()
        n = min(8, len(devs))
        rng = np.random.default_rng(0)
        plain = "datasrc name=s ! tensor_filter framework=torch name=f ! tensor_sink name=out"

        # 1) expert parallelism: the experts' weights split over the ep axis once
        ep = pmesh.make_mesh((n,), ("ep",), devs)
        moe = transformer.build(seq_len=16, d_in=8, n_out=4, d_model=32, n_heads=4,
                                n_layers=2, moe_experts=n, moe_mesh=ep, moe_axis="ep",
                                device=dev)
        out = {"ep": stream(plain, moe, [rng.standard_normal((16, 8)).astype(np.float32)
                                         for _ in range(4)], "ep-moe")}

        # 2) pipeline parallelism: n stages of one block each
        pp = pmesh.make_mesh((n,), ("pp",), devs)
        gp = transformer.build_pipelined(pp, "pp", seq_len=8, d_in=8, n_out=4, d_model=32,
                                         n_heads=4, n_layers=n, batch=2 * n, device=dev)
        out["pp"] = stream(plain, gp, [rng.standard_normal((2 * n, 8, 8)).astype(np.float32)
                                       for _ in range(3)], "pp-gpipe")

        # 3) sequence parallelism: ring attention over aggregated windows
        sp = pmesh.make_mesh((n,), ("sp",), devs)
        ring = transformer.build(seq_len=8 * n, d_in=8, n_out=4, d_model=32, n_heads=4,
                                 n_layers=1, attn="ring", mesh=sp, device=dev)
        windows = ("datasrc name=s ! tensor_aggregator frames-in=1 "
                   f"frames-out={8 * n} frames-dim=1 ! tensor_filter framework=torch name=f "
                   "! tensor_sink name=out")
        out["sp"] = stream(windows, ring, [rng.standard_normal((1, 8)).astype(np.float32)
                                           for _ in range(16 * n)], "sp-ring")
        return out
    finally:
        if shards:
            pmesh.force_device_count(None)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0,
                    help="see this many copies of the device (0: the devices there are)")
    args = ap.parse_args()
    main(args.device, args.shards)
