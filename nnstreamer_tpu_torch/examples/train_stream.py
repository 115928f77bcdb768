"""Streaming training: tensor_trainer learns from a live (x, y) stream.

The port of the JAX package's ``examples/pipelines/train_stream.py``: the
trainer runs forward, backward and the optimizer's update a frame (on the
card one CUDA graph, replayed), keeps the parameters and the optimizer
state on the device between steps, and streams the loss curve to
``tensor_sink``.  At EOS the trained parameters go to a ``tensor_filter``
and are validated: the train → deploy loop inside one process.

    x ──┐
        ├─ tensor_mux → tensor_trainer → tensor_sink   (loss curve)
    y ──┘

Run: ``python -m nnstreamer_tpu_torch.examples.train_stream`` (on the card;
``--device cpu`` on the host).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import nnstreamer_tpu_torch as nns
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.trainer import TensorTrainer
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


def main(device: str = "cuda") -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, d, cls, steps = 32, 8, 4, 80
    w_true = rng.standard_normal((d, cls)).astype(np.float32)

    xs, ys = [], []
    for _ in range(steps):
        x = rng.standard_normal((n, d)).astype(np.float32)
        xs.append(torch.from_numpy(x))
        ys.append(torch.from_numpy(np.argmax(x @ w_true, axis=-1).astype(np.int32)))

    spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(n, d)))
    model = TorchModel(apply=lambda p, x: x @ p, params=torch.zeros(d, cls, device=dev),
                       input_spec=spec, device=dev)

    curve = []
    p = nns.Pipeline()
    xsrc = p.add(DataSrc(data=xs, name="x"))
    ysrc = p.add(DataSrc(data=ys, name="y"))
    mux = p.add(nns.make("tensor_mux", sync_mode="nosync"))
    trainer = p.add(TensorTrainer(model=model, loss="softmax_ce", optimizer="adam,lr=0.1"))
    sink = p.add(TensorSink())
    sink.connect("new-data", lambda f: curve.append(float(f.tensor(0))))
    p.link(xsrc, f"{mux.name}.sink_0")
    p.link(ysrc, f"{mux.name}.sink_1")
    p.link_chain(mux, trainer, sink)
    p.run(timeout=300)

    print(f"steps: {trainer.step_count}  loss: {curve[0]:.3f} -> {curve[-1]:.3f}")
    assert curve[-1] < 0.3 * curve[0], "did not learn"

    # deploy: the trained params into a streaming filter, check accuracy
    trained = TorchModel(apply=lambda p_, x: x @ p_,
                         params=torch.from_numpy(trainer.params).to(dev),
                         input_spec=spec, device=dev)
    x_test = rng.standard_normal((n, d)).astype(np.float32)
    got = []
    p2 = nns.Pipeline()
    src = p2.add(DataSrc(data=[torch.from_numpy(x_test)]))
    filt = p2.add(TensorFilter(framework="torch", model=trained))
    out = p2.add(TensorSink())
    out.connect("new-data", lambda f: got.append(f.tensor(0).cpu().numpy()))
    p2.link_chain(src, filt, out)
    p2.run(timeout=120)
    acc = float(np.mean(np.argmax(got[0], -1) == np.argmax(x_test @ w_true, -1)))
    print(f"deployed accuracy: {acc:.2f}")
    assert acc > 0.8
    print("train_stream OK")
    return {"steps": trainer.step_count, "first_loss": curve[0], "last_loss": curve[-1],
            "accuracy": acc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
