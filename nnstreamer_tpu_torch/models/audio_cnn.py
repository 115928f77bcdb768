"""1-D conv audio classifier, the audio pipeline's model.

The port of the JAX package's ``models/audio_cnn.py``: one aggregator
window of raw samples, (window, channels), goes through a stack of stride-4
SAME convs with ReLU (bias and ReLU in the compute dtype, bf16 by default),
a global average pool over time and a dense head, to float32 logits.  The
defaults are Speech Commands v2's 12-class keyword spotting: a 16000-sample
window (1 s at 16 kHz) of one channel, channels (32, 64, 64), width 9.

Weights are random.  :func:`init_params` seeds numpy from an int (the JAX
package seeds it from a JAX key, so the two draw different weights);
:func:`params_from_jax` takes the JAX package's own params instead.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..device import resolve_device
from ..spec import TensorSpec, TensorsSpec
from .layers import Params, conv1d, dense, ensure_batched

STRIDE = 4
WIDTH = 9


def _init_tree(seed: int, num_classes: int, channels: Tuple[int, ...], width: int,
               in_channels: int) -> Params:
    """Random params in the JAX package's layout: (width, in, out) conv
    kernels, numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(shape, stddev):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(stddev)

    convs = []
    cin = in_channels
    for cout in channels:
        convs.append({"w": normal((width, cin, cout), np.sqrt(2.0 / (width * cin))),
                      "b": np.zeros((cout,), np.float32)})
        cin = cout
    return {"convs": convs,
            "head": {"w": normal((cin, num_classes), np.sqrt(1.0 / cin)),
                     "b": np.zeros((num_classes,), np.float32)}}


def _tensor(a: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from the JAX package's params tree, whose leaves
    the caller has turned into numpy arrays: conv kernels go from (width,
    in, out) to torch's (out, in, width); the dense head stays (in, out)."""
    dev = resolve_device(device)
    return {
        "convs": [{"w": _tensor(np.asarray(c["w"]).transpose(2, 1, 0), dev),
                   "b": _tensor(c["b"], dev)} for c in tree["convs"]],
        "head": {"w": _tensor(tree["head"]["w"], dev), "b": _tensor(tree["head"]["b"], dev)},
    }


def init_params(seed: int = 0, num_classes: int = 12, channels: Tuple[int, ...] = (32, 64, 64),
                width: int = WIDTH, in_channels: int = 1, device="cuda") -> Params:
    """Random params from an int seed, in the port's layout on ``device``."""
    return params_from_jax(_init_tree(seed, num_classes, tuple(channels), width, in_channels),
                           device)


def apply(params: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(samples, channels) or (N, samples, channels) audio → (classes,) or
    (N, classes) float32 logits."""
    x, squeezed = ensure_batched(x, 3)
    y = x.to(dtype).permute(0, 2, 1)  # NWC → NCW view
    for p in params["convs"]:
        y = torch.relu(conv1d(p, y, stride=STRIDE, dtype=dtype))
    # the pool accumulates in float32 and rounds to the compute dtype, as
    # jnp.mean does over bf16
    y = y.to(torch.float32).mean(dim=2).to(dtype)
    out = dense(params["head"], y, dtype=dtype).to(torch.float32)
    return out[0] if squeezed else out


def build(num_classes: int = 12, window: int = 16000, in_channels: int = 1,
          channels: Tuple[int, ...] = (32, 64, 64), dtype=torch.bfloat16, seed: int = 0,
          params: Optional[Params] = None, in_dtype=np.float32, device="cuda") -> TorchModel:
    """A stream-ready classifier: one frame is one aggregator window of
    ``(window, in_channels)`` samples, normalized upstream (the transform
    folds into the filter's function).  ``params``, when given, is a tree
    in the JAX package's layout (numpy leaves, see :func:`params_from_jax`)."""
    tree = params if params is not None else _init_tree(seed, num_classes, tuple(channels),
                                                       WIDTH, in_channels)
    return TorchModel(
        apply=lambda p, x: apply(p, x, dtype=dtype),
        params=params_from_jax(tree, device),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.dtype(in_dtype),
                                             shape=(window, in_channels))),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(num_classes,))),
        name=f"audio_cnn_{'x'.join(map(str, channels))}", device=device,
    )
