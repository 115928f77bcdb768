"""LSTM models, the recurrent pipelines' (BASELINE.md config 4 and 4b).

The port of the JAX package's ``models/lstm.py``, in two forms:

- :func:`build_cell`: one LSTM step as a stream filter, (h, c, x) → (h',
  c'), for a cycle through repo slots (config 4).  The state stays on the
  card around the cycle.
- :func:`build_sequence`: a whole window, (T, I) or (B, T, I) → (T, H) or
  (B, T, H) (config 4b).  The JAX package scans the steps (``lax.scan``);
  here the window's input products are one GEMM, then a loop of ``seq_len``
  steps, which the filter's CUDA graph captures whole.

Float32 throughout; TF32 stays off (PyTorch's default for matmuls), so a
product on the card rounds as on the CPU.  Weights are random:
:func:`init_tree` seeds numpy from an int; :func:`params_from_jax` takes
the JAX package's own params instead.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..spec import TensorSpec, TensorsSpec
from . import mobilenet_v2
from .layers import Params


def init_tree(seed: int, input_size: int, hidden_size: int) -> Params:
    """Random params in the JAX package's layout: (in, 4H) and (H, 4H)
    kernels, zero biases, and ``hidden_size``."""
    rng = np.random.default_rng(seed)

    def dense(cin, cout):
        w = rng.standard_normal((cin, cout), dtype=np.float32) * np.float32(np.sqrt(1.0 / cin))
        return {"w": w, "b": np.zeros((cout,), np.float32)}

    return {"wx": dense(input_size, 4 * hidden_size), "wh": dense(hidden_size, 4 * hidden_size),
            "hidden_size": hidden_size}


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from the JAX package's tree (numpy leaves)."""
    return mobilenet_v2.params_from_jax(tree, device)


def init_params(seed: int = 0, input_size: int = 64, hidden_size: int = 64,
                device="cuda") -> Params:
    return params_from_jax(init_tree(seed, input_size, hidden_size), device)


def _gates_step(params: Params, h, c, xw):
    """One step from the input's product ``xw = x @ wx.w + wx.b``."""
    hs = params["hidden_size"]
    gates = xw + h @ params["wh"]["w"] + params["wh"]["b"]
    i, f, g, o = (gates[..., k * hs:(k + 1) * hs] for k in range(4))
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def cell_step(params: Params, h, c, x):
    """One LSTM step (batched or not: shapes (..., H) and (..., I))."""
    return _gates_step(params, h, c, x @ params["wx"]["w"] + params["wx"]["b"])


def build_cell(input_size: int = 64, hidden_size: int = 64, batch: Optional[int] = None,
               seed: int = 0, params: Optional[Params] = None, device="cuda") -> TorchModel:
    """Stream filter: (h, c, x) → (h', c') for a repo-slot recurrence.
    ``params``, when given, is a tree in the JAX package's layout."""
    tree = params if params is not None else init_tree(seed, input_size, hidden_size)
    hshape: Tuple[int, ...] = (hidden_size,) if batch is None else (batch, hidden_size)
    xshape: Tuple[int, ...] = (input_size,) if batch is None else (batch, input_size)
    return TorchModel(
        apply=cell_step, params=params_from_jax(tree, device),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=hshape, name="h"),
                                  TensorSpec(dtype=np.float32, shape=hshape, name="c"),
                                  TensorSpec(dtype=np.float32, shape=xshape, name="x")),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=hshape),
                                   TensorSpec(dtype=np.float32, shape=hshape)),
        name="lstm_cell", device=device,
    )


def run_sequence(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """(…, T, I) → (…, T, H): zero state, ``T`` steps, every step's h."""
    hs = params["hidden_size"]
    h = xs.new_zeros(xs.shape[:-2] + (hs,))
    c = torch.zeros_like(h)
    xw = xs @ params["wx"]["w"] + params["wx"]["b"]
    out = []
    for t in range(xs.shape[-2]):
        h, c = _gates_step(params, h, c, xw[..., t, :])
        out.append(h)
    return torch.stack(out, dim=-2)


def build_sequence(input_size: int = 64, hidden_size: int = 64, seq_len: int = 32,
                   batch: Optional[int] = None, seed: int = 0,
                   params: Optional[Params] = None, device="cuda") -> TorchModel:
    """Whole-window LSTM: (T, I) or (B, T, I) → (T, H) or (B, T, H)."""
    tree = params if params is not None else init_tree(seed, input_size, hidden_size)
    lead: Tuple[int, ...] = (batch,) if batch is not None else ()
    return TorchModel(
        apply=run_sequence, params=params_from_jax(tree, device),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=lead + (seq_len, input_size))),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32,
                                              shape=lead + (seq_len, hidden_size))),
        name="lstm_sequence", device=device,
    )
