"""``tensor_trainer``: streaming training inside a pipeline.

The port of the JAX package's ``elements/trainer.py``: frames in, a model
updated a step a frame, the learning curve out.

- The whole optimization step (forward, backward, the optimizer's update)
  is :func:`nnstreamer_tpu_torch.training.make_train_step`: on the card one
  CUDA graph per geometry, replayed a frame, over parameters and optimizer
  state that stay on the card and are updated in place (constant device
  memory over a long stream, the counterpart of the JAX package's
  donation).
- Input frames carry ``(x, y)`` as two tensors (e.g. from ``tensor_mux`` of
  a data source and a label source, the same fan-in the filter uses).
- Each step emits a frame ``[loss (float32 scalar), step (int32)]``: the loss
  a clone of the graph's loss on the card and the step a host scalar, so
  the hot path never waits on the device.
- The model's parameters are deep-copied at configure onto the model's
  device (``TorchModel.device``, the card by default; the ``(apply_fn,
  params)`` form trains on the card): the trainer's updates never touch the
  tree the caller passed in, and without a card configure raises unless
  the model asks for the CPU, as ``tensor_filter`` does.
- The capture's warm-up calls are not training steps: the step snapshots
  the parameters and the optimizer state before them and puts them back
  after the capture, so after N frames ``step_count`` is N and the
  parameters are those of N steps.
- ``state_dict()``/``load_state()`` plug into ``utils/checkpoint.py`` with
  the JAX package's leaf layout (the params tree as given, the optimizer
  state as optax's NamedTuples flattened; for Adam
  ``ScaleByAdamState(count, mu, nu)``), so a trainer checkpoint crosses
  between the two packages both ways; a restore that arrives before
  configure is applied after it.  The params tree is the model's own: a
  port MobileNet holds OIHW conv kernels where the JAX package's holds
  HWIO (``models/mobilenet_v2.params_to_jax`` converts).

Usage::

    x ──┐
        ├─ tensor_mux → tensor_trainer(model=..., optimizer="adam,lr=1e-3")
    y ──┘                  → tensor_sink          # loss stream

After (or during) the run, ``trainer.params`` returns the trained
parameters (host copies) for a ``tensor_filter``.  ``devices`` > 1 (data
parallelism over a mesh) is refused: training over the mesh is ROADMAP
item 13b.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..device import resolve_device
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec
from ..training import make_train_step, tree_flatten, tree_unflatten


def _copy_tree(tree, device: torch.device):
    """A copy of a params tree on ``device``: every tensor and numpy array
    a new tensor there, Python statics as they are."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        l.detach().to(device, copy=True) if isinstance(l, torch.Tensor)
        else torch.from_numpy(np.array(l)).to(device) if isinstance(l, np.ndarray) else l
        for l in leaves])


def _to_host(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [l.detach().cpu().numpy() if isinstance(l, torch.Tensor)
                                    else l for l in leaves])


@register_element("tensor_trainer")
class TensorTrainer(Node):
    def __init__(
        self,
        name: Optional[str] = None,
        model=None,
        loss: Any = "softmax_ce",
        optimizer: Any = "adam,lr=1e-3",
        donate: bool = True,
        devices: int = 0,
        axis: str = "dp",
    ):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.model = model  # TorchModel (apply + params) or (apply_fn, params)
        self.loss = loss
        self.optimizer = optimizer
        self.donate = donate in (True, "true", "TRUE", "1")
        self.devices = int(devices)
        self.axis = str(axis)
        self.step_count = 0
        self._params = None
        self._opt_state = None
        self._step = None
        self._last_loss = None
        self._pending_state = None  # a restore that came before configure()

    # -- negotiation --------------------------------------------------------

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 2:
            raise NegotiationError(
                f"{self.name}: trainer wants 2 tensors per frame (x, y), "
                f"got {spec.num_tensors} — mux a data and a label stream")
        if self.model is None:
            raise NegotiationError(f"{self.name}: no model set")
        if self.devices > 1:
            batch_dim = spec.tensors[0].shape[0] if spec.tensors[0].rank else None
            if batch_dim is not None and batch_dim % self.devices:
                raise NegotiationError(f"{self.name}: batch dim {batch_dim} is not divisible "
                                       f"by devices={self.devices}")
            raise NegotiationError(
                f"{self.name}: devices={self.devices}: data-parallel training over a mesh "
                "is not ported yet (ROADMAP item 13b)")
        apply_fn = getattr(self.model, "apply", None) or self.model[0]
        if self._params is None:
            params = getattr(self.model, "params", None)
            if params is None and not hasattr(self.model, "apply"):
                params = self.model[1]
            # the updates are in place: a copy keeps the caller's model whole
            self._params = _copy_tree(params, resolve_device(getattr(self.model, "device",
                                                                     "cuda")))
        init_fn, self._step = make_train_step(apply_fn, loss=self.loss,
                                              optimizer=self.optimizer, donate=self.donate)
        if self._opt_state is None:
            self._opt_state = init_fn(self._params)
        if self._pending_state is not None:
            state, self._pending_state = self._pending_state, None
            self.load_state(state)
        # out: [loss scalar f32, step int32], a learning-curve stream
        return {"src": TensorsSpec(tensors=(
            TensorSpec(dtype=np.float32, shape=()),
            TensorSpec(dtype=np.int32, shape=()),
        ), rate=spec.rate)}

    # -- streaming ----------------------------------------------------------

    def process(self, pad: Pad, frame: Frame):
        del pad
        x, y = frame.tensors[0], frame.tensors[1]
        self._params, self._opt_state, loss = self._step(self._params, self._opt_state, x, y)
        self.step_count += 1
        self._last_loss = loss  # a device scalar: no synchronization here
        return frame.with_tensors((loss, torch.tensor(self.step_count, dtype=torch.int32)))

    # -- app access ---------------------------------------------------------

    @property
    def params(self):
        """The trained parameters as host numpy (synchronizes)."""
        return _to_host(self._params)

    @property
    def last_loss(self) -> Optional[float]:
        return None if self._last_loss is None else float(self._last_loss)

    # -- checkpoint and resume (utils/checkpoint.py) ---------------------------

    def state_dict(self):
        return {"params": _to_host(self._params), "opt_state": _to_host(self._opt_state),
                "step_count": self.step_count}

    def load_state(self, state) -> None:
        """Restore a :meth:`state_dict` (of either package): the saved
        leaves, in order, into the live trees, copied into the live tensors
        (a captured step keeps reading them).  Before configure the restore
        waits: the live trees do not exist yet."""
        if self._step is None:
            self._pending_state = state
            self.step_count = int(state["step_count"])
            return

        def like(saved, current):
            leaves, treedef = tree_flatten(current)
            saved_leaves = tree_flatten(saved)[0]
            if len(saved_leaves) != len(leaves):
                raise ValueError(f"{self.name}: the checkpoint holds {len(saved_leaves)} "
                                 f"leaves, the live tree {len(leaves)}")
            out = []
            with torch.no_grad():
                for cur, new in zip(leaves, saved_leaves):
                    if isinstance(cur, torch.Tensor):
                        cur.copy_(torch.as_tensor(np.asarray(new)).reshape(cur.shape))
                        out.append(cur)
                    else:
                        out.append(new)
            return tree_unflatten(treedef, out)

        self._params = like(state["params"], self._params)
        self._opt_state = like(state["opt_state"], self._opt_state)
        self.step_count = int(state["step_count"])
