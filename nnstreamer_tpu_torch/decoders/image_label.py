"""``image_labeling`` decoder: classifier scores + label file → label text.

``option1`` is a labels file (one label per line).  Decode is an argmax over
the scores (the lowest index on ties, as numpy's and the JAX package's),
emitted as a uint8 text tensor; the label, its index and its score also ride
in ``meta``.  With whole-segment compilation the argmax runs on the card
(:meth:`ImageLabeling.device_stage`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..elements.decoder import DecoderPlugin, register_decoder
from ..spec import TensorSpec, TensorsSpec


@register_decoder("image_labeling")
class ImageLabeling(DecoderPlugin):
    def init(self, options: List[str]) -> None:
        self.labels: Optional[List[str]] = None
        if options and options[0]:
            with open(options[0], "r", encoding="utf-8") as f:
                self.labels = [ln.strip() for ln in f if ln.strip()]

    def set_labels(self, labels: List[str]) -> None:
        self.labels = list(labels)

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        if in_spec.tensors[0].rank is None:
            raise ValueError("image_labeling needs a fixed score tensor")
        return TensorsSpec(tensors=(TensorSpec(dtype=np.uint8, shape=None),), rate=in_spec.rate)

    def device_stage(self, in_spec: TensorsSpec):
        """Segment-compile lowering (``graph/segments.py``): the argmax runs
        in the filter's fused function and emits a (2,) float32 ``[index,
        score]`` tensor; the host tail only looks up the label.  Both
        argmaxes take the lowest index on ties."""
        if len(in_spec.tensors) != 1 or in_spec.tensors[0].rank is None:
            return None

        def fn(xs):
            scores = xs[0].reshape(-1)
            idx = torch.argmax(scores)
            return (torch.stack([idx.to(torch.float32), scores[idx].to(torch.float32)]),)

        return fn, TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(2,)),),
                               rate=in_spec.rate)

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        del in_spec
        # Read on the host: for a CUDA tensor this copy is the frame's one
        # synchronization with the card.
        host = frame.tensor(0).detach().to("cpu").numpy().reshape(-1)
        if self._lowered is not None:
            idx, score = int(host[0]), float(host[1])
        else:
            idx = int(np.argmax(host))
            score = float(host[idx])
        if self.labels is not None and idx < len(self.labels):
            label = self.labels[idx]
        else:
            label = str(idx)
        data = torch.from_numpy(np.frombuffer(label.encode("utf-8"), dtype=np.uint8).copy())
        out = frame.with_tensors((data,), meta=frame.meta)
        out.meta["label"] = label
        out.meta["label_index"] = idx
        out.meta["score"] = score
        return out
