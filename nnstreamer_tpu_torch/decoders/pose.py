"""``pose_estimation`` decoder: 14-keypoint heatmaps → skeleton overlay.

The port of the JAX package's ``decoders/pose.py``.  Its input is one
(grid_h, grid_w, 14) heatmap tensor, whose argmax per keypoint is taken on
the host, or the (14, 3) keypoints that ``models/posenet.py``'s fused
decode takes on the card.  The 13 skeleton edges are drawn, scaled to the
``option1`` canvas, into an RGBA overlay.

option1 = output ``W:H``; option2 = input grid ``W:H``; option3 = a file of
keypoint labels (one name per line), each joint then annotated with its
name in the built-in raster font.  The keypoints ride in ``meta["pose"]``
as (x, y, prob) triples in grid coordinates.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..buffer import Frame
from ..elements.decoder import DecoderPlugin, register_decoder
from ..spec import TensorSpec, TensorsSpec
from . import draw, font
from .bounding_boxes import _host, _parse_wh

POSE_SIZE = 14
# The skeleton's edges, 0-indexed: top(0)-neck(1), neck-shoulders-elbows-
# wrists, neck-hips-knees-ankles.
EDGES = [
    (0, 1),
    (1, 2), (2, 3), (3, 4),       # right arm
    (1, 5), (5, 6), (6, 7),       # left arm
    (1, 8), (8, 9), (9, 10),      # right leg
    (1, 11), (11, 12), (12, 13),  # left leg
]
_LABEL_BG = np.array([0, 0, 0, 255], np.uint8)


@register_decoder("pose_estimation")
class PoseEstimation(DecoderPlugin):
    def init(self, options: List[str]) -> None:
        opts = list(options) + [""] * (3 - len(options))
        self.width, self.height = _parse_wh(opts[0], 640, 480)
        self.i_width, self.i_height = _parse_wh(opts[1], 0, 0)
        self.labels: List[str] = []
        if opts[2]:
            with open(opts[2], "r", encoding="utf-8") as f:
                self.labels = [ln.strip() for ln in f if ln.strip()]

    @staticmethod
    def _is_fused(shape) -> bool:
        """(…,14,3): keypoints already decoded on the card."""
        return shape is not None and len(shape) >= 2 and shape[-1] == 3 \
            and shape[-2] == POSE_SIZE

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        t = in_spec.tensors[0]
        if self._is_fused(t.shape):
            if not (self.i_width and self.i_height):
                raise ValueError("pose_estimation with fused keypoints needs the grid "
                                 "size (option2=W:H) to scale coordinates")
        elif t.shape is None or t.shape[-1] != POSE_SIZE:
            raise ValueError(f"pose_estimation needs (h, w, {POSE_SIZE}) heatmaps or "
                             f"({POSE_SIZE}, 3) fused keypoints, got {t}")
        return TensorsSpec(tensors=(TensorSpec(dtype=np.uint8, shape=(self.height, self.width, 4)),),
                           rate=in_spec.rate)

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        del in_spec
        raw = _host(frame.tensor(0))  # for a CUDA tensor, the frame's one read
        if self._is_fused(raw.shape):
            kps = raw.reshape(-1, POSE_SIZE, 3)[0]
            i_w, i_h = self.i_width, self.i_height
            keypoints = [(int(x), int(y), float(p)) for x, y, p in kps]
        else:
            hm = raw.reshape(-1, raw.shape[-2], raw.shape[-1]) if raw.ndim > 3 else raw
            grid_h, grid_w = hm.shape[0], hm.shape[1]
            i_w = self.i_width or grid_w
            i_h = self.i_height or grid_h
            flat = hm.reshape(-1, POSE_SIZE)
            idx = flat.argmax(axis=0)  # the first of equal maxima
            probs = flat[idx, np.arange(POSE_SIZE)]
            ys, xs = np.unravel_index(idx, (grid_h, grid_w))
            keypoints = [(int(x), int(y), float(p)) for x, y, p in zip(xs, ys, probs)]

        canvas = draw.new_canvas(self.width, self.height)
        sx, sy = self.width / i_w, self.height / i_h
        pts = [(int(x * sx), int(y * sy)) for x, y, _ in keypoints]
        for a, b in EDGES:
            draw.draw_line(canvas, pts[a][0], pts[a][1], pts[b][0], pts[b][1], draw.WHITE)
        for i, (x, y) in enumerate(pts):
            draw.draw_dot(canvas, x, y, draw.WHITE)
            if self.labels:
                name = self.labels[i] if i < len(self.labels) else str(i)
                font.draw_label(canvas, x + 4, y - 4, name, draw.WHITE, bg=_LABEL_BG)
        out = frame.with_tensors((torch.from_numpy(canvas),), meta=frame.meta)
        out.meta["pose"] = keypoints
        return out
