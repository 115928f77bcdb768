"""``bounding_boxes`` decoder: SSD detector outputs → RGBA overlay video.

The port of the JAX package's decoder, with its three sub-modes:

- ``tflite-ssd``: 2 tensors, box encodings ``(#boxes, 4)`` and class logits
  ``(#boxes, #labels)``, decoded against a box-priors file (4 rows of
  ycenter/xcenter/h/w) with the reference's constants (sigmoid threshold
  .5, scales 10/10/5/5, the first class at or above the threshold claims
  the box), then greedy IoU-0.5 NMS over the 100 most probable boxes.
- ``fused-ssd``: 1 tensor ``(K, 6)`` ``[x, y, w, h, class, score]`` from
  the model's own decode head (``models/ssd_mobilenet.decode_topk``).
- ``tf-ssd``: 4 tensors, num_detections, classes, scores and normalized
  ``(ymin, xmin, ymax, xmax)`` boxes; threshold .5, truncating pixels.

Options: option1 = sub-mode, option2 = label file, option3 = priors file
(tflite-ssd), option4 = output ``W:H``, option5 = model input ``W:H``.
Detections also ride in ``meta["objects"]``.

The host decode is numpy on the tensors read back from the card.  With
whole-segment compilation (``graph/segments.py``), :meth:`BoundingBoxes.
device_stage` moves the tflite-ssd decode (or the fused-ssd quantize), the
sort and the NMS into the filter's fused function on the card, and the
host then reads one small ``(K, 6)`` tensor and only draws.  :func:`px` is
the one float→pixel rule of both paths: round half up in float32.

Each path divides as its counterpart in the JAX package does: the host
decode in numpy (IEEE division), the device stage by a multiply with the
literal's float32 reciprocal (XLA's rewrite of a division by a constant).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..elements.decoder import DecoderPlugin, register_decoder
from ..ops.kernels import _reciprocal
from ..spec import TensorSpec, TensorsSpec
from . import draw, font

DETECTION_THRESHOLD = 0.5
Y_SCALE, X_SCALE, H_SCALE, W_SCALE = 10.0, 10.0, 5.0, 5.0
THRESHOLD_IOU = 0.5
# NMS considers at most this many highest-prob candidates; the fused head's
# top-k bounds its own candidate set.
PRE_NMS_TOP_K = 100
_F32 = np.dtype(np.float32)


def px(v, size: int) -> int:
    """float coordinate × pixel size → int pixel, round half up in float32.
    The device stage computes the same as ``floor(v·size + 0.5)``."""
    return int(np.floor(np.float32(v) * np.float32(size) + np.float32(0.5)))


@dataclasses.dataclass
class DetectedObject:
    class_id: int
    x: int
    y: int
    width: int
    height: int
    prob: float
    label: Optional[str] = None


def load_box_priors(path: str) -> np.ndarray:
    """4×N priors (ycenter, xcenter, h, w rows)."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    if len(rows) < 4:
        raise ValueError(f"box priors file {path!r} needs >= 4 rows, got {len(rows)}")
    n = min(len(r) for r in rows[:4])
    return np.array([r[:n] for r in rows[:4]], dtype=np.float32)


def decode_tflite_ssd(locations: np.ndarray, raw_scores: np.ndarray, priors: np.ndarray,
                      i_width: int, i_height: int) -> List[DetectedObject]:
    """Host decode: the first class (index ≥ 1) whose sigmoid score is at
    least .5 claims the box."""
    n = min(locations.shape[0], raw_scores.shape[0], priors.shape[1])
    loc = locations[:n].astype(np.float32)
    scores = 1.0 / (1.0 + np.exp(-raw_scores[:n].astype(np.float32)))
    pri = priors[:, :n]

    ycenter = loc[:, 0] / Y_SCALE * pri[2] + pri[0]
    xcenter = loc[:, 1] / X_SCALE * pri[3] + pri[1]
    h = np.exp(loc[:, 2] / H_SCALE) * pri[2]
    w = np.exp(loc[:, 3] / W_SCALE) * pri[3]
    ymin = ycenter - h / 2.0
    xmin = xcenter - w / 2.0

    above = scores[:, 1:] >= DETECTION_THRESHOLD  # class 0 is background
    valid = above.any(axis=1)
    first_cls = above.argmax(axis=1) + 1  # argmax → first True
    out: List[DetectedObject] = []
    for d in np.nonzero(valid)[0]:
        c = int(first_cls[d])
        out.append(DetectedObject(
            class_id=c,
            x=max(0, px(xmin[d], i_width)),
            y=max(0, px(ymin[d], i_height)),
            width=px(w[d], i_width),
            height=px(h[d], i_height),
            prob=float(scores[d, c]),
        ))
    return out


def iou(a: DetectedObject, b: DetectedObject) -> float:
    x1, y1 = max(a.x, b.x), max(a.y, b.y)
    x2 = min(a.x + a.width, b.x + b.width)
    y2 = min(a.y + a.height, b.y + b.height)
    w, h = max(0, x2 - x1 + 1), max(0, y2 - y1 + 1)
    inter = float(w * h)
    union = a.width * a.height + b.width * b.height - inter
    return max(inter / union, 0.0) if union > 0 else 0.0


def nms(objs: List[DetectedObject],
        pre_top_k: Optional[int] = PRE_NMS_TOP_K) -> List[DetectedObject]:
    """Greedy IoU-0.5 suppression over the ``pre_top_k`` most probable
    candidates (None: all of them)."""
    objs = sorted(objs, key=lambda o: -o.prob)
    if pre_top_k is not None:
        objs = objs[:pre_top_k]
    keep = [True] * len(objs)
    for i in range(len(objs)):
        if not keep[i]:
            continue
        for j in range(i + 1, len(objs)):
            if keep[j] and iou(objs[i], objs[j]) > THRESHOLD_IOU:
                keep[j] = False
    return [o for o, k in zip(objs, keep) if k]


def _host(t) -> np.ndarray:
    """A frame tensor as a float32 numpy array on the host; for a CUDA
    tensor this copy is the frame's synchronization with the card."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").numpy()
    return np.asarray(t, dtype=np.float32)


def _px_device(v: torch.Tensor, size: int) -> torch.Tensor:
    """:func:`px` on a tensor, as float32 integer values."""
    return torch.floor(v * float(size) + 0.5)


@register_decoder("bounding_boxes")
class BoundingBoxes(DecoderPlugin):
    def init(self, options: List[str]) -> None:
        opts = list(options) + [""] * (5 - len(options))
        self.submode = opts[0] or "tflite-ssd"
        if self.submode not in ("tflite-ssd", "tf-ssd", "fused-ssd"):
            raise ValueError(f"bounding_boxes: unknown sub-mode {self.submode!r}")
        self.labels: Optional[List[str]] = None
        if opts[1]:
            with open(opts[1], "r", encoding="utf-8") as f:
                self.labels = [ln.strip() for ln in f if ln.strip()]
        self.priors: Optional[np.ndarray] = None
        if opts[2]:
            self.priors = load_box_priors(opts[2])
        self.width, self.height = _parse_wh(opts[3], 640, 480)
        self.i_width, self.i_height = _parse_wh(opts[4], 300, 300)

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        n = len(in_spec.tensors)
        if self._lowered is not None:
            # decode and NMS ran in the filter; the input is the (K, 6) rows
            if n != 1:
                raise ValueError("lowered bounding_boxes needs 1 detections tensor")
        elif self.submode == "tflite-ssd":
            if n != 2:
                raise ValueError("tflite-ssd needs 2 tensors (boxes, scores)")
            if self.priors is None:
                raise ValueError("tflite-ssd needs a box-priors file (option3)")
        elif self.submode == "fused-ssd":
            if n != 1:
                raise ValueError("fused-ssd needs 1 tensor (topk detections)")
        elif n != 4:
            raise ValueError("tf-ssd needs 4 tensors (num, classes, scores, boxes)")
        return TensorsSpec(
            tensors=(TensorSpec(dtype=np.uint8, shape=(self.height, self.width, 4)),),
            rate=in_spec.rate,
        )

    def device_stage(self, in_spec: TensorsSpec):
        """The segment-compile lowering: ``(fn(xs) -> (det,), spec)``, or
        None to refuse (tf-ssd, open shapes).  ``det`` is ``(K, 6)`` rows
        ``[x, y, w, h, class, prob]`` in integer-valued float32 pixels,
        sorted by prob, with the prob of an invalid or suppressed row set
        to 0; :meth:`_detect` then only thresholds."""
        from ..ops import nms as nms_ops

        keep_impl = nms_ops.pallas_nms_keep
        i_w, i_h = self.i_width, self.i_height
        ts = in_spec.tensors

        if self.submode == "tflite-ssd":
            if len(ts) != 2 or self.priors is None:
                return None
            s0, s1 = ts[0].shape, ts[1].shape
            if ts[0].rank != 2 or ts[1].rank != 2 or None in s0 or None in s1 or s1[1] < 2:
                return None
            n = min(s0[0], s1[0], self.priors.shape[1])
            if n < 1:
                return None
            k = min(n, PRE_NMS_TOP_K)
            pri_np = np.ascontiguousarray(self.priors[:, :n], np.float32)
            inv_y, inv_x = _reciprocal(Y_SCALE, _F32), _reciprocal(X_SCALE, _F32)
            inv_h, inv_w = _reciprocal(H_SCALE, _F32), _reciprocal(W_SCALE, _F32)
            cached = {}

            def fn(xs):
                loc = xs[0][:n].to(torch.float32)
                dev = loc.device
                pri = cached.get(dev)
                if pri is None:
                    pri = cached[dev] = torch.from_numpy(pri_np).to(dev)
                scores = 1.0 / (1.0 + torch.exp(-xs[1][:n].to(torch.float32)))
                ycenter = loc[:, 0] * inv_y * pri[2] + pri[0]
                xcenter = loc[:, 1] * inv_x * pri[3] + pri[1]
                h = torch.exp(loc[:, 2] * inv_h) * pri[2]
                w = torch.exp(loc[:, 3] * inv_w) * pri[3]
                ymin = ycenter - h * 0.5
                xmin = xcenter - w * 0.5
                above = scores[:, 1:] >= DETECTION_THRESHOLD
                valid = above.any(dim=1)
                # argmax over bool → first True; torch needs an integer type
                first_cls = above.to(torch.uint8).argmax(dim=1) + 1
                prob = scores.gather(1, first_cls[:, None])[:, 0]
                probs = torch.where(valid, prob, 0.0)
                xq = _px_device(xmin, i_w).clamp_min(0.0)
                yq = _px_device(ymin, i_h).clamp_min(0.0)
                wq = _px_device(w, i_w)
                hq = _px_device(h, i_h)
                # stable descending sort = the host's sorted(key=-prob); the
                # zeroed invalid rows sink below every candidate
                order = torch.argsort(-probs, stable=True)[:k]
                xg, yg, wg, hg = xq[order], yq[order], wq[order], hq[order]
                pg = probs[order]
                cg = first_cls[order].to(torch.float32)
                keep = keep_impl(xg, yg, wg, hg, pg >= DETECTION_THRESHOLD)
                pg = torch.where(keep, pg, 0.0)
                return (torch.stack([xg, yg, wg, hg, cg, pg], dim=-1),)

            return fn, TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(k, 6)),),
                                   rate=in_spec.rate)

        if self.submode == "fused-ssd":
            if len(ts) != 1 or ts[0].rank != 2 or None in ts[0].shape or ts[0].shape[1] != 6:
                return None
            kk = ts[0].shape[0]

            def fn(xs):
                det = xs[0].reshape(-1, 6).to(torch.float32)
                probs = torch.where(det[:, 5] >= DETECTION_THRESHOLD, det[:, 5], 0.0)
                # the host path re-sorts through nms(); decode_topk rows are
                # already sorted, but the lowering does not rely on it
                order = torch.argsort(-probs, stable=True)
                det = det[order]
                pg = probs[order]
                xq = _px_device(det[:, 0], i_w).clamp_min(0.0)
                yq = _px_device(det[:, 1], i_h).clamp_min(0.0)
                wq = _px_device(det[:, 2], i_w)
                hq = _px_device(det[:, 3], i_h)
                keep = keep_impl(xq, yq, wq, hq, pg >= DETECTION_THRESHOLD)
                pg = torch.where(keep, pg, 0.0)
                return (torch.stack([xq, yq, wq, hq, det[:, 4], pg], dim=-1),)

            return fn, TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(kk, 6)),),
                                   rate=in_spec.rate)

        return None  # tf-ssd: truncating pixel rule, host only

    def _detect(self, frame: Frame) -> List[DetectedObject]:
        if self._lowered is not None:
            # integer-valued float32 pixels: int() is exact
            objs = [DetectedObject(class_id=int(c), x=int(x), y=int(y), width=int(w),
                                   height=int(h), prob=float(s))
                    for x, y, w, h, c, s in _host(frame.tensor(0)).reshape(-1, 6)
                    if s >= DETECTION_THRESHOLD]  # else invalid or suppressed
        elif self.submode == "tflite-ssd":
            boxes = _host(frame.tensor(0))
            scores = _host(frame.tensor(1))
            boxes = boxes.reshape(-1, boxes.shape[-1])
            scores = scores.reshape(-1, scores.shape[-1])
            objs = nms(decode_tflite_ssd(boxes, scores, self.priors,
                                         self.i_width, self.i_height))
        elif self.submode == "fused-ssd":
            objs = [DetectedObject(class_id=int(c),
                                   x=max(0, px(x, self.i_width)),
                                   y=max(0, px(y, self.i_height)),
                                   width=px(w, self.i_width),
                                   height=px(h, self.i_height),
                                   prob=float(s))
                    for x, y, w, h, c, s in _host(frame.tensor(0)).reshape(-1, 6)
                    if s >= DETECTION_THRESHOLD]
            # the device-side top-k already bounded the candidate set
            objs = nms(objs, pre_top_k=None)
        else:  # tf-ssd
            num = int(_host(frame.tensor(0)).reshape(-1)[0])
            classes = _host(frame.tensor(1)).reshape(-1)[:num]
            scores = _host(frame.tensor(2)).reshape(-1)[:num]
            boxes = _host(frame.tensor(3)).reshape(-1, 4)[:num]
            objs = []
            for c, s, b in zip(classes, scores, boxes):
                if s < DETECTION_THRESHOLD:
                    continue
                ymin, xmin, ymax, xmax = (float(v) for v in b)
                objs.append(DetectedObject(
                    class_id=int(c),
                    x=int(xmin * self.i_width),
                    y=int(ymin * self.i_height),
                    width=int((xmax - xmin) * self.i_width),
                    height=int((ymax - ymin) * self.i_height),
                    prob=float(s),
                ))
        for o in objs:
            if self.labels and 0 <= o.class_id < len(self.labels):
                o.label = self.labels[o.class_id]
        return objs

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        del in_spec
        objs = self._detect(frame)
        canvas = draw.new_canvas(self.width, self.height)
        sx = self.width / self.i_width
        sy = self.height / self.i_height
        for o in objs:
            color = draw.color_for_class(o.class_id)
            x, y = int(o.x * sx), int(o.y * sy)
            draw.draw_rect(canvas, x, y, int(o.width * sx), int(o.height * sy), color)
            # class label above the box (inside when clipped at the top)
            text = o.label if o.label else str(o.class_id)
            _, th = font.text_extent(text)
            ly = y - th - 2
            font.draw_label(canvas, x, ly if ly >= 0 else y + 2, text, draw.WHITE, bg=color)
        out = frame.with_tensors((torch.from_numpy(canvas),), meta=frame.meta)
        out.meta["objects"] = objs
        return out


def _parse_wh(opt: str, dw: int, dh: int):
    if not opt:
        return dw, dh
    w, _, h = opt.partition(":")
    return int(w), int(h)
