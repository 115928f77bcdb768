"""Rasterization helpers for overlay decoders (RGBA canvases).

The port's copy of the JAX package's ``decoders/draw.py`` (numpy only).

The analog of the hand-rolled pixel loops in ``tensordec-boundingbox.c`` /
``tensordec-pose.c`` (and their shared baked font, ``tensordec-font.c``),
vectorized with numpy.  Coordinates are (x, y) with y down, matching video
raster order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Distinct per-class border colors (RGBA); class_id indexes cyclically.
PALETTE = np.array(
    [
        [255, 0, 0, 255],
        [0, 255, 0, 255],
        [0, 0, 255, 255],
        [255, 255, 0, 255],
        [0, 255, 255, 255],
        [255, 0, 255, 255],
        [255, 128, 0, 255],
        [128, 0, 255, 255],
    ],
    dtype=np.uint8,
)

WHITE = np.array([255, 255, 255, 255], dtype=np.uint8)


def new_canvas(width: int, height: int) -> np.ndarray:
    """Transparent RGBA canvas (the reference memsets to 0: alpha-0 black)."""
    return np.zeros((height, width, 4), dtype=np.uint8)


def draw_rect(
    canvas: np.ndarray, x: int, y: int, w: int, h: int, color, thickness: int = 1
) -> None:
    """1px (or thicker) rectangle border, clipped to the canvas."""
    H, W = canvas.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    t = thickness
    canvas[y0:min(y0 + t, y1), x0:x1] = color
    canvas[max(y1 - t, y0):y1, x0:x1] = color
    canvas[y0:y1, x0:min(x0 + t, x1)] = color
    canvas[y0:y1, max(x1 - t, x0):x1] = color


def draw_line(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """Bresenham-free line: sample max(dx,dy)+1 points (dense enough for 1px)."""
    H, W = canvas.shape[:2]
    n = int(max(abs(x2 - x1), abs(y2 - y1))) + 1
    xs = np.linspace(x1, x2, n).round().astype(int)
    ys = np.linspace(y1, y2, n).round().astype(int)
    mask = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    canvas[ys[mask], xs[mask]] = color


def draw_dot(canvas: np.ndarray, x: int, y: int, color, radius: int = 2) -> None:
    H, W = canvas.shape[:2]
    x0, x1 = max(0, x - radius), min(W, x + radius + 1)
    y0, y1 = max(0, y - radius), min(H, y + radius + 1)
    if x1 > x0 and y1 > y0:
        canvas[y0:y1, x0:x1] = color


def color_for_class(class_id: int) -> np.ndarray:
    return PALETTE[class_id % len(PALETTE)]
