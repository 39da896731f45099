# hershey.py — the Hershey simplex glyphs of the grid layout, in numpy.
"""Stroke font for the grid's labels and '?' query cell.

The reference draws them with ``cv2.putText(..., FONT_HERSHEY_SIMPLEX,
..., LINE_AA)`` (src/layout.py:33-47, :150-178).  This module carries the
strokes of the glyphs the layout uses ('?', 'S', '0'-'9', 'A'-'D') as
constants, recovered from OpenCV 4.x by tools/extract_hershey.py, and
reproduces OpenCV's text metrics (``cv2.getTextSize``) exactly and its
antialiased strokes with the distance-field band the renderer already
calibrates against cv2 LINE_AA (ops/raster._stroke_alpha).

Glyph coordinates are in font units: a vertex (u, v) of a character whose
origin is at x lands at ``(x + u * s, org_y + v * s)`` for font scale s
(OpenCV's fixed-point placement); v = 0 is the baseline.
"""
from __future__ import annotations

import numpy as np

# (u0, v0, u1, v1) stroke segments per character; u0 == u1 and v0 == v1
# is a dot
GLYPHS = {
    '?': (
        (3, -17, 3, -16), (3, -17, 4, -19), (4, -19, 5, -20),
        (5, -20, 7, -21), (7, -21, 11, -21), (8, -1, 9, -2), (8, -1, 9, 0),
        (9, -10, 9, -7), (9, -10, 13, -12), (9, -2, 10, -1), (9, 0, 10, -1),
        (11, -21, 13, -20), (13, -20, 14, -19), (13, -12, 14, -13),
        (14, -19, 15, -17), (14, -13, 15, -15), (15, -17, 15, -15),
    ),
    'S': (
        (3, -18, 3, -16), (3, -18, 5, -20), (3, -16, 4, -14), (3, -3, 5, -1),
        (4, -14, 5, -13), (5, -20, 8, -21), (5, -13, 7, -12), (5, -1, 8, 0),
        (7, -12, 13, -10), (8, -21, 12, -21), (8, 0, 12, 0),
        (12, -21, 15, -20), (12, 0, 15, -1), (13, -10, 15, -9),
        (15, -20, 17, -18), (15, -9, 16, -8), (15, -1, 17, -3),
        (16, -8, 17, -6), (17, -6, 17, -3),
    ),
    '0': (
        (3, -12, 3, -9), (3, -12, 4, -17), (3, -9, 4, -4), (4, -17, 6, -20),
        (4, -4, 6, -1), (6, -20, 9, -21), (6, -1, 9, 0), (9, -21, 11, -21),
        (9, 0, 11, 0), (11, -21, 14, -20), (11, 0, 14, -1),
        (14, -20, 16, -17), (14, -1, 16, -4), (16, -17, 17, -12),
        (16, -4, 17, -9), (17, -12, 17, -9),
    ),
    '1': (
        (6, -17, 8, -18), (8, -18, 11, -21), (11, -21, 11, 0),
    ),
    '2': (
        (3, 0, 13, -10), (3, 0, 17, 0), (4, -17, 4, -16), (4, -17, 5, -19),
        (5, -19, 6, -20), (6, -20, 8, -21), (8, -21, 12, -21),
        (12, -21, 14, -20), (13, -10, 15, -13), (14, -20, 15, -19),
        (15, -19, 16, -17), (15, -13, 16, -15), (16, -17, 16, -15),
    ),
    '3': (
        (3, -4, 4, -2), (4, -2, 5, -1), (5, -21, 16, -21), (5, -1, 8, 0),
        (8, 0, 11, 0), (10, -13, 13, -13), (10, -13, 16, -21),
        (11, 0, 14, -1), (13, -13, 15, -12), (14, -1, 16, -3),
        (15, -12, 16, -11), (16, -11, 17, -8), (16, -3, 17, -6),
        (17, -8, 17, -6),
    ),
    '4': (
        (3, -7, 13, -21), (3, -7, 13, -7), (13, -21, 13, -7), (13, -7, 13, 0),
        (13, -7, 18, -7),
    ),
    '5': (
        (3, -4, 4, -2), (4, -12, 5, -21), (4, -12, 5, -13), (4, -2, 5, -1),
        (5, -21, 15, -21), (5, -13, 8, -14), (5, -1, 8, 0), (8, -14, 11, -14),
        (8, 0, 11, 0), (11, -14, 14, -13), (11, 0, 14, -1),
        (14, -13, 16, -11), (14, -1, 16, -3), (16, -11, 17, -8),
        (16, -3, 17, -6), (17, -8, 17, -6),
    ),
    '6': (
        (4, -12, 4, -7), (4, -12, 5, -17), (4, -7, 5, -10), (4, -7, 5, -3),
        (5, -17, 7, -20), (5, -10, 7, -12), (5, -3, 7, -1), (7, -20, 10, -21),
        (7, -12, 10, -13), (7, -1, 10, 0), (10, -21, 12, -21),
        (10, -13, 11, -13), (10, 0, 11, 0), (11, -13, 14, -12),
        (11, 0, 14, -1), (12, -21, 15, -20), (14, -12, 16, -10),
        (14, -1, 16, -3), (15, -20, 16, -18), (16, -10, 17, -7),
        (16, -3, 17, -6), (17, -7, 17, -6),
    ),
    '7': (
        (3, -21, 17, -21), (7, 0, 17, -21),
    ),
    '8': (
        (3, -7, 3, -4), (3, -7, 4, -9), (3, -4, 4, -2), (4, -18, 4, -16),
        (4, -18, 5, -20), (4, -16, 5, -14), (4, -9, 6, -11), (4, -2, 5, -1),
        (5, -20, 8, -21), (5, -14, 7, -13), (5, -1, 8, 0), (6, -11, 9, -12),
        (7, -13, 11, -12), (8, -21, 12, -21), (8, 0, 12, 0),
        (9, -12, 13, -13), (11, -12, 14, -11), (12, -21, 15, -20),
        (12, 0, 15, -1), (13, -13, 15, -14), (14, -11, 16, -9),
        (15, -20, 16, -18), (15, -14, 16, -16), (15, -1, 16, -2),
        (16, -18, 16, -16), (16, -9, 17, -7), (16, -2, 17, -4),
        (17, -7, 17, -4),
    ),
    '9': (
        (3, -15, 3, -14), (3, -15, 4, -18), (3, -14, 4, -11),
        (4, -18, 6, -20), (4, -11, 6, -9), (4, -3, 5, -1), (5, -1, 8, 0),
        (6, -20, 9, -21), (6, -9, 9, -8), (8, 0, 10, 0), (9, -21, 10, -21),
        (9, -8, 10, -8), (10, -21, 13, -20), (10, -8, 13, -9),
        (10, 0, 13, -1), (13, -20, 15, -18), (13, -9, 15, -11),
        (13, -1, 15, -4), (15, -18, 16, -14), (15, -11, 16, -14),
        (15, -4, 16, -9), (16, -14, 16, -9),
    ),
    'A': (
        (1, 0, 9, -21), (4, -7, 14, -7), (9, -21, 17, 0),
    ),
    'B': (
        (4, -21, 4, -11), (4, -21, 13, -21), (4, -11, 4, 0),
        (4, -11, 13, -11), (4, 0, 13, 0), (13, -21, 16, -20),
        (13, -11, 16, -12), (13, -11, 16, -10), (13, 0, 16, -1),
        (16, -20, 17, -19), (16, -12, 17, -13), (16, -10, 17, -9),
        (16, -1, 17, -2), (17, -19, 18, -17), (17, -13, 18, -15),
        (17, -9, 18, -7), (17, -2, 18, -4), (18, -17, 18, -15),
        (18, -7, 18, -4),
    ),
    'C': (
        (3, -13, 3, -8), (3, -13, 4, -16), (3, -8, 4, -5), (4, -16, 5, -18),
        (4, -5, 5, -3), (5, -18, 7, -20), (5, -3, 7, -1), (7, -20, 9, -21),
        (7, -1, 9, 0), (9, -21, 13, -21), (9, 0, 13, 0), (13, -21, 15, -20),
        (13, 0, 15, -1), (15, -20, 17, -18), (15, -1, 17, -3),
        (17, -18, 18, -16), (17, -3, 18, -5),
    ),
    'D': (
        (4, -21, 4, 0), (4, -21, 11, -21), (4, 0, 11, 0), (11, -21, 14, -20),
        (11, 0, 14, -1), (14, -20, 16, -18), (14, -1, 16, -3),
        (16, -18, 17, -16), (16, -3, 17, -5), (17, -16, 18, -13),
        (17, -5, 18, -8), (18, -13, 18, -8),
    ),
}
# advance width of each character, in font units
ADVANCE = {"?": 18, "S": 20, "A": 18, "B": 21, "C": 21, "D": 21,
           **{str(d): 20 for d in range(10)}}
# Hershey simplex's cap height above and descent below the baseline
CAP_LINE = 12
BASE_LINE = 9
_XY_ONE = 1 << 16  # OpenCV's fixed-point vertex scale


def text_size(text: str, font_scale: float, thickness: int):
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, font_scale,
    thickness)``: ((width, height), baseline)."""
    width = round(sum(ADVANCE[c] for c in text) * font_scale + thickness)
    height = round((CAP_LINE + BASE_LINE) * font_scale + (thickness + 1) // 2)
    return (width, height), round(BASE_LINE * font_scale + thickness * 0.5)


def _segments(text: str, org, font_scale: float) -> np.ndarray:
    """Pixel-space segments [K, 4] of ``text`` placed like cv2.putText."""
    step = round(font_scale * _XY_ONE) / _XY_ONE
    out = []
    pen = 0
    for c in text:
        for u0, v0, u1, v1 in GLYPHS[c]:
            out.append((org[0] + (pen + u0) * step, org[1] + v0 * step,
                        org[0] + (pen + u1) * step, org[1] + v1 * step))
        pen += ADVANCE[c]
    return np.asarray(out, np.float64).reshape(-1, 4)


def text_alpha(shape, text: str, org, font_scale: float,
               thickness: int = 1) -> np.ndarray:
    """Coverage [h, w] in [0, 1] of ``text`` drawn at ``org`` (the
    bottom-left of the text, as cv2.putText takes it)."""
    h, w = shape
    segs = _segments(text, org, font_scale)
    r_full = 0.0 if thickness <= 1 else float(np.ceil(thickness * 0.5))
    reach = r_full + 1.28
    alpha = np.zeros((h, w), np.float64)
    if not len(segs):
        return alpha
    x0 = max(int(np.floor(segs[:, 0::2].min() - reach)), 0)
    x1 = min(int(np.ceil(segs[:, 0::2].max() + reach)) + 1, w)
    y0 = max(int(np.floor(segs[:, 1::2].min() - reach)), 0)
    y1 = min(int(np.ceil(segs[:, 1::2].max() + reach)) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return alpha
    px = np.arange(x0, x1, dtype=np.float64)[None, :, None]
    py = np.arange(y0, y1, dtype=np.float64)[:, None, None]
    ax, ay, bx, by = (segs[:, k] for k in range(4))
    ex, ey = bx - ax, by - ay
    len2 = np.maximum(ex * ex + ey * ey, 1e-12)
    t = np.clip(((px - ax) * ex + (py - ay) * ey) / len2, 0.0, 1.0)
    d = np.hypot(px - (ax + t * ex), py - (ay + t * ey)).min(axis=-1)
    alpha[y0:y1, x0:x1] = np.clip((reach - d) / 1.28, 0.0, 1.0)
    return alpha


def put_text(img: np.ndarray, text: str, org, font_scale: float,
             color, thickness: int = 1) -> None:
    """Draw antialiased ``text`` into the u8 image ``img`` in place, like
    ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale,
    color, thickness, LINE_AA)``."""
    a = text_alpha(img.shape[:2], text, org, font_scale, thickness)
    if img.ndim == 3:
        a = a[..., None]
    col = np.asarray(color, np.float64)
    img[...] = np.round(img * (1.0 - a) + col * a).astype(np.uint8)
