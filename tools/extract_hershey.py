#!/usr/bin/env python3
"""Recover the Hershey simplex strokes that OpenCV 4.x draws, for the
glyphs the grid layout uses ('?', 'S', '0'-'9', 'A'-'D').

OpenCV places every vertex of a FONT_HERSHEY_SIMPLEX glyph at
``org + (u, v) * fontScale`` for integer (u, v).  At fontScale 16 with
thickness 1 and LINE_8 the strokes are 1px Bresenham lines between points
of a 16px lattice, so a segment between two lattice points belongs to the
glyph exactly when every point along it is inked; the minimal such
segments (no inked lattice point strictly inside) are the strokes.  The
script checks that redrawing them reproduces OpenCV's image and prints
``ops/hershey.py``'s GLYPHS table.  It needs an OpenCV 4.x build (OpenCV 5
draws its Hershey constants with a different font).

    python tools/extract_hershey.py             # print the constants
    python tools/extract_hershey.py OUT.npz     # write the test goldens
"""
import itertools

import cv2
import numpy as np

S = 16
ORG = (300, 700)
CHARS = "?S0123456789ABCD"
SIZE_TEXTS = ("?", "S0", "S5", "A", "D", "S12", "B9C")


def merge_collinear(segs):
    """Join segments that continue each other in a straight line through a
    point no other segment touches."""
    segs = [tuple(sorted(s)) for s in segs]
    while True:
        ends = {}
        for s in segs:
            for p in s:
                ends.setdefault(p, []).append(s)
        for p, ss in ends.items():
            if len(ss) != 2:
                continue
            (a, b), (c, d) = ss
            q0 = a if b == p else b
            q1 = c if d == p else d
            if ((p[0] - q0[0]) * (q1[1] - p[1])
                    == (p[1] - q0[1]) * (q1[0] - p[0])):
                segs = [s for s in segs if s not in ss]
                segs.append(tuple(sorted((q0, q1))))
                break
        else:
            return segs


def strokes(ch):
    img = np.zeros((1000, 1000), np.uint8)
    cv2.putText(img, ch, ORG, cv2.FONT_HERSHEY_SIMPLEX, S, 255, 1,
                lineType=cv2.LINE_8)
    pts = [(i, j) for i in range(-10, 40) for j in range(-40, 15)
           if img[ORG[1] + j * S, ORG[0] + i * S]]

    def on_ink(a, b):
        n = int(np.hypot(b[0] - a[0], b[1] - a[1]) * S * 2) + 2
        for t in np.linspace(0.0, 1.0, n):
            x = ORG[0] + (a[0] + t * (b[0] - a[0])) * S
            y = ORG[1] + (a[1] + t * (b[1] - a[1])) * S
            xi, yi = int(np.floor(x + 0.5)), int(np.floor(y + 0.5))
            if not img[yi - 1:yi + 2, xi - 1:xi + 2].any():
                return False
        return True

    def strictly_inside(a, b, r):
        if (b[0] - a[0]) * (r[1] - a[1]) != (b[1] - a[1]) * (r[0] - a[0]):
            return False
        dot = (r[0] - a[0]) * (b[0] - a[0]) + (r[1] - a[1]) * (b[1] - a[1])
        return 0 < dot < (b[0] - a[0]) ** 2 + (b[1] - a[1]) ** 2

    segs = [(a, b) for a, b in itertools.combinations(pts, 2)
            if on_ink(a, b)
            and not any(strictly_inside(a, b, r) for r in pts)]
    segs = merge_collinear(segs)
    # isolated inked lattice points (a dot drawn as a zero-length stroke)
    segs += [(p, p) for p in pts
             if not any(p in s or strictly_inside(s[0], s[1], p)
                        for s in segs)]
    redraw = np.zeros_like(img)
    for a, b in segs:
        cv2.line(redraw, (ORG[0] + a[0] * S, ORG[1] + a[1] * S),
                 (ORG[0] + b[0] * S, ORG[1] + b[1] * S), 255, 1, cv2.LINE_8)
    miss = int(((img > 0) & (redraw == 0)).sum())
    extra = int(((redraw > 0) & (img == 0)).sum())
    return sorted(segs), miss, extra


def main():
    assert cv2.__version__.startswith("4."), cv2.__version__
    print("GLYPHS = {")
    for ch in CHARS:
        segs, miss, extra = strokes(ch)
        assert miss <= 4 * len(segs) and extra <= 4 * len(segs), (ch, miss, extra)
        flat = ", ".join(f"({a[0]}, {a[1]}, {b[0]}, {b[1]})" for a, b in segs)
        print(f"    {ch!r}: ({flat}),")
    print("}")
    # advance widths: getTextSize(ch, scale 1, thickness 0) is the advance
    adv = {ch: cv2.getTextSize(ch, cv2.FONT_HERSHEY_SIMPLEX, 16.0, 0)[0][0] / 16
           for ch in CHARS}
    print("ADVANCE =", adv)




def goldens(path):
    """cv2 renders the tests compare ops/hershey.py with: the '?' query
    patch at several cell sizes (as compose._make_query_patch lays it out)
    and label strings at the layout's font scales."""
    F = cv2.FONT_HERSHEY_SIMPLEX
    out = {}
    for cell in (60, 94, 118, 150, 200):
        im = np.full((cell, cell), 255, np.uint8)
        thickness = max(1, cell // 80)
        scale = cell / 100.0
        (tw, th), _ = cv2.getTextSize("?", F, scale, thickness)
        if tw > cell * 0.8:
            scale = scale * (cell * 0.8 / tw)
            (tw, th), _ = cv2.getTextSize("?", F, scale, thickness)
        cv2.putText(im, "?", ((cell - tw) // 2, (cell + th) // 2), F, scale,
                    0, thickness, lineType=cv2.LINE_AA)
        out[f"query_{cell}"] = im
    for scale in (0.25, 0.39, 0.49, 0.8):
        for text in ("S0", "S3", "S5", "A", "B", "C", "D"):
            im = np.full((40, 60), 255, np.uint8)
            cv2.putText(im, text, (5, 30), F, scale, 0, 1,
                        lineType=cv2.LINE_AA)
            out[f"label_{text}_{scale}"] = im
    # getTextSize: rows (text index, scale, thickness, w, h, baseline)
    rows = []
    for ti, text in enumerate(SIZE_TEXTS):
        for scale in (0.25, 0.3, 0.39, 0.45, 0.49, 0.5, 0.8, 0.94, 1.0,
                      1.18, 1.5, 2.0, 2.37):
            for thickness in (1, 2, 3):
                (w, h), b = cv2.getTextSize(text, F, scale, thickness)
                rows.append((ti, scale, thickness, w, h, b))
    out["text_size"] = np.asarray(rows, np.float64)
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1:
        goldens(sys.argv[1])
    else:
        main()
