# test_hershey.py — the numpy Hershey glyphs against OpenCV 4.x renders.
"""tests/data/hershey_cv2_4.npz holds what OpenCV 4.x's cv2.putText and
cv2.getTextSize give for the grid layout's text (written by
tools/extract_hershey.py; OpenCV 5 draws FONT_HERSHEY_SIMPLEX with another
font, so the comparison is against stored renders)."""
from pathlib import Path

import numpy as np
import pytest

from reasoning_image_generation_tpu.ops import hershey
from reasoning_image_generation_tpu.ops.compose import (
    _make_query_patch, build_layout)

GOLDEN = np.load(Path(__file__).parent / "data" / "hershey_cv2_4.npz")
SIZE_TEXTS = ("?", "S0", "S5", "A", "D", "S12", "B9C")


def test_text_size_matches_cv2_exactly():
    rows = GOLDEN["text_size"]
    assert len(rows) > 200
    for ti, scale, thickness, w, h, b in rows:
        got = hershey.text_size(SIZE_TEXTS[int(ti)], float(scale),
                                int(thickness))
        assert got == ((int(w), int(h)), int(b)), (SIZE_TEXTS[int(ti)],
                                                   scale, thickness)


def _close_to_cv2(ours, ref):
    """Ink within 25% and strokes in the same places (correlation of
    the ink images >= 0.97).  The strokes are identical; the antialiasing
    model (a distance band, ops/raster._stroke_alpha) differs from
    OpenCV's LineAA by up to ~95 levels on single edge pixels."""
    a = 255.0 - ours.astype(np.float64)
    b = 255.0 - ref.astype(np.float64)
    assert 0.85 < a.sum() / b.sum() < 1.25
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.97


@pytest.mark.parametrize("cell", [60, 94, 118, 150, 200])
def test_query_patch_matches_cv2(cell):
    ours = _make_query_patch(cell)
    assert ours.shape == (cell, cell, 3)
    assert (ours[..., 0] == ours[..., 1]).all()
    _close_to_cv2(ours[..., 0], GOLDEN[f"query_{cell}"])


@pytest.mark.parametrize("scale", [0.25, 0.39, 0.49, 0.8])
@pytest.mark.parametrize("text", ["S0", "S3", "S5", "A", "B", "C", "D"])
def test_label_matches_cv2(text, scale):
    ref = GOLDEN[f"label_{text}_{scale}"]
    ours = np.full(ref.shape, 255, np.uint8)
    hershey.put_text(ours, text, (5, 30), scale, 0, 1)
    _close_to_cv2(ours, ref)


def test_layout_overlay_has_labels():
    lay = build_layout(512, 512, n_states=3, num_options=4)
    # every label cell gets ink below it; the query cell holds the '?'
    for c in lay.cells_meta:
        x, y, w, h = c["bbox"]
        band = lay.overlay_a[y + h:y + h + 20, x:x + w]
        assert band.max() > 0.5, c["label"]
    q = lay.query_patch
    assert (q < 128).any() and q.shape[0] == lay.cell_size
