# test_multigraph.py — scene construction + rendering for the mg pipeline.
import numpy as np
import pytest

from reasoning_image_generation_tpu.models.multigraph.scene import (
    build_scene, build_scene_batch, circle_poly, poly_centroid, poly_area,
    points_in_poly, polys_overlap, poly_min_distance, overlap_area,
    combine_nested, combine_adjacent, combine_intersecting)
from reasoning_image_generation_tpu.models.multigraph.renderer import (
    render_scene_batch, data_to_pixel_transform)

import random

TEST_DPI = 25  # 200x200 px: geometry identical, render cheap on test CPU


def test_geometry_predicates():
    c = circle_poly((0, 0), 1.0)
    assert abs(poly_area(c) - np.pi) < 0.02
    assert np.allclose(poly_centroid(c), [0, 0], atol=1e-5)
    pts = np.asarray([[0, 0], [2, 0], [0.9, 0]])
    np.testing.assert_array_equal(points_in_poly(pts, c), [True, False, True])

    c2 = circle_poly((1.0, 0), 1.0)
    assert polys_overlap(c, c2)
    c3 = circle_poly((3.0, 0), 1.0)
    assert not polys_overlap(c, c3)
    assert abs(poly_min_distance(c, c3) - 1.0) < 0.02
    assert abs(overlap_area(c, c) - np.pi) < 0.2


def test_combine_nested_scales_and_centers():
    a = circle_poly((0, 0), 2.0)
    b = circle_poly((1, 1), 1.5)
    placed = combine_nested([a, b])
    # inner scaled by 0.4 about centroid then moved to outer centroid
    assert np.allclose(poly_centroid(placed[1]), poly_centroid(placed[0]), atol=1e-4)
    assert abs(poly_area(placed[1]) - poly_area(b) * 0.16) < 0.05


def test_combine_adjacent_touches_without_overlap():
    rng = random.Random(0)
    a = circle_poly((0, 0), 1.5)
    b = circle_poly((0.2, 0.1), 1.0)
    placed = combine_adjacent(rng, [a, b])
    assert not polys_overlap(placed[0], placed[1])
    assert poly_min_distance(placed[0], placed[1]) < 0.15


def test_combine_intersecting_overlaps():
    rng = random.Random(1)
    a = circle_poly((0, 0), 2.0)
    b = circle_poly((5, 5), 1.5)
    placed = combine_intersecting(rng, [a, b])
    ov = overlap_area(placed[0], placed[1])
    assert ov >= 0.05 * min(poly_area(a), poly_area(b))


@pytest.mark.parametrize("mode", ["random", "nested", "adjacent", "intersecting"])
def test_build_scene_modes(mode):
    sc, rec = build_scene(seed=3, mode=mode)
    n_valid = int(sc["shape_valid"].sum())
    assert rec["shape_count"] == n_valid
    if mode == "random":
        assert n_valid == 1
        # single-shape always has decoration or mask
        assert sc["line_valid"].any() or sc["mask_mode"] > 0
    else:
        assert 2 <= n_valid <= 3
    # recentered: union bbox centered at origin
    pts = sc["shape_verts"][sc["shape_valid"]].reshape(-1, 2)
    lo, hi = pts.min(0), pts.max(0)
    if not sc["mask_valid"].any() and not sc["line_valid"].any():
        assert np.allclose((lo + hi) / 2, 0, atol=1e-3)
    # record schema fields
    sp = rec["shapes"][0]
    for key in ("center", "bbox", "edge_color", "line_width", "fill_color",
                "alpha"):
        assert key in sp


def test_render_batch_shapes_and_content():
    seeds = [0, 1, 2, 3]
    modes = ["random", "nested", "adjacent", "intersecting"]
    batch, _ = build_scene_batch(seeds, modes)
    imgs = np.asarray(render_scene_batch(batch, dpi=TEST_DPI))
    s = 8 * TEST_DPI
    assert imgs.shape == (4, s, s, 3)
    for i in range(4):
        assert (imgs[i] < 200).mean() > 0.001, f"scene {i} looks empty"


def test_generator_api(tmp_path):
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    gen = GeometryGeneratorTPU()
    png = str(tmp_path / "img.png")
    js = str(tmp_path / "params.json")
    rec = gen.generate(mode="adjacent", save_path=png, params_save_path=js,
                       dpi=TEST_DPI, seed=5)
    gen.close()
    import json, os
    assert os.path.exists(png) and os.path.exists(js)
    saved = json.load(open(js))
    assert saved["mode"] == "adjacent"
    assert saved["shape_count"] == len(saved["shapes"])
    for sp in saved["shapes"]:
        assert "shape_id" in sp and "extra_params" in sp


def test_transform_matches_matplotlib():
    scale, x0, y0, size = data_to_pixel_transform(200)
    assert size == 1600
    assert abs(scale - 123.2) < 1.0
    assert abs(x0 - 820.0) < 2.0


@pytest.mark.parametrize("dpi", [25, 72, 100, 200, 300])
def test_pinned_transform_equals_matplotlib(dpi):
    """The pinned constants give exactly what matplotlib computes for the
    reference figure (8x8 in, equal aspect, axis off, limits +-5)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    try:
        ax.set_aspect("equal")
        ax.axis("off")
        ax.set_xlim(-5, 5)
        ax.set_ylim(-5, 5)
        fig.canvas.draw()
        p0 = ax.transData.transform((0.0, 0.0))
        p1 = ax.transData.transform((1.0, 0.0))
        k = dpi / fig.dpi
        want = (float((p1[0] - p0[0]) * k), float(p0[0] * k),
                float(p0[1] * k), int(8 * dpi))
    finally:
        plt.close(fig)
    assert data_to_pixel_transform(dpi) == want


def test_gradient_fill_capability():
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        empty_scene, circle_poly, hex_to_rgb)
    from reasoning_image_generation_tpu.models.multigraph.renderer import (
        render_scene_batch)
    sc = empty_scene()
    sc["shape_verts"][0] = circle_poly((0, 0), 3.0)
    sc["shape_lw"][0] = 1.5
    sc["shape_alpha"][0] = 0.9
    sc["shape_valid"][0] = True
    sc["grad_valid"][0] = True
    sc["grad_c0"][0] = hex_to_rgb("#FF6B6B")
    sc["grad_c1"][0] = hex_to_rgb("#4ECDC4")
    sc["grad_alpha"][0] = 0.75
    batch = {k: np.stack([v]) for k, v in sc.items()}
    img = np.asarray(render_scene_batch(batch, dpi=TEST_DPI))[0]
    s = 8 * TEST_DPI
    center = img[s // 2, s // 2].astype(int)
    # center leans toward c0 (reddish), shape interior is not background
    assert center[0] > center[2] - 10 and (center != 255).any()
    # outside stays background white
    assert (img[2, 2] == 255).all()


def test_deform_edge():
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        deform_edge, regular_poly, poly_area)
    rng = random.Random(0)
    tri = np.asarray([[0.0, 2.0], [-1.7, -1.0], [1.7, -1.0]], np.float32)
    out = deform_edge(rng, tri)
    assert len(out) == 6  # midpoint inserted per edge
    # original vertices preserved at even indices
    np.testing.assert_allclose(out[0::2], tri, atol=1e-6)
    # area changed but same ballpark
    assert 0.5 < poly_area(out) / poly_area(tri) < 1.5


def test_adjacent_point_and_edge_strategies():
    """The direct projection strategies place touching, non-overlapping
    shapes (reference multi_combinator.py:908-997 semantics)."""
    import numpy as np
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        _try_point_adjacency, _try_edge_adjacency, regular_poly,
        polys_overlap, poly_min_distance)
    ref = regular_poly((0.0, 0.0), 6, 1.0)
    cur = regular_poly((3.5, 0.2), 5, 0.8)
    out = _try_point_adjacency(cur, ref, [ref])
    assert out is not None
    assert not polys_overlap(out, ref)
    # a vertex of out lies on ref's boundary (spacing 0)
    assert poly_min_distance(out, ref) < 0.05
    # shape preserved (pure translation)
    d = out - cur
    assert np.allclose(d, d[0], atol=1e-5)
    # edge mode inherits the reference's spacing - dist sign convention,
    # which rarely passes its own distance post-check -> returns None and
    # the caller falls back to the sweep (reference multi_combinator.py:
    # 957-997 then 999-1047).  When it does place, it must be valid.
    out_e = _try_edge_adjacency(cur, ref, [ref])
    if out_e is not None:
        assert not polys_overlap(out_e, ref)


def test_generate_batches_dedup(tmp_path):
    """Corpus dedup across the multigraph run: identical seeds+modes render
    identical scenes, so the second half must be marked duplicate and
    export no artifacts (reference README.md:8's dataset-level filter)."""
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    gen = GeometryGeneratorTPU()
    seeds = [1, 2, 3, 4, 1, 2, 3, 4]
    modes = ["adjacent"] * 8
    pngs = [str(tmp_path / f"{i}.png") for i in range(8)]
    jss = [str(tmp_path / f"{i}.json") for i in range(8)]
    recs = gen.generate_batches(seeds, modes, pngs, jss, dpi=TEST_DPI,
                                batch_size=4, dedup=True)
    # dedup is scoped to the generate_batches call: a fresh run with the
    # same seeds keeps everything again
    recs2 = gen.generate_batches(seeds[:4], modes[:4], dpi=TEST_DPI,
                                 batch_size=4)
    assert not any(r.get("duplicate") for r in recs2)
    gen.close()
    import os
    assert len(recs) == 8
    dups = [bool(r.get("duplicate")) for r in recs]
    assert dups == [False] * 4 + [True] * 4
    for i in range(4):
        assert os.path.exists(pngs[i]) and os.path.exists(jss[i])
        import json
        saved = json.load(open(jss[i]))
        assert "qc" in saved  # pool-side QC landed before the JSON write
    for i in range(4, 8):
        assert not os.path.exists(pngs[i]) and not os.path.exists(jss[i])


def test_nested_same_center_variant():
    """same_center=False keeps every layer at its own centroid
    (reference multi_combinator.py:686,712); the default translates all
    inner layers to the outer centroid."""
    import numpy as np
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        combine_nested, circle_poly, rect_poly, poly_centroid)
    shapes = [rect_poly((-2.0, -2.0), 4.0, 4.0), circle_poly((1.5, 1.0), 1.2)]
    cen = combine_nested([s.copy() for s in shapes], same_center=True)
    off = combine_nested([s.copy() for s in shapes], same_center=False)
    outer_c = poly_centroid(shapes[0])
    assert np.allclose(poly_centroid(cen[1]), outer_c, atol=1e-4)
    assert np.allclose(poly_centroid(off[1]), poly_centroid(shapes[1]),
                       atol=1e-4)
    # scaling itself is identical in both variants
    assert np.allclose(off[1] - poly_centroid(off[1]),
                       cen[1] - poly_centroid(cen[1]), atol=1e-4)


def test_adjacent_spacing_variant():
    """spacing>0 places shapes a fixed gap apart instead of touching
    (reference multi_combinator.py:780,1019-1029)."""
    import random
    import numpy as np
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        combine_adjacent, circle_poly, rect_poly, poly_min_distance,
        polys_overlap)
    for seed in range(6):
        shapes = [rect_poly((-1.5, -1.5), 3.0, 3.0),
                  circle_poly((4.0, 0.5), 1.0)]
        placed0 = combine_adjacent(random.Random(seed),
                                   [s.copy() for s in shapes])
        d0 = poly_min_distance(placed0[0], placed0[1])
        assert d0 <= 0.05, f"touch variant gap {d0}"
        placed = combine_adjacent(random.Random(seed),
                                  [s.copy() for s in shapes], spacing=0.5)
        d = poly_min_distance(placed[0], placed[1])
        assert abs(d - 0.5) <= 0.12, f"spacing variant gap {d}"
        assert not polys_overlap(placed[0], placed[1])


def test_build_scene_variant_plumbing():
    """The combinator variants are reachable through build_scene and
    recorded in the per-shape params."""
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        build_scene)
    _, rec = build_scene(11, "nested", nested_same_center=False)
    assert all(s["same_center"] is False for s in rec["shapes"])
    _, rec2 = build_scene(12, "adjacent", adjacent_spacing=0.3)
    assert all(s["spacing"] == 0.3 for s in rec2["shapes"])


def test_point_adjacency_nonconvex_fallback():
    """Sectors spanning >180deg are non-convex: the support-vertex prune
    assumes convexity, so those must take the exhaustive vertex loop and
    still find a valid touching placement."""
    import numpy as np
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        _poly_is_convex, _try_point_adjacency, wedge_poly, rect_poly,
        poly_min_distance, polys_overlap)
    big = wedge_poly((0.0, 0.0), 2.0, 0.0, 300.0)   # 300deg sector
    assert not _poly_is_convex(big)
    assert _poly_is_convex(rect_poly((-1.0, -1.0), 2.0, 2.0))
    cur = rect_poly((5.0, 5.0), 1.5, 1.5)
    out = _try_point_adjacency(cur, big, [big])
    assert out is not None
    assert poly_min_distance(out, big) <= 1e-3
    assert not polys_overlap(out, big)


def test_generator_rle5_matches_rle4(tmp_path):
    """The mg transfer path must write byte-identical PNGs under the v5
    (length-1 bitmask) and v4 wire formats."""
    import cv2
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    outs = {}
    for codec in ("rle4", "rle5"):
        gen = GeometryGeneratorTPU(transfer_codec=codec)
        pngs = [str(tmp_path / f"{codec}_{i}.png") for i in range(4)]
        gen.generate_batch([7, 8, 9, 10],
                           ["nested", "adjacent", "intersecting", "random"],
                           pngs, None, dpi=TEST_DPI)
        gen._pool.drain()
        gen.close()
        outs[codec] = pngs
    for p4, p5 in zip(outs["rle4"], outs["rle5"]):
        a, b = cv2.imread(p4), cv2.imread(p5)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b, err_msg=p4)


def test_pack_budget_stats_driven(tmp_path, monkeypatch):
    """The device pack budget right-sizes from the persisted max
    single-frame run count ('M' stat): palettize sort/top_k/scatter cost
    scales with the buffer, not the content, and mg outline scenes need
    ~1/7 of the dense-frame default at 1600^2 (measured ~3.4 s -> well
    under 1 s device time per 50-frame batch)."""
    from reasoning_image_generation_tpu.utils import cache
    monkeypatch.setattr(cache, "cache_dir", lambda: str(tmp_path))
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    from reasoning_image_generation_tpu.ops.rle import default_budget
    g = GeometryGeneratorTPU()
    cap = default_budget(1600, 1600)
    # cold: no stat -> the conservative dense-frame default
    assert g._pack_budget(1600, 1600) == cap
    # warm: 2x headroom over the observed max, power-of-2 quantized
    g._run_stats["mg4:1600x1600:M"] = 14460
    assert g._pack_budget(1600, 1600) == 32768
    # monotone in the stat; never exceeds the dense default
    g._run_stats["mg4:1600x1600:M"] = 10 * cap
    assert g._pack_budget(1600, 1600) == cap
    # tiny canvases: the default is already below the 4096 floor
    assert g._pack_budget(64, 64) == default_budget(64, 64)
    g.close()
