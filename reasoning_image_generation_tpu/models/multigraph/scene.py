# scene.py — multigraph scene construction (host control plane).
"""Builds fixed-shape scene arrays for the single-image pipeline.

The reference (multigraph_generation/) builds matplotlib patch objects and
runs shapely boolean/search geometry per sample.  Here every sample becomes
a small fixed-size array bundle (the *scene*): up to 3 shape polygons, up to
3 mask polygons, up to 24 decoration line segments — which the device renderer
(renderer.py) rasterizes in one batched program.  All pixel work is on
device; this module is the tiny host control plane (microseconds/sample)
that replaces shapely searches with closed-form candidate scans.

Geometry sources (all reference file:line cites into /root/reference):
- shape family + size distributions: multigraph_generation/generator.py:87-150
- canvas: 8x8in figure, data bounds ±5, equal aspect, axis off
  (multigraph_generation/generator.py:488-493)
- styles: outline-only, black edges, lw U[1.5,2], alpha 0.9
  (multigraph_generation/style.py:29-66); 40% random rotation (generator.py:239)
- decorations radial/grid/polygon/chords:
  multigraph_generation/single_variants.py:233-396
- masks cut/replace_boundary: multigraph_generation/single_variants.py:398-633
- nested/adjacent/intersecting: multigraph_generation/multi_combinator.py:685,774,1097
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_SHAPES = 3
MAX_MASKS = 3
MAX_LINES = 24
NV = 64  # vertices per polygon (circles/ellipses/arcs are 64-gons)

BOUNDS = (-5.0, 5.0)

# matplotlib default prop cycle (decoration ax.plot() draws use it,
# multigraph_generation/single_variants.py:285-288)
MPL_CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
             "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]

_NAMED = {"black": (0, 0, 0), "gray": (128, 128, 128),
          "darkgray": (169, 169, 169), "white": (255, 255, 255)}


def hex_to_rgb(c: str) -> Tuple[float, float, float]:
    if c in _NAMED:
        return tuple(float(v) for v in _NAMED[c])
    c = c.lstrip("#")
    return tuple(float(int(c[i:i + 2], 16)) for i in (0, 2, 4))


# ---------------------------------------------------------------------------
# polygon constructors (data space, y-up)
# ---------------------------------------------------------------------------

def _resample(pts: np.ndarray, n: int = NV) -> np.ndarray:
    """Pad/resample a closed polygon outline to exactly n vertices by
    splitting the longest edges (keeps corners exact).

    Implemented as a piece list instead of repeated np.insert — the
    one-roll-one-insert-per-vertex loop was ~30% of the whole mg scene
    build.  Semantics are bit-identical to the original loop: greedy
    longest-piece halving in polygon order, first-max tie-break
    (np.argmax), lengths recomputed with np.hypot at each split."""
    pts = np.asarray(pts, np.float64)
    m = len(pts)
    if m >= n:
        return pts[:n].astype(np.float32)
    # pieces in polygon order: [start_point, end_point, length]
    seg = np.concatenate([pts[1:], pts[:1]]) - pts
    lens = np.hypot(seg[:, 0], seg[:, 1])
    pieces = [[pts[i], pts[(i + 1) % m], float(lens[i])] for i in range(m)]
    for _ in range(n - m):
        i = max(range(len(pieces)), key=lambda j: pieces[j][2])
        p0, p1, _L = pieces[i]
        mid = (p0 + p1) / 2
        d0, d1 = mid - p0, p1 - mid
        pieces[i:i + 1] = [[p0, mid, float(np.hypot(d0[0], d0[1]))],
                           [mid, p1, float(np.hypot(d1[0], d1[1]))]]
    return np.asarray([pc[0] for pc in pieces[:n]], np.float32)


def circle_poly(c, r) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, NV, endpoint=False)
    return np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], -1).astype(np.float32)


def ellipse_poly(c, w, h, angle_deg) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, NV, endpoint=False)
    x = (w / 2) * np.cos(t)
    y = (h / 2) * np.sin(t)
    a = math.radians(angle_deg)
    ca, sa = math.cos(a), math.sin(a)
    return np.stack([c[0] + x * ca - y * sa, c[1] + x * sa + y * ca], -1).astype(np.float32)


def rect_poly(xy, w, h, round_corner: float = 0.0) -> np.ndarray:
    x, y = xy
    if round_corner <= 0:
        pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
        return _resample(np.asarray(pts))
    # FancyBboxPatch round corner: pad radius = round_corner (data units)
    r = min(round_corner, w / 2, h / 2)
    cs = [(x + w - r, y + r, -90), (x + w - r, y + h - r, 0),
          (x + r, y + h - r, 90), (x + r, y + r, 180)]
    pts = []
    for cx, cy, start in cs:
        for t in np.linspace(start, start + 90, 8):
            a = math.radians(t)
            pts.append((cx + r * math.cos(a), cy + r * math.sin(a)))
    return _resample(np.asarray(pts))


def regular_poly(c, n_edges, r, orientation: float = 0.0) -> np.ndarray:
    # matplotlib RegularPolygon: first vertex at angle orientation + pi/2
    t = orientation + np.pi / 2 + 2 * np.pi * np.arange(n_edges) / n_edges
    pts = np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], -1)
    return _resample(pts)


def wedge_poly(c, r, theta1, theta2) -> np.ndarray:
    sweep = (theta2 - theta1) % 360.0
    if sweep == 0:
        sweep = 360.0
    arc = np.radians(theta1 + np.linspace(0, sweep, NV - 1))
    pts = np.concatenate([
        np.asarray([[c[0], c[1]]]),
        np.stack([c[0] + r * np.cos(arc), c[1] + r * np.sin(arc)], -1)])
    return pts.astype(np.float32)


def rotate_poly(pts: np.ndarray, deg: float, about=None) -> np.ndarray:
    about = np.mean(pts, 0) if about is None else np.asarray(about)
    a = math.radians(deg)
    ca, sa = math.cos(a), math.sin(a)
    rel = pts - about
    return (about + np.stack([rel[:, 0] * ca - rel[:, 1] * sa,
                              rel[:, 0] * sa + rel[:, 1] * ca], -1)).astype(np.float32)


# ---------------------------------------------------------------------------
# polygon predicates (vectorized numpy)
# ---------------------------------------------------------------------------

def poly_centroid(pts: np.ndarray) -> np.ndarray:
    """Area centroid of a simple polygon."""
    x, y = pts[:, 0], pts[:, 1]
    xn = np.concatenate([x[1:], x[:1]])
    yn = np.concatenate([y[1:], y[:1]])
    cross = x * yn - xn * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return pts.mean(0)
    cx = ((x + xn) * cross).sum() / (6 * a)
    cy = ((y + yn) * cross).sum() / (6 * a)
    return np.asarray([cx, cy])


def poly_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return float(abs((x * np.roll(y, -1) - np.roll(x, -1) * y).sum()) / 2.0)


def points_in_poly(p: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd inside test. p [N,2], poly [V,2] -> bool [N].
    (Next-vertex arrays come from concatenate, not np.roll — this sits in
    the adjacency sweep's innermost loop and np.roll's axis normalization
    overhead dominated the whole mg scene build.)"""
    x, y = p[:, 0:1], p[:, 1:2]
    ax, ay = poly[:, 0][None], poly[:, 1][None]
    nxt = np.concatenate([poly[1:], poly[:1]])
    bx, by = nxt[:, 0][None], nxt[:, 1][None]
    cond = (ay > y) != (by > y)
    ey = by - ay
    ey = np.where(ey == 0, 1.0, ey)
    xint = ax + (y - ay) * (bx - ax) / ey
    return (np.sum(cond & (x < xint), axis=1) % 2) == 1


def ray_poly_hit(origin, direction, poly: np.ndarray) -> Optional[np.ndarray]:
    """First ray-boundary intersection (multigraph_generation/
    single_variants.py:37-58 2x2 solve, vectorized over edges)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    a = poly.astype(np.float64)
    b = np.roll(a, -1, 0)
    v = b - a
    det = v[:, 0] * (-d[1]) - v[:, 1] * (-d[0])
    ok = np.abs(det) > 1e-10
    det = np.where(ok, det, 1.0)
    rhs = o - a
    t = (rhs[:, 0] * (-d[1]) - rhs[:, 1] * (-d[0])) / det
    s = (v[:, 0] * rhs[:, 1] - v[:, 1] * rhs[:, 0]) / det
    hit = ok & (t >= -1e-9) & (t <= 1 + 1e-9) & (s >= -1e-9)
    if not hit.any():
        return None
    s = np.where(hit, s, np.inf)
    j = int(np.argmin(s))
    return (a[j] + t[j] * v[j]).astype(np.float64)


def polys_overlap(a: np.ndarray, b: np.ndarray, n_grid: int = 24) -> bool:
    """Area-overlap test: any of b's interior grid points inside a, or
    vertex containment either way (replaces shapely .overlaps)."""
    # bbox fast-reject: the adjacency sweeps probe hundreds of candidate
    # translations per scene, most of them nowhere near the placed shapes
    if ((a.max(0) <= b.min(0)) | (b.max(0) <= a.min(0))).any():
        return False
    if points_in_poly(b, a).any() or points_in_poly(a, b).any():
        # vertex of one strictly inside the other == area overlap for convex
        # shapes; tolerate boundary touches with a small shrink
        ca, cb = poly_centroid(a), poly_centroid(b)
        a_sh = ca + (a - ca) * 0.999
        b_sh = cb + (b - cb) * 0.999
        return bool(points_in_poly(b_sh, a_sh).any() or
                    points_in_poly(a_sh, b_sh).any())
    return False


def points_in_polys(p: np.ndarray, polys: np.ndarray) -> np.ndarray:
    """Even-odd test of p [M,2] against a batch of polygons [K,V,2]
    -> bool [K,M].  Batched form of points_in_poly for the adjacency
    sweeps, which probe hundreds of candidate translations per scene."""
    x, y = p[:, 0][None, :, None], p[:, 1][None, :, None]
    a = polys[:, None, :, :]
    nxt = np.concatenate([polys[:, 1:], polys[:, :1]], axis=1)[:, None, :, :]
    cond = (a[..., 1] > y) != (nxt[..., 1] > y)
    ey = nxt[..., 1] - a[..., 1]
    ey = np.where(ey == 0, 1.0, ey)
    xint = a[..., 0] + (y - a[..., 1]) * (nxt[..., 0] - a[..., 0]) / ey
    return (np.sum(cond & (x < xint), axis=-1) % 2) == 1


def _batch_centroids(polys: np.ndarray) -> np.ndarray:
    """Shoelace centroids of a polygon batch [K,V,2] -> [K,2] (degenerate
    polygons fall back to the vertex mean, like poly_centroid)."""
    x, y = polys[..., 0], polys[..., 1]
    xn = np.concatenate([x[:, 1:], x[:, :1]], axis=1)
    yn = np.concatenate([y[:, 1:], y[:, :1]], axis=1)
    cross = x * yn - xn * y
    a = cross.sum(1) / 2.0
    ok = np.abs(a) >= 1e-12
    sa = np.where(ok, 6 * a, 1.0)
    cx = ((x + xn) * cross).sum(1) / sa
    cy = ((y + yn) * cross).sum(1) / sa
    mean = polys.mean(1)
    return np.where(ok[:, None], np.stack([cx, cy], -1), mean)


def polys_overlap_batch(cands: np.ndarray, q: np.ndarray) -> np.ndarray:
    """polys_overlap(cands[k], q) for a candidate batch [K,V,2] -> bool [K],
    same predicate (vertex containment either way, boundary touches
    tolerated via the 0.999 shrink re-test)."""
    K = cands.shape[0]
    out = np.zeros(K, bool)
    # bbox reject
    clo, chi = cands.min(1), cands.max(1)
    qlo, qhi = q.min(0), q.max(0)
    near = ~(((chi <= qlo[None]) | (qhi[None] <= clo)).any(1))
    if not near.any():
        return out
    idx = np.nonzero(near)[0]
    sub = cands[idx]
    hit = (points_in_polys(q, sub).any(1) |
           points_in_poly(sub.reshape(-1, 2), q).reshape(len(idx), -1).any(1))
    if hit.any():
        h = idx[hit]
        sh = cands[h]
        c = _batch_centroids(sh)[:, None, :]
        sh_shrunk = (c + (sh - c) * 0.999).astype(cands.dtype)
        cq = poly_centroid(q)
        q_shrunk = (cq + (q - cq) * 0.999)
        real = (points_in_polys(q_shrunk, sh_shrunk).any(1) |
                points_in_poly(sh_shrunk.reshape(-1, 2), q_shrunk).reshape(
                    len(h), -1).any(1))
        out[h] = real
    return out


def poly_min_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Min distance between polygon boundaries (sampled edges)."""
    d = a[:, None, :] - b[None, :, :]
    return float(np.sqrt((d ** 2).sum(-1)).min())


def overlap_area(a: np.ndarray, b: np.ndarray, n_grid: int = 48) -> float:
    """Approximate intersection area by grid coverage of the tighter bbox."""
    lo = np.maximum(a.min(0), b.min(0))
    hi = np.minimum(a.max(0), b.max(0))
    if (hi <= lo).any():
        return 0.0
    xs = np.linspace(lo[0], hi[0], n_grid)
    ys = np.linspace(lo[1], hi[1], n_grid)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    inside = points_in_poly(pts, a) & points_in_poly(pts, b)
    cell = ((hi[0] - lo[0]) / n_grid) * ((hi[1] - lo[1]) / n_grid)
    return float(inside.sum() * cell)


# ---------------------------------------------------------------------------
# scene container
# ---------------------------------------------------------------------------

def empty_scene() -> Dict[str, np.ndarray]:
    return {
        "shape_verts": np.zeros((MAX_SHAPES, NV, 2), np.float32),
        "shape_lw": np.zeros((MAX_SHAPES,), np.float32),
        "shape_alpha": np.zeros((MAX_SHAPES,), np.float32),
        "shape_valid": np.zeros((MAX_SHAPES,), bool),
        "mask_verts": np.zeros((MAX_MASKS, NV, 2), np.float32),
        "mask_valid": np.zeros((MAX_MASKS,), bool),
        "mask_mode": np.zeros((), np.int32),  # 0 none, 1 cut, 2 replace
        # radial gradient fills (StyleEnhancer.apply_gradient capability,
        # multigraph_generation/style.py:68-119 — defined but never called
        # by the reference generator; available here per shape)
        "grad_valid": np.zeros((MAX_SHAPES,), bool),
        "grad_c0": np.zeros((MAX_SHAPES, 3), np.float32),
        "grad_c1": np.zeros((MAX_SHAPES, 3), np.float32),
        "grad_alpha": np.zeros((MAX_SHAPES,), np.float32),
        "line_pts": np.zeros((MAX_LINES, 4), np.float32),  # x0,y0,x1,y1
        "line_lw": np.zeros((MAX_LINES,), np.float32),
        "line_alpha": np.zeros((MAX_LINES,), np.float32),
        "line_color": np.zeros((MAX_LINES, 3), np.float32),
        "line_valid": np.zeros((MAX_LINES,), bool),
    }


class _SceneBuilder:
    def __init__(self):
        self.scene = empty_scene()
        self._n_lines = 0
        self._cycle = 0

    def add_shape(self, i, verts, lw, alpha=0.9):
        s = self.scene
        s["shape_verts"][i] = verts
        s["shape_lw"][i] = lw
        s["shape_alpha"][i] = alpha
        s["shape_valid"][i] = True

    def add_mask(self, i, verts):
        self.scene["mask_verts"][i] = verts
        self.scene["mask_valid"][i] = True

    def add_gradient(self, i, c0, c1, alpha=0.75):
        s = self.scene
        s["grad_valid"][i] = True
        s["grad_c0"][i] = c0
        s["grad_c1"][i] = c1
        s["grad_alpha"][i] = alpha

    def next_cycle_color(self):
        c = MPL_CYCLE[self._cycle % len(MPL_CYCLE)]
        self._cycle += 1
        return hex_to_rgb(c)

    def add_line(self, p0, p1, lw, alpha, color):
        if self._n_lines >= MAX_LINES:
            return
        s = self.scene
        k = self._n_lines
        s["line_pts"][k] = [p0[0], p0[1], p1[0], p1[1]]
        s["line_lw"][k] = lw
        s["line_alpha"][k] = alpha
        s["line_color"][k] = color
        s["line_valid"][k] = True
        self._n_lines += 1


# ---------------------------------------------------------------------------
# base-shape sampling (generator.py:87-150 distributions)
# ---------------------------------------------------------------------------

SHAPE_TYPES = ("circle", "ellipse", "rectangle", "regular_polygon", "sector")


def _sample_base_shape(rng: random.Random, mode: str, global_scale: float):
    """One base shape, already centered like _center_shapes_to_canvas
    (multigraph_generation/generator.py:152-196: circle/ellipse/polygon/wedge
    centered at origin; rectangle's LOWER-LEFT placed at the center — a
    reference quirk we replicate)."""
    name = rng.choice(SHAPE_TYPES)
    raw = 3.0 if mode == "random" else rng.uniform(2.2, 3.2)
    size = raw * global_scale
    meta = {"shape_type": name, "size": size}
    if name == "circle":
        verts = circle_poly((0, 0), size / 2)
        meta["size"] = size / 2
    elif name == "ellipse":
        ang = rng.uniform(-180.0, 180.0)
        verts = ellipse_poly((0, 0), size, size * 0.6, ang)
        meta["rotation"] = ang
        meta["size"] = (size, size * 0.6)
    elif name == "rectangle":
        rc = rng.uniform(0.0, 0.5) if rng.random() < 0.3 else 0.0
        verts = rect_poly((0, 0), size, size * 0.6, rc)
        meta["size"] = (size, size * 0.6)
        meta["round_corner"] = rc
    elif name == "regular_polygon":
        n = rng.randint(3, 8)
        verts = regular_poly((0, 0), n, size / 2)
        meta["num_edges"] = n
        meta["size"] = size / 2
    else:  # sector
        t1 = rng.uniform(0, 180)
        t2 = rng.uniform(90, 360)
        verts = wedge_poly((0, 0), size / 2, t1, t2)
        meta.update(theta1=t1, theta2=t2, size=size / 2)
        meta["wedge_center"] = (0.0, 0.0)
    return name, verts, meta


# ---------------------------------------------------------------------------
# single-shape variants
# ---------------------------------------------------------------------------

def _point_on_boundary(verts, origin, angle):
    hit = ray_poly_hit(origin, (math.cos(angle), math.sin(angle)), verts)
    return tuple(hit) if hit is not None else tuple(origin)


def _bbox_center(verts):
    lo, hi = verts.min(0), verts.max(0)
    return (lo + hi) / 2.0


def _wedge_arc(meta):
    if meta.get("theta1") is None:
        return 0.0, 2 * math.pi
    a1 = math.radians(meta["theta1"] % 360.0)
    a2 = math.radians(meta["theta2"] % 360.0)
    return a1, a2


def _sample_in_arc(rng, a1, a2):
    if a1 <= a2:
        return a1 + rng.random() * (a2 - a1)
    total = 2 * math.pi - a1 + a2
    r = rng.random() * total
    return a1 + r if r <= 2 * math.pi - a1 else r - (2 * math.pi - a1)


def add_decorations(b: _SceneBuilder, rng: random.Random, verts, meta,
                    style: str):
    """Internal decoration lines (single_variants.py:233-396)."""
    center = _bbox_center(verts)
    is_wedge = meta["shape_type"] == "sector"
    ray_origin = np.asarray(meta.get("wedge_center", center)) if is_wedge else center
    if is_wedge:
        sweep = (meta["theta2"] - meta["theta1"] + 360) % 360
        n = rng.randint(1, int(sweep // 45) + 1)
    else:
        n = rng.randint(1, 6)

    if style == "radial":
        a1, a2 = _wedge_arc(meta if is_wedge else {})
        if a1 <= a2:
            angles = a1 + (a2 - a1) * np.arange(n) / n
        else:
            total = 2 * math.pi - a1 + a2
            angles = (a1 + total * np.arange(n) / n) % (2 * math.pi)
        for ang in angles:
            end = _point_on_boundary(verts, ray_origin, ang)
            b.add_line(center, end, rng.uniform(0.6, 1.4), 0.9,
                       b.next_cycle_color())
    elif style == "grid":
        lo, hi = verts.min(0), verts.max(0)
        for i in range(1, n + 1):  # horizontal stripes (incl. top edge)
            y = lo[1] + (hi[1] - lo[1]) * i / n
            xs = np.linspace(lo[0], hi[0], 200)
            pts = np.stack([xs, np.full_like(xs, y)], -1)
            inside = points_in_poly(pts, verts)
            if inside.any():
                xi = xs[inside]
                b.add_line((xi.min(), y), (xi.max(), y), 1.2, 0.8,
                           b.next_cycle_color())
        for i in range(1, n):      # vertical stripes
            x = lo[0] + (hi[0] - lo[0]) * i / n
            ys = np.linspace(lo[1], hi[1], 200)
            pts = np.stack([np.full_like(ys, x), ys], -1)
            inside = points_in_poly(pts, verts)
            if inside.any():
                yi = ys[inside]
                b.add_line((x, yi.min()), (x, yi.max()), 1.2, 0.8,
                           b.next_cycle_color())
    elif style == "polygon":
        m = rng.randint(3, 8)
        if is_wedge:
            a1, a2 = _wedge_arc(meta)
            angles = np.sort([_sample_in_arc(rng, a1, a2) for _ in range(m)])
        else:
            angles = np.sort([rng.uniform(0, 2 * math.pi) for _ in range(m)])
        pts = [_point_on_boundary(verts, ray_origin, a) for a in angles]
        lw = rng.uniform(0.8, 1.4)
        color = hex_to_rgb(rng.choice(["black", "gray", "darkgray"]))
        for i in range(m):
            b.add_line(pts[i], pts[(i + 1) % m], lw, 0.9, color)
    else:  # random chords
        a1, a2 = _wedge_arc(meta if is_wedge else {})
        for _ in range(n):
            if is_wedge:
                aa1 = _sample_in_arc(rng, a1, a2)
                aa2 = _sample_in_arc(rng, a1, a2)
            else:
                aa1 = rng.uniform(0, 2 * math.pi)
                aa2 = rng.uniform(0, 2 * math.pi)
            p1 = _point_on_boundary(verts, ray_origin, aa1)
            p2 = _point_on_boundary(verts, ray_origin, aa2)
            b.add_line(p1, p2, rng.uniform(0.8, 1.2), 0.9,
                       b.next_cycle_color())
    return {"has_decoration": True, "decoration_style": style,
            "n_decorations": int(n)}


def add_masks(b: _SceneBuilder, rng: random.Random, verts, mask_type: str):
    """Occlusion masks (single_variants.py:444-482): 1-3 circles/rects sized
    0.5-1.2x the base, centered at a point inside the base."""
    lo, hi = verts.min(0), verts.max(0)
    n_masks = rng.randint(1, 3)
    if mask_type == "random":
        mask_type = "cut" if rng.random() < 0.5 else "replace_boundary"
    infos = []
    for m in range(n_masks):
        for _ in range(1000):
            x = rng.uniform(lo[0], hi[0])
            y = rng.uniform(lo[1], hi[1])
            if points_in_poly(np.asarray([[x, y]]), verts)[0]:
                break
        else:
            x, y = (lo + hi) / 2.0
        base_size = min(hi[0] - lo[0], hi[1] - lo[1])
        msize = base_size * rng.uniform(0.5, 1.2)
        if rng.random() < 0.5:
            mv = circle_poly((x, y), msize / 2)
            infos.append({"type": "circle", "center": (x, y), "radius": msize / 2})
        else:
            w = msize * rng.uniform(0.8, 1.2)
            h = msize * rng.uniform(0.8, 1.2)
            mv = rect_poly((x - w / 2, y - h / 2), w, h)
            infos.append({"type": "rectangle", "xy": (x - w / 2, y - h / 2),
                          "width": w, "height": h})
        b.add_mask(m, mv)
    b.scene["mask_mode"] = np.asarray(1 if mask_type == "cut" else 2, np.int32)
    return {"has_mask": True, "mask_type": mask_type, "masks": infos}


def deform_edge(rng: random.Random, verts: np.ndarray,
                normal_range: float = 0.18,
                random_range: float = 0.12) -> np.ndarray:
    """Midpoint edge deformation (single_variants.py:636-683).

    The reference defines this but ships with the call commented out
    (generator.py:218-224); provided here as an applied capability: each
    edge midpoint is displaced either along the edge normal (±0.18) or by a
    random offset (±0.12), doubling the vertex count."""
    out = []
    n = len(verts)
    for i in range(n):
        p1 = verts[i]
        p2 = verts[(i + 1) % n]
        out.append(p1)
        mid = (p1 + p2) / 2.0
        if rng.random() < 0.5:
            edge = p2 - p1
            nrm = np.asarray([-edge[1], edge[0]])
            ln = np.hypot(*nrm)
            if ln > 1e-8:
                nrm = nrm / ln
            mid = mid + nrm * rng.uniform(-normal_range, normal_range)
        else:
            mid = mid + np.asarray([rng.uniform(-random_range, random_range),
                                    rng.uniform(-random_range, random_range)])
        out.append(mid)
    return np.asarray(out, np.float32)


# ---------------------------------------------------------------------------
# multi-shape combinators (SDF/grid versions of the shapely searches)
# ---------------------------------------------------------------------------

def combine_nested(shapes: List[np.ndarray], scale_factor=0.4, min_size=0.25,
                   same_center: bool = True):
    """Layer i scaled by scale_factor**i about its centroid; with
    `same_center` (the default) every inner layer is then translated to
    the outer centroid, otherwise each stays at its own centroid
    (reference multi_combinator.py:685-768, target_centroid at :712)."""
    out = []
    outer_c = poly_centroid(shapes[0])
    for i, v in enumerate(shapes):
        s = 1.0 if i == 0 else scale_factor ** i
        c = poly_centroid(v)
        sv = c + (v - c) * s
        dims = sv.max(0) - sv.min(0)
        if max(dims) < min_size:
            sv = poly_centroid(sv) + (sv - poly_centroid(sv)) * (min_size / max(dims))
        if i > 0 and same_center:
            sv = sv + (outer_c - poly_centroid(sv))
        out.append(sv.astype(np.float32))
    return out


def _poly_is_convex(poly: np.ndarray) -> bool:
    """True when every (non-degenerate) turn has the same sign.  The
    64-gon resampling leaves many near-collinear vertices, so turns below
    1e-6 of the max are ignored."""
    a = np.asarray(poly, np.float64)
    b = np.roll(a, -1, 0)
    c = np.roll(a, -2, 0)
    cr = ((b[:, 0] - a[:, 0]) * (c[:, 1] - b[:, 1])
          - (b[:, 1] - a[:, 1]) * (c[:, 0] - b[:, 0]))
    m = float(np.abs(cr).max())
    if m <= 0.0:
        return True
    s = cr[np.abs(cr) > 1e-6 * m]
    return bool((s >= 0).all() or (s <= 0).all())


def _poly_seg_distance(poly: np.ndarray, a, b) -> float:
    """Min distance from polygon vertices to segment a-b (vectorized)."""
    a = np.asarray(a, np.float64)
    ab = np.asarray(b, np.float64) - a
    ab2 = float((ab ** 2).sum()) or 1e-12
    t = np.clip(((poly - a) * ab).sum(1) / ab2, 0.0, 1.0)
    proj = a + t[:, None] * ab
    d = poly - proj
    return float(np.hypot(d[:, 0], d[:, 1]).min())


def _try_point_adjacency(cur, ref, placed, spacing=0.0, gap_tol=1e-8):
    """Vertex-of-cur projected onto each edge-of-ref; translate so the
    vertex sits `spacing` from that edge; first non-overlapping placement
    wins (reference multi_combinator.py:908-955).

    Candidate pruning: when BOTH shapes are convex, for each ref edge
    only ONE cur vertex can sit on it without cur crossing the edge's
    line — the support vertex along the edge's outward normal.  That cuts
    the V*E brute-force candidate set (the mg pipeline's measured host
    bottleneck at ~67 ms/scene) to E analytic candidates.  Sector shapes
    spanning >180 deg (wedge_poly) are non-convex: the prune (and the
    centroid-based normal flip) can miss placements the reference's
    exhaustive vertex x edge search finds, so those fall back to the full
    vertex loop.  The overlap check against every placed shape guards
    each candidate either way."""
    a = np.asarray(ref, np.float64)
    b = np.concatenate([a[1:], a[:1]])
    ab = b - a
    ab2 = np.maximum((ab ** 2).sum(1), 1e-12)
    P = np.asarray(cur, np.float64)
    E = len(a)
    if _poly_is_convex(cur) and _poly_is_convex(ref):
        # outward edge normals (away from the ref centroid)
        n = np.stack([ab[:, 1], -ab[:, 0]], -1)
        n /= np.maximum(np.hypot(n[:, 0], n[:, 1]), 1e-12)[:, None]
        mid = (a + b) / 2.0
        flip = ((mid - poly_centroid(a)) * n).sum(1) < 0
        n[flip] *= -1.0
        # support vertex of cur along each outward normal: the innermost
        # vertex, so every other vertex lands strictly outside the edge line
        cand_vids = np.argmin(P @ n.T, axis=0)[:, None]     # [E, 1]
    else:
        cand_vids = np.tile(np.arange(len(P)), (E, 1))      # [E, V] full
    for e in range(E):
        for vid in cand_vids[e]:
            p = P[vid]
            t = float(np.clip(((p - a[e]) * ab[e]).sum() / ab2[e], 0.0, 1.0))
            proj = a[e] + t * ab[e]
            vec = proj - p
            dist = float(np.hypot(vec[0], vec[1]))
            needed = dist - spacing
            if abs(needed) <= gap_tol:
                if not any(polys_overlap(cur, q) for q in placed):
                    return cur
                continue
            if dist < 1e-12:
                continue  # reference's degenerate edge-normal case
            cand = (cur + (vec / dist * needed)).astype(np.float32)
            if any(polys_overlap(cand, q) for q in placed):
                continue
            if abs(_poly_seg_distance(cand, a[e], b[e]) - spacing) <= 1e-4:
                return cand
    return None


def _try_edge_adjacency(cur, ref, placed, spacing=0.0):
    """Bbox-edge matching: translate cur along the ref bbox edge normal by
    spacing - distance (reference multi_combinator.py:957-997, including
    its sign convention)."""
    rx0, ry0 = ref.min(0)
    rx1, ry1 = ref.max(0)
    cx0, cy0 = cur.min(0)
    cx1, cy1 = cur.max(0)
    ref_h = [((rx0, ry0), (rx1, ry0)), ((rx0, ry1), (rx1, ry1))]
    ref_v = [((rx0, ry0), (rx0, ry1)), ((rx1, ry0), (rx1, ry1))]
    cur_h = [((cx0, cy0), (cx1, cy0)), ((cx0, cy1), (cx1, cy1))]
    cur_v = [((cx0, cy0), (cx0, cy1)), ((cx1, cy0), (cx1, cy1))]
    for (p0, p1) in ref_h + ref_v:
        is_h = abs(p0[1] - p1[1]) < 1e-8
        for (q0, q1) in (cur_h if is_h else cur_v):
            # parallel axis-aligned segments: endpoint-to-segment min is exact
            dist_now = min(_poly_seg_distance(np.asarray([q0, q1]), p0, p1),
                           _poly_seg_distance(np.asarray([p0, p1]), q0, q1))
            needed = spacing - dist_now
            dxe, dye = p1[0] - p0[0], p1[1] - p0[1]
            el = math.hypot(dxe, dye) or 1.0
            nx, ny = -dye / el, dxe / el
            cand = (cur + np.asarray([nx * needed, ny * needed])).astype(
                np.float32)
            if any(polys_overlap(cand, q) for q in placed):
                continue
            if abs(_poly_seg_distance(cand, p0, p1) - spacing) <= 1e-4:
                return cand
    return None


def combine_adjacent(rng: random.Random, shapes: List[np.ndarray],
                     sample_n: int = 60, ladder: int = 12,
                     spacing: float = 0.0):
    """Touch-without-overlap placement (gap = `spacing`, default touch).

    Strategy order matches the reference (multi_combinator.py:812, 908-1047):
    pick 'edge' or 'point' adjacency at random, try that strategy's
    deterministic projection placement, and only fall back to the
    angle x distance-ladder sweep (whose shuffle uses the reference's fixed
    Random(0) stream, multi_combinator.py:869) when it fails.  `spacing`
    follows the reference's keyword (multi_combinator.py:780): the sweep
    accepts |dist - spacing| within tolerance (:1019-1029) and the final
    snap closes the gap down to `spacing` instead of touch.
    """
    placed = [shapes[0]]
    for i in range(1, len(shapes)):
        cur = shapes[i]
        cur_c = poly_centroid(cur)
        # nearest placed shape is the reference
        ref = min(placed, key=lambda p: np.hypot(*(poly_centroid(p) - cur_c)))

        adjacency_type = rng.choice(["edge", "point"])
        strat = (_try_point_adjacency if adjacency_type == "point"
                 else _try_edge_adjacency)
        direct = strat(cur, ref, placed, spacing=spacing)
        if direct is not None:
            placed.append(direct.astype(np.float32))
            continue

        ref_w, ref_h = ref.max(0) - ref.min(0)
        cur_w, cur_h = cur.max(0) - cur.min(0)
        size_based = max((ref_w + cur_w) / 2.0, (ref_h + cur_h) / 2.0)
        initial = max(poly_min_distance(ref, cur), size_based * 0.5, 1e-3)

        angles = list(np.linspace(0, 2 * np.pi, sample_n, endpoint=False))
        random.Random(0).shuffle(angles)
        # whole-ring candidate batch per distance step (the per-angle loop
        # paid a polys_overlap per candidate); first-success order is the
        # shuffled angle order, as before
        dirs = np.asarray([[math.cos(th), math.sin(th)] for th in angles])
        best = None
        scale_step = 1.0
        while scale_step <= 50 and best is None:
            d = initial * scale_step
            cands = (cur[None] +
                     (dirs * d)[:, None, :].astype(np.float32)).astype(
                         np.float32)
            over = np.zeros(len(angles), bool)
            for p in placed:
                over |= polys_overlap_batch(cands, p)
            dd = cands[:, :, None, :] - np.asarray(ref)[None, None, :, :]
            dmin = np.sqrt((dd ** 2).sum(-1)).min((1, 2))
            if spacing == 0.0:
                near = dmin <= size_based * 0.02
            else:  # reference multi_combinator.py:1028
                near = np.abs(dmin - spacing) <= max(size_based * 0.02, 1e-3)
            ok = ~over & near
            hit = np.nonzero(ok)[0]
            if hit.size:
                best = cands[hit[0]]
            scale_step *= 1.4
        if best is None:  # force-push fallback (multi_combinator.py:1035-1047)
            ref_c = poly_centroid(ref)
            direction = cur_c - ref_c
            nrm = np.hypot(*direction) or 1.0
            direction = direction / nrm
            d = initial
            for _ in range(200):
                cand = cur + (direction * d).astype(np.float32)
                if not any(polys_overlap(cand, p) for p in placed):
                    best = cand
                    break
                d *= 1.25
            else:
                best = cur
        # snap: binary-search the distance toward ref to close the gap
        # down to `spacing` (touch when 0)
        gap = poly_min_distance(best, ref)
        if gap - spacing > 1e-4:
            ref_c = poly_centroid(ref)
            dirn = ref_c - poly_centroid(best)
            nrm = np.hypot(*dirn)
            if nrm > 1e-9:
                dirn = dirn / nrm
                lo_t, hi_t = 0.0, gap - spacing
                for _ in range(20):
                    mid = (lo_t + hi_t) / 2
                    cand = best + (dirn * mid).astype(np.float32)
                    if (any(polys_overlap(cand, p) for p in placed)
                            or poly_min_distance(cand, ref) < spacing):
                        hi_t = mid
                    else:
                        lo_t = mid
                best = best + (dirn * lo_t).astype(np.float32)
        placed.append(best.astype(np.float32))
    return placed


def combine_intersecting(rng: random.Random, shapes: List[np.ndarray],
                         max_attempts: int = 50, min_overlap_ratio=0.05):
    """Substantial-overlap placement (multi_combinator.py:1097-1222).

    The reference uses a FIXED random.Random(42) stream for the translation
    search; we keep that quirk for distributional parity."""
    search_rng = random.Random(42)
    placed = [shapes[0]]
    for i in range(1, len(shapes)):
        cur = shapes[i]
        cur_c = poly_centroid(cur)
        cur_area = poly_area(cur)
        ref = min(placed, key=lambda p: np.hypot(*(poly_centroid(p) - cur_c)))
        ref_area = poly_area(ref)
        rb_lo, rb_hi = ref.min(0), ref.max(0)
        cb_lo, cb_hi = cur.min(0), cur.max(0)
        target = None
        for _ in range(max_attempts):
            dx = search_rng.uniform(rb_lo[0] - cb_hi[0], rb_hi[0] - cb_lo[0])
            dy = search_rng.uniform(rb_lo[1] - cb_hi[1], rb_hi[1] - cb_lo[1])
            cand = cur + np.asarray([dx, dy], np.float32)
            ov = overlap_area(cand, ref)
            min_ov = min(cur_area, ref_area) * min_overlap_ratio
            if ov >= min_ov and not any(
                    overlap_area(cand, p) > min_ov for p in placed if p is not ref):
                target = cand
                break
        if target is None:  # center-overlap fallback
            target = cur + (poly_centroid(ref) - cur_c).astype(np.float32)
        placed.append(target.astype(np.float32))
    return placed


# ---------------------------------------------------------------------------
# full scene sampling
# ---------------------------------------------------------------------------

def build_scene(seed: int, mode: str = "random",
                global_scale: float = 1.3,
                nested_same_center: bool = True,
                adjacent_spacing: float = 0.0) -> Tuple[Dict, Dict]:
    """Sample one scene.  Returns (scene arrays, record metadata dict).

    mode: random (single shape w/ decoration or mask) |
          nested | adjacent | intersecting (multi-shape).
    Matches generator.py:496: shape_count = 1 if random else 2-3.
    `nested_same_center`/`adjacent_spacing` expose the reference
    combinators' keyword variants (multi_combinator.py:686,780); the
    defaults match the reference generator's calls."""
    rng = random.Random(seed)
    b = _SceneBuilder()
    shape_count = 1 if mode == "random" else rng.randint(2, 3)

    names, verts_list, metas = [], [], []
    for i in range(shape_count):
        name, verts, meta = _sample_base_shape(rng, mode, global_scale)
        names.append(name)
        verts_list.append(verts)
        meta["shape_id"] = f"{name}_{i}"
        metas.append(meta)

    shapes_meta = []
    if shape_count == 1:
        lw = rng.uniform(1.5, 2.0)
        verts = verts_list[0]
        extra = {}
        if rng.random() < 0.7:
            style = rng.choice(["radial", "grid", "random", "polygon"])
            extra = add_decorations(b, rng, verts, metas[0], style)
        else:
            mask_type = rng.choice(["cut", "replace_boundary"])
            extra = add_masks(b, rng, verts, mask_type)
        b.add_shape(0, verts, lw)
        metas[0].update(extra)
    else:
        combo = (rng.choice(["nested", "adjacent", "intersecting"])
                 if mode == "random" else mode)
        lw = rng.uniform(1.5, 2.0)
        rotated = []
        for v in verts_list:
            if rng.random() < 0.4:
                v = rotate_poly(v, rng.uniform(-180.0, 180.0))
            rotated.append(v)
        if combo == "nested":
            placed = combine_nested(rotated, same_center=nested_same_center)
        elif combo == "adjacent":
            placed = combine_adjacent(rng, rotated,
                                      spacing=adjacent_spacing)
        else:
            placed = combine_intersecting(rng, rotated)
        for i, v in enumerate(placed):
            b.add_shape(i, v, lw)
        for m in metas:
            m["combo_mode"] = combo
            if combo == "nested":
                m["same_center"] = bool(nested_same_center)
            elif combo == "adjacent":
                m["spacing"] = float(adjacent_spacing)

    # recenter everything to the canvas center
    # (generator.py:261-378 center_combined_shapes)
    sc = b.scene
    pts = [sc["shape_verts"][i] for i in range(MAX_SHAPES) if sc["shape_valid"][i]]
    pts += [sc["mask_verts"][i] for i in range(MAX_MASKS) if sc["mask_valid"][i]]
    line_pts = sc["line_pts"][sc["line_valid"]].reshape(-1, 2)
    allp = np.concatenate(pts + ([line_pts] if len(line_pts) else []), 0)
    lo, hi = allp.min(0), allp.max(0)
    delta = -((lo + hi) / 2.0)
    for i in range(MAX_SHAPES):
        if sc["shape_valid"][i]:
            sc["shape_verts"][i] += delta
    for i in range(MAX_MASKS):
        if sc["mask_valid"][i]:
            sc["mask_verts"][i] += delta
    sc["line_pts"][sc["line_valid"]] += np.tile(delta, 2).astype(np.float32)

    # per-shape final center/bbox for the params record
    for i, m in enumerate(metas):
        v = sc["shape_verts"][i]
        c = poly_centroid(v)
        m["center"] = (float(c[0]), float(c[1]))
        m["bbox"] = (float(v[:, 0].min()), float(v[:, 1].min()),
                     float(v[:, 0].max()), float(v[:, 1].max()))
        m["edge_color"] = "black"
        m["line_width"] = float(sc["shape_lw"][i])
        m["line_style"] = "-"
        m["fill_color"] = "none"
        m["alpha"] = 0.9
        shapes_meta.append(m)

    record = {"mode": mode, "shape_count": shape_count,
              "global_scale": global_scale, "shapes": shapes_meta}
    return sc, record


def build_scene_batch(seeds, modes, global_scale: float = 1.3, **scene_kw):
    scenes, records = [], []
    for s, m in zip(seeds, modes):
        sc, rec = build_scene(int(s), m, global_scale, **scene_kw)
        scenes.append(sc)
        records.append(rec)
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    return batch, records
