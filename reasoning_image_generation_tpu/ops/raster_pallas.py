# raster_pallas.py — GPU rasterization kernel (Pallas, Triton route).
"""Tiled SDF rasterizer for ElementState frames.

The XLA path (ops/raster.py) evaluates every element at every pixel and
materialises [H, W, chunk] edge intermediates in device memory.  This
kernel renders one (TH, TW) tile per program and keeps the canvas, the
running distance and the crossing count in registers:

1. **(element, tile) culling** — a scalar bbox-vs-tile test in the
   wrap-around metric skips an element's whole distance field on tiles it
   cannot touch; elements cover a small fraction of the canvas.
2. **edge loop over the real vertex count** — 4 to 60 edges instead of the
   64 padded ones, with the per-edge constants (``raster._edge_consts``)
   computed outside the kernel, so no division runs per pixel.

Per tile, elements composite in painter's order exactly like
ops/raster.composite_element (hard fills, cv2-calibrated AA stroke bands,
analytic circle/crescent, two-part 'plus', wrap-around, grid snap/lines),
through the same helpers, so the two paths differ at most by the
contraction of a multiply and an add into one FMA.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..utils.state import ElementState
from . import geometry as G
from .raster import (_band_alpha, _dist, _edge_consts, _edge_eval,
                     _full_radius, _round_u8, _wrap, element_verts)

NMETA = 32
# per-edge constants (raster._edge_consts rows), padded to a power of two
NCONST = 8
# tile and warp count, chosen by measurement on an H100 (PERF.md)
TH = 16
TW = 64
NUM_WARPS = 4

(M_VALID, M_FILL, M_RFULL, M_R, M_G, M_B, M_CIRCLE, M_CRESCENT, M_CX, M_CY,
 M_ROUT, M_ICX, M_ICY, M_RIN, M_NV1, M_BX0, M_BX1, M_BY0, M_BY1, M_NV0,
 M_GRID) = range(21)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def prepare_render_data(state: ElementState, W: int, H: int, use_grid,
                        grid_size: int = 3):
    """Per-frame (unbatched) kernel inputs: meta [E, NMETA] and edge
    constants [E, NPART, NCONST, MAX_VERTS].

    Applies the same grid snap / angle truncation / radii as render_frame
    and composite_element (reference src/generator.py:96-122)."""
    use_grid = jnp.asarray(use_grid)
    cell_w = W / grid_size
    cell_h = H / grid_size
    col = jnp.clip(jnp.floor(state.cx / cell_w), 0, grid_size - 1)
    row = jnp.clip(jnp.floor(state.cy / cell_h), 0, grid_size - 1)
    cx = jnp.where(use_grid, jnp.trunc((col + 0.5) * cell_w), state.cx)
    cy = jnp.where(use_grid, jnp.trunc((row + 0.5) * cell_h), state.cy)
    angle = jnp.trunc(state.angle)

    verts, nv = jax.vmap(element_verts)(
        state.kind, state.size, angle,
        jnp.zeros_like(state.flip_h), jnp.zeros_like(state.flip_v), cx, cy)
    half = state.size * 0.5
    r_out = jnp.maximum(1.0, jnp.round(half))
    r_in = jnp.round(r_out * G.CRESCENT_INNER_R)
    off = jnp.round(r_out * G.CRESCENT_OFFSET)
    a = jnp.deg2rad(-angle)
    icx = cx + jnp.round(off * jnp.cos(a))
    icy = cy + jnp.round(off * jnp.sin(a))

    is_circle = state.kind == G.CIRCLE
    is_crescent = state.kind == G.CRESCENT
    analytic = is_circle | is_crescent
    stroke_w = jnp.maximum(1.0, jnp.round(state.stroke))

    vx = verts[..., 0].reshape(verts.shape[0], -1)
    vy = verts[..., 1].reshape(verts.shape[0], -1)
    margin = stroke_w + 2.0
    bx0 = jnp.where(analytic, cx - r_out, vx.min(-1)) - margin
    bx1 = jnp.where(analytic, cx + r_out, vx.max(-1)) + margin
    by0 = jnp.where(analytic, cy - r_out, vy.min(-1)) - margin
    by1 = jnp.where(analytic, cy + r_out, vy.max(-1)) + margin

    f32 = lambda x: x.astype(jnp.float32)
    cols = [
        f32(state.valid), f32(state.fill & state.valid),
        _full_radius(stroke_w),
        state.color[..., 0], state.color[..., 1], state.color[..., 2],
        f32(is_circle), f32(is_crescent),
        cx, cy, r_out, icx, icy, r_in,
        f32(nv[:, 1]), bx0, bx1, by0, by1,
        f32(jnp.where(analytic, 0, nv[:, 0])),
        jnp.broadcast_to(f32(use_grid), cx.shape),
    ]
    meta = jnp.stack(cols, axis=-1)
    meta = jnp.pad(meta, ((0, 0), (0, NMETA - len(cols))))
    edges = _edge_consts(verts)                      # [E, NPART, 7, V]
    edges = jnp.pad(edges, ((0, 0), (0, 0), (0, NCONST - edges.shape[2]),
                            (0, 0)))
    return meta, edges


def _make_kernel(E: int, W: int, H: int, grid_size: int):
    xs_lines = tuple(float(round(i * W / grid_size)) for i in range(1, grid_size))
    ys_lines = tuple(float(round(i * H / grid_size)) for i in range(1, grid_size))
    Wf, Hf = float(W), float(H)

    def over(acc, color, a):
        return tuple(c * (1.0 - a) + k * a for c, k in zip(acc, color))

    def kernel(meta_ref, edge_ref, r_ref, g_ref, b_ref):
        i = pl.program_id(1)
        j = pl.program_id(2)
        y0 = (i * TH).astype(jnp.float32)
        x0 = (j * TW).astype(jnp.float32)
        py = y0 + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 0).astype(jnp.float32)
        px = x0 + jax.lax.broadcasted_iota(jnp.int32, (TH, TW), 1).astype(jnp.float32)
        tcx = x0 + TW * 0.5
        tcy = y0 + TH * 0.5
        black = (0.0, 0.0, 0.0)

        def draw(e, acc):
            m = lambda c: meta_ref[e, c]
            cx, cy = m(M_CX), m(M_CY)
            pxw = _wrap(px, cx, Wf)
            pyw = _wrap(py, cy, Hf)
            # reference wrap parity: copies exist only at the 3x3 offsets
            # (src/shapes.py:369-375), see raster.composite_element
            valid_f = ((jnp.abs(px - pxw) <= Wf) &
                       (jnp.abs(py - pyw) <= Hf)).astype(jnp.float32)
            fill_f = m(M_FILL) * valid_f
            r_full = m(M_RFULL)
            color = (m(M_R), m(M_G), m(M_B))

            def poly(part, n):
                def edge(k, carry):
                    d2, cross = carry
                    c = [edge_ref[e, part, r, k] for r in range(7)]
                    d2k, ck = _edge_eval(pxw, pyw, *c)
                    return (jnp.minimum(d2, d2k),
                            cross + ck.astype(jnp.int32))

                d2, cross = jax.lax.fori_loop(
                    0, n, edge,
                    (jnp.full((TH, TW), jnp.inf, jnp.float32),
                     jnp.zeros((TH, TW), jnp.int32)))
                return jnp.sqrt(d2), (cross % 2) == 1

            # polygons loop over their edges; circle and crescent have
            # none (M_NV0 == 0) and take the analytic fields below
            d0, in0 = poly(0, m(M_NV0).astype(jnp.int32))
            is_circle = m(M_CIRCLE) > 0.0
            is_cres = m(M_CRESCENT) > 0.0
            d_out = _dist(pxw - cx, pyw - cy) - m(M_ROUT)
            d_in = _dist(pxw - m(M_ICX), pyw - m(M_ICY)) - m(M_RIN)
            fill0 = jnp.where(is_circle, d_out < 0.0,
                              jnp.where(is_cres, (d_out < 0.0) & (d_in >= 0.0),
                                        in0)).astype(jnp.float32)
            s0 = jnp.where(
                is_circle, _band_alpha(jnp.abs(d_out), r_full),
                jnp.where(is_cres,
                          jnp.maximum(_band_alpha(jnp.abs(d_out), r_full),
                                      _band_alpha(jnp.abs(d_in), r_full)),
                          _band_alpha(d0, r_full)))
            acc = over(acc, color, fill0 * fill_f)
            acc = over(acc, black, s0 * valid_f)

            def part1(acc):
                # only 'plus' has a second part: two rectangles drawn in
                # sequence (reference src/shapes.py:477-509)
                d1, in1 = poly(1, m(M_NV1).astype(jnp.int32))
                acc = over(acc, color, in1.astype(jnp.float32) * fill_f)
                return over(acc, black, _band_alpha(d1, r_full) * valid_f)

            return jax.lax.cond(m(M_NV1) > 0.0, part1, lambda a: a, acc)

        def element(e, acc):
            bx0, bx1 = meta_ref[e, M_BX0], meta_ref[e, M_BX1]
            by0, by1 = meta_ref[e, M_BY0], meta_ref[e, M_BY1]
            # tile-centre to bbox-centre distance in the wrap metric; one
            # pixel of slack keeps the test conservative under rounding
            dxw = jnp.abs(_wrap(tcx, (bx0 + bx1) * 0.5, Wf) - (bx0 + bx1) * 0.5)
            dyw = jnp.abs(_wrap(tcy, (by0 + by1) * 0.5, Hf) - (by0 + by1) * 0.5)
            hit = ((meta_ref[e, M_VALID] > 0.0)
                   & (dxw <= TW * 0.5 + (bx1 - bx0) * 0.5 + 1.0)
                   & (dyw <= TH * 0.5 + (by1 - by0) * 0.5 + 1.0))
            return jax.lax.cond(hit, functools.partial(draw, e),
                                lambda a: a, acc)

        white = jnp.full((TH, TW), 255.0, jnp.float32)
        acc = jax.lax.fori_loop(0, E, element, (white, white, white))

        # grid lines (1px black), reference src/generator.py:111-122
        on = jnp.zeros((TH, TW), jnp.bool_)
        for x in xs_lines:
            on = on | (px == x)
        for y in ys_lines:
            on = on | (py == y)
        la = (on & (meta_ref[0, M_GRID] > 0.0)).astype(jnp.float32)
        acc = over(acc, black, la)
        for ref, c in zip((r_ref, g_ref, b_ref), acc):
            ref[...] = _round_u8(c)

    return kernel


@functools.partial(jax.jit, static_argnames=("W", "H", "grid_size", "interpret"))
def render_batch_pallas(states: ElementState, W: int, H: int, use_grid,
                        grid_size: int = 3, interpret: bool = False):
    """Render a batch of frames -> u8 [N, H, W, 3].

    states: ElementState with leading batch dim N; use_grid: bool [N].

    Any W/H is supported: the tile grid covers ceil-padded dims while the
    kernel keeps the TRUE W/H for its wrap metric / grid lines / culling,
    so padded pixels just render wrapped duplicates and are cropped off.
    (Matches the reference's arbitrary canvas_size, src/config.py:27.)
    """
    N, E = states.kind.shape[:2]
    EP = _pow2(E)
    Hp = -(-H // TH) * TH
    Wp = -(-W // TW) * TW
    meta, edges = jax.vmap(
        lambda s, g: prepare_render_data(s, W, H, g, grid_size)
    )(states, jnp.asarray(use_grid))
    # padded element slots carry valid = 0 and are culled
    meta = jnp.pad(meta, ((0, 0), (0, EP - E), (0, 0)))
    edges = jnp.pad(edges, ((0, 0), (0, EP - E), (0, 0), (0, 0), (0, 0)))

    plane = jax.ShapeDtypeStruct((N, Hp, Wp), jnp.uint8)
    plane_spec = pl.BlockSpec((None, TH, TW), lambda n, i, j: (n, i, j))
    r, g, b = pl.pallas_call(
        _make_kernel(E, W, H, grid_size),
        grid=(N, Hp // TH, Wp // TW),
        in_specs=[
            pl.BlockSpec((None, EP, NMETA), lambda n, i, j: (n, 0, 0)),
            pl.BlockSpec((None, EP, G.NPART, NCONST, G.MAX_VERTS),
                         lambda n, i, j: (n, 0, 0, 0, 0)),
        ],
        out_specs=[plane_spec] * 3,
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="rpm_render",
    )(meta, edges)
    return jnp.stack([r, g, b], axis=-1)[:, :H, :W]
