# test_raster_pallas.py — RPM render kernel (Pallas, Triton route) parity.
"""The kernel against ops/raster.render_frame: in Pallas interpret mode on
the CPU, compiled on a GPU (``gpu`` marker), lowered for CUDA from here,
plus the wrapper's inputs, padding and the renderer dispatch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reasoning_image_generation_tpu.utils.state import dicts_to_state
from reasoning_image_generation_tpu.utils.config import SHAPE_KINDS
from reasoning_image_generation_tpu.ops import geometry as G
from reasoning_image_generation_tpu.ops import raster_pallas as rp
from reasoning_image_generation_tpu.ops.raster import render_frame
from reasoning_image_generation_tpu.ops.raster_pallas import (
    prepare_render_data, render_batch_pallas)


def _elem(kind, size=140, center=(256, 256), angle=45.0, color=(40, 80, 200)):
    return {"kind": kind, "size": size, "fill": True, "stroke_width": 2,
            "center": center, "angle": angle, "bbox": (0, 0, size, size),
            "flip": {"h": False, "v": False}, "color": color}


def test_prepare_render_data_fields():
    st = dicts_to_state([_elem("crescent"), _elem("plus", 90, (100, 100))], 8)
    meta, edges = prepare_render_data(st, 512, 512, use_grid=False)
    meta = np.asarray(meta)
    assert meta.shape == (8, rp.NMETA)
    assert edges.shape == (8, G.NPART, rp.NCONST, G.MAX_VERTS)
    # crescent flags; analytic kinds have no polygon edges
    assert meta[0, rp.M_CRESCENT] == 1.0 and meta[0, rp.M_CIRCLE] == 0.0
    assert meta[0, rp.M_NV0] == 0
    # plus has a 4-edge second part
    assert meta[1, rp.M_NV0] == 4 and meta[1, rp.M_NV1] == 4
    # bounds sane and inflated
    assert meta[0, rp.M_BX0] < 256 - 69 and meta[0, rp.M_BX1] > 256 + 69
    # invalid slots masked
    assert (meta[2:, rp.M_VALID] == 0).all()


def test_prepare_render_data_grid_snap():
    st = dicts_to_state([_elem("square", center=(100, 400))], 8)
    meta, _ = prepare_render_data(st, 512, 512, use_grid=True)
    meta = np.asarray(meta)
    cell = 512 / 3
    assert abs(meta[0, rp.M_CX] - int((0 + 0.5) * cell)) < 1.0
    assert abs(meta[0, rp.M_CY] - int((2 + 0.5) * cell)) < 1.0
    assert meta[0, rp.M_GRID] == 1.0


def test_kernel_parity_interpret_cpu():
    """Interpret-mode CPU pin for the RPM kernel: one small canvas,
    polygon + circle + a far-off-canvas element that the wrap gate must
    suppress.  maxdiff 0 vs ops/raster.render_frame."""
    els = [_elem("hexagon", 40, (60, 32), angle=30.0),
           _elem("circle", 30, (140, 30), color=(200, 30, 30)),
           _elem("plus", 40, (200, 32 + 2 * 64), angle=0.0),   # 2 canvases off
           _elem("star", 36, (250, 40), color=(30, 160, 60))]  # wraps over x=256
    st = dicts_to_state(els, 8)
    batch = jax.tree.map(lambda a: a[None], st)
    for ug in (False, True):
        got = np.asarray(render_batch_pallas(
            batch, 256, 64, np.array([ug]), interpret=True))[0]
        ref = np.asarray(render_frame(st, 256, 64, use_grid=ug))
        assert (got == ref).all(), f"use_grid={ug}"


def test_kernel_parity_interpret_multitile_crop():
    """Interpret-mode pin for the tile-grid + pad/crop logic: 600x200 is a
    tile multiple in neither dimension, with content crossing tile
    boundaries and wrapping over both true edges."""
    els = [_elem("hexagon", 90, (580, 100), angle=30.0),  # wraps over x=600
           _elem("heart", 70, (40, 190), color=(30, 160, 60)),  # wraps y=200
           _elem("star", 80, (510, 60), color=(200, 30, 30)),   # tile seam
           _elem("circle", 60, (300, 64))]                      # row seam
    st = dicts_to_state(els, 8)
    batch = jax.tree.map(lambda a: a[None], st)
    got = np.asarray(render_batch_pallas(
        batch, 600, 200, np.array([False]), interpret=True))[0]
    ref = np.asarray(render_frame(st, 600, 200, use_grid=False))
    assert got.shape == (200, 600, 3)
    assert (got == ref).all()


@pytest.mark.parametrize("E", [3, 5])
def test_kernel_pads_element_slots_to_power_of_two(E):
    """Element counts that are not a power of two pad with invalid slots."""
    els = [_elem("triangle", 30, (20, 20)), _elem("crescent", 24, (44, 30)),
           _elem("rounded_square", 20, (50, 10))][:E]
    st = dicts_to_state(els, E)
    batch = jax.tree.map(lambda a: a[None], st)
    got = np.asarray(render_batch_pallas(
        batch, 72, 40, np.array([True]), interpret=True))[0]
    ref = np.asarray(render_frame(st, 72, 40, use_grid=True))
    assert got.shape == (40, 72, 3)
    assert (got == ref).all()


def test_kernel_lowers_for_cuda():
    """The kernel lowers to a Triton call for CUDA from a CPU-only host:
    every primitive it uses has a Triton lowering and every block is a
    power of two.  (Compiling it needs the card.)"""
    st = dicts_to_state([_elem("plus")], 8)
    avals = (jax.tree.map(lambda a: jax.ShapeDtypeStruct((4,) + a.shape,
                                                         a.dtype), st),
             jax.ShapeDtypeStruct((4,), jnp.bool_))
    exp = jax.export.export(
        jax.jit(lambda s, g: render_batch_pallas(s, 512, 512, g)),
        platforms=("cuda",),
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*avals)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()
    assert exp.out_avals[0].shape == (4, 512, 512, 3)


def _all_kinds(W, H):
    states = []
    for k, kind in enumerate(SHAPE_KINDS):
        els = [_elem(kind, angle=15.0 * k),
               _elem("circle", 80, (W - 20, 100), color=(200, 30, 30)),
               _elem(SHAPE_KINDS[(k + 3) % 11], 70, (40, H - 10))]
        states.append(dicts_to_state(els, 8))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@pytest.mark.gpu
def test_kernel_parity_all_kinds_on_gpu(gpu):
    batch = _all_kinds(512, 512)
    ug = np.arange(len(SHAPE_KINDS)) % 2 == 1
    got = np.asarray(render_batch_pallas(batch, 512, 512, ug))
    for i, kind in enumerate(SHAPE_KINDS):
        ref = np.asarray(render_frame(
            jax.tree.map(lambda a: a[i], batch), 512, 512, use_grid=ug[i]))
        assert np.abs(got[i].astype(int) - ref).max() <= 1, kind


@pytest.mark.gpu
def test_kernel_parity_untiled_size_on_gpu(gpu):
    """Canvas sizes not divisible by the tile shape pad+crop (600x200),
    including wrap-around content near the true edge."""
    els = [_elem("hexagon", 90, (580, 100), angle=30.0),   # wraps over x=600
           _elem("heart", 70, (40, 180), color=(30, 160, 60))]
    st = dicts_to_state(els, 8)
    batch = jax.tree.map(lambda a: a[None], st)
    for ug in (False, True):
        got = np.asarray(render_batch_pallas(
            batch, 600, 200, np.array([ug])))[0]
        ref = np.asarray(render_frame(st, 600, 200, use_grid=ug))
        assert got.shape == (200, 600, 3)
        assert np.abs(got.astype(int) - ref).max() <= 1, f"use_grid={ug}"
