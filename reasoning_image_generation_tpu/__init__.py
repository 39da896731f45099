"""reasoning_image_generation_tpu — a JAX abstract-visual-reasoning data synthesizer.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
MrGu11/reasoning_image_generation (reference layout: ``src/`` sequence-puzzle
pipeline + ``multigraph_generation/`` single-image pipeline), re-designed as a
single-program batched renderer:

- Element state is a struct-of-arrays tensor (``utils.state.ElementState``),
  not per-shape Python objects.
- Rendering is a batched signed-distance-field rasterizer (``ops.raster``)
  with a Pallas GPU kernel (``ops.raster_pallas``), replacing the
  reference's per-shape OpenCV draw calls (reference src/shapes.py:209).
- Sequence rules are pure ``state -> state`` functions driven by
  ``lax.switch`` + ``lax.scan`` (``models.rpm.rules``), replacing the
  reference's dict-mutating handlers (reference src/rules.py:1642).
- Parallelism is a JAX device mesh over the sample axis (``parallel.mesh``),
  replacing the reference's ProcessPoolExecutor fan-out
  (reference src/cli.py:85).
- All randomness flows through ``jax.random`` keys folded per sample id,
  replacing the reference's global ``random.seed(seed+index)`` discipline
  (reference src/cli.py:20).
"""

__version__ = "0.1.0"
