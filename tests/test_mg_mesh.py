# test_mg_mesh.py — multigraph rendering sharded over the device mesh.
"""The mg generator shards its one-program batch render over the 1-D data
mesh exactly like the RPM generator (scenes are embarrassingly parallel, no
collectives).  On the 8-device CPU mesh, sharded output must be
bit-identical to the single-device render."""
import numpy as np

TEST_DPI = 25


def test_mg_generator_builds_mesh_and_matches_unsharded(tmp_path):
    import jax
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        build_scene_batch)
    from reasoning_image_generation_tpu.models.multigraph.renderer import (
        render_scene_batch)

    def decode(rendered):
        frames, over, (H, W), _extra = rendered
        out = []
        for i in range(frames.cnt.size):
            out.append(over[i] if i in over else frames.unpack(i, (H, W)))
        return np.stack(out)

    gen = GeometryGeneratorTPU()
    assert gen.mesh is not None and gen.mesh.size == len(jax.local_devices())

    seeds = list(range(8))
    modes = ["adjacent"] * 8
    batch, _ = build_scene_batch(seeds, modes, gen.global_scale)
    sharded = decode(gen._render_finish(gen._render_dispatch(gen._render_imgs(batch, TEST_DPI))))
    plain = np.asarray(render_scene_batch(batch, dpi=TEST_DPI))
    np.testing.assert_array_equal(sharded, plain)

    # ragged batch (not divisible by mesh size) falls back to unsharded
    batch3, _ = build_scene_batch(seeds[:3], modes[:3], gen.global_scale)
    out3 = decode(gen._render_finish(gen._render_dispatch(gen._render_imgs(batch3, TEST_DPI))))
    assert out3.shape[0] == 3
    np.testing.assert_array_equal(out3, plain[:3])
    gen.close()
