# AOT executable cache (utils/aot.py): cold processes skip trace+lower+
# compile by loading serialized executables.  These tests pin (a) the
# round-trip produces identical results, (b) a cache hit never traces or
# compiles, (c) the LeafPipeline/mg integration stays bit-identical to
# plain jit dispatch, and (d) stale entries (changed code fingerprint)
# can never load.
#
# The on-disk cache only engages for single-device processes or programs
# compiled across the FULL device set (load_or_compile docstring): on this
# 8-device CPU test mesh that means mesh-sharded programs, which is also
# the production configuration (LeafPipeline always gets the data mesh
# when >1 chip is visible).
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reasoning_image_generation_tpu.utils import aot


@pytest.fixture()
def aot_sandbox(tmp_path, monkeypatch):
    """Point the AOT dir at a tmp sandbox so tests never pollute (or get
    polluted by) the real cache."""
    monkeypatch.setattr(aot, "aot_dir", lambda: str(tmp_path / "aot"))
    # the cache is default-off on the CPU backend (CPU payloads are
    # machine-specific and can fail at dispatch when loaded by a LATER
    # process on another host); same-process sandbox round-trips are safe, so
    # the tests force it on to pin the machinery
    monkeypatch.setenv("RIG_AOT_CPU", "1")
    # Isolate the persistent XLA compilation cache as well: if an earlier
    # test constructed a generator (which enables the real cache dir),
    # lower().compile() here can return an entry compiled on another host
    # in a previous session whose machine features don't match, and
    # serializing that into the sandbox fails at load (measured:
    # "+prefer-no-gather is not supported on the host machine").
    from jax._src import compilation_cache as cc
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "xla"))
    # the cache object binds its directory at first use, so if an earlier
    # test already compiled through the real dir the update alone is a
    # no-op — reset so the sandbox dir actually takes effect
    cc.reset_cache()
    # ...and drop in-memory executables: an earlier test may have loaded a
    # persistent-cache entry from another host for the same program, and the
    # jit cache would hand it back here regardless of the cache-dir switch
    jax.clear_caches()
    yield tmp_path / "aot"
    jax.config.update("jax_compilation_cache_dir", prev)
    cc.reset_cache()


def _mesh_jit(f):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("data",))
    sh = NamedSharding(mesh, P("data"))
    return jax.jit(f, in_shardings=sh, out_shardings=sh)


def test_single_device_program_skips_cache(aot_sandbox):
    """With >1 visible device, a single-device program must NOT be cached
    (deserialize_and_load spans every device — measured shard mismatch)."""
    if jax.device_count() == 1:
        pytest.skip("needs multi-device backend")
    jf = jax.jit(lambda x: x + 1)
    avals = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    assert aot.load_or_compile("t-1dev", jf, avals) is None
    assert not list(aot_sandbox.glob("*.jaxexec"))


def test_roundtrip_identical(aot_sandbox):
    jf = _mesh_jit(lambda x: x * 2.0 + 1.0)
    x = jnp.arange(16.0)
    avals = (jax.ShapeDtypeStruct(x.shape, x.dtype),)
    c1 = aot.load_or_compile("t-rt", jf, avals, spans_all_devices=True)
    assert c1 is not None
    assert len(list(aot_sandbox.glob("*.jaxexec"))) == 1
    # second call loads from disk (fresh-process stand-in)
    c2 = aot.load_or_compile("t-rt", jf, avals, spans_all_devices=True)
    np.testing.assert_array_equal(np.asarray(c1(x)), np.asarray(jf(x)))
    np.testing.assert_array_equal(np.asarray(c2(x)), np.asarray(jf(x)))
    # numpy inputs are committed automatically, like jit dispatch
    np.testing.assert_array_equal(
        np.asarray(c2(np.arange(16, dtype=np.float32))),
        np.asarray(jf(x)))


def test_cache_hit_never_compiles(aot_sandbox):
    jf = _mesh_jit(lambda x: x * 2.0)
    avals = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    assert aot.load_or_compile(
        "t-hit", jf, avals, spans_all_devices=True) is not None

    class Poison:
        def lower(self, *a, **k):
            raise AssertionError("cache hit must not trace/lower")

    c = aot.load_or_compile("t-hit", Poison(), avals,
                            spans_all_devices=True)
    assert c is not None
    np.testing.assert_array_equal(
        np.asarray(c(jnp.arange(8.0))), np.arange(8.0) * 2)


def test_different_tag_or_aval_misses(aot_sandbox):
    jf = _mesh_jit(lambda x: x + 1)
    a8 = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    a16 = (jax.ShapeDtypeStruct((16,), jnp.float32),)
    aot.load_or_compile("t-a", jf, a8, spans_all_devices=True)
    # same tag, different aval -> separate entry
    aot.load_or_compile("t-a", jf, a16, spans_all_devices=True)
    # different tag, same aval -> separate entry
    aot.load_or_compile("t-b", jf, a8, spans_all_devices=True)
    assert len(list(aot_sandbox.glob("*.jaxexec"))) == 3


def test_corrupt_entry_recompiles(aot_sandbox):
    jf = _mesh_jit(lambda x: x - 3.0)
    avals = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    aot.load_or_compile("t-cor", jf, avals, spans_all_devices=True)
    (path,) = aot_sandbox.glob("*.jaxexec")
    path.write_bytes(b"garbage")
    c = aot.load_or_compile("t-cor", jf, avals, spans_all_devices=True)
    assert c is not None
    np.testing.assert_array_equal(
        np.asarray(c(jnp.zeros(8))), np.full(8, -3.0))


def test_package_fingerprint_guards_staleness(aot_sandbox, monkeypatch):
    """A changed package fingerprint (i.e. any source edit) must route to a
    different entry, so stale executables can never load."""
    jf = _mesh_jit(lambda x: x)
    avals = (jax.ShapeDtypeStruct((8,), jnp.float32),)
    aot.load_or_compile("t-fp", jf, avals, spans_all_devices=True)
    monkeypatch.setattr(aot, "_package_fingerprint", lambda: "DIFFERENT")
    aot.load_or_compile("t-fp", jf, avals, spans_all_devices=True)
    assert len(list(aot_sandbox.glob("*.jaxexec"))) == 2


def test_leaf_pipeline_aot_parity(aot_sandbox, tmp_path):
    """Mesh-sharded LeafPipeline with aot=True is bit-identical to
    aot=False, and a rebuilt pipeline takes the deserialize path."""
    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        LeafPipeline, sample_keys)
    from reasoning_image_generation_tpu.parallel.mesh import make_mesh
    from reasoning_image_generation_tpu.utils.config import GenConfig

    mesh = make_mesh(jax.device_count())
    B = jax.device_count()
    keys = sample_keys(7, np.arange(B))
    use_grid = np.arange(B) % 2 == 0

    cfg_off = GenConfig(out_dir=str(tmp_path), canvas_size=(96, 96),
                        batch_size=B, seed=7, aot=False)
    ref = LeafPipeline("平移", cfg_off, mesh=mesh)(keys, use_grid)

    cfg = GenConfig(out_dir=str(tmp_path), canvas_size=(96, 96),
                    batch_size=B, seed=7)
    pipe = LeafPipeline("平移", cfg, mesh=mesh)
    out = pipe(keys, use_grid)
    assert pipe._aot and next(iter(pipe._aot.values())) is not None
    np.testing.assert_array_equal(np.asarray(out["grid_img"]),
                                  np.asarray(ref["grid_img"]))

    # fresh pipeline object: must hit the on-disk entry (no new files)
    n_files = len(list(aot_sandbox.glob("*.jaxexec")))
    assert n_files >= 1
    out2 = LeafPipeline("平移", cfg, mesh=mesh)(keys, use_grid)
    assert len(list(aot_sandbox.glob("*.jaxexec"))) == n_files
    np.testing.assert_array_equal(np.asarray(out2["grid_img"]),
                                  np.asarray(ref["grid_img"]))


def test_mg_render_aot_parity(aot_sandbox):
    from reasoning_image_generation_tpu.models.multigraph.generator import (
        GeometryGeneratorTPU)
    from reasoning_image_generation_tpu.models.multigraph.scene import (
        build_scene_batch)

    n = max(jax.device_count(), 2)  # divisible by the mesh -> AOT engages
    gen_on = GeometryGeneratorTPU(io_workers=1, aot=True)
    gen_off = GeometryGeneratorTPU(io_workers=1, aot=False)
    try:
        modes = (["nested", "adjacent", "intersecting", "random"] * n)[:n]
        batch, _ = build_scene_batch(list(range(n)), modes, 1.3)
        dpi = 25
        st_on = gen_on._render_dispatch(gen_on._render_imgs(batch, dpi))
        st_off = gen_off._render_dispatch(gen_off._render_imgs(batch, dpi))
        np.testing.assert_array_equal(np.asarray(st_on["imgs"]),
                                      np.asarray(st_off["imgs"]))
        if gen_on.mesh is not None:
            assert any(
                not hasattr(v, "lower")  # a Compiled, not the jit fallback
                for v in gen_on._aot.values())
    finally:
        gen_on.close()
        gen_off.close()


def test_aot_tag_covers_layout_content():
    """show_labels/show_border are generator ctor args (not GenConfig
    fields) that alter the overlay constants baked into the traced
    program — the AOT tag must separate them or a --no_labels run loads
    a stale labeled executable."""
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.pipeline import LeafPipeline
    cfg = GenConfig(out_dir="/tmp/aot_tag_t", canvas_size=(64, 64),
                    batch_size=2)
    tags = {LeafPipeline("平移", cfg, show_labels=sl,
                         show_border=sb)._aot_tag(2)
            for sl, sb in ((True, True), (False, True), (True, False))}
    assert len(tags) == 3


def test_probe_builds_typed_key_inputs():
    """The load probe must build inputs for typed PRNG key avals (the
    pipelines' per-sample keys): np.zeros cannot, and every RPM leaf entry
    then failed to load and silently recompiled."""
    from reasoning_image_generation_tpu.models.rpm.pipeline import sample_keys
    keys = sample_keys(0, np.arange(4))
    jf = jax.jit(lambda k, g: jax.vmap(jax.random.uniform)(k) + g)
    avals = (jax.ShapeDtypeStruct(keys.shape, keys.dtype),
             jax.ShapeDtypeStruct((4,), jnp.float32))
    compiled = jf.lower(*avals).compile()
    aot._probe_execute(compiled, avals)  # raises on a bad input build
