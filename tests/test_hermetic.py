# Hermetic entry points: importing the package never starts a backend, the
# bench parent stays off JAX, and the renderer dispatch is explicit.
import json
import os
import subprocess
import sys

import pytest

from .conftest import REPO_ROOT


def test_backend_probe_cpu():
    from reasoning_image_generation_tpu.utils.backend import (
        detect_platform, devices_or_raise)
    devs = devices_or_raise()
    assert len(devs) >= 1
    assert detect_platform() == "cpu"
    # a second call sees the same devices
    assert devices_or_raise() == devs


@pytest.mark.parametrize("platform,want", [("cpu", "jnp"), ("gpu", "pallas"),
                                           ("rocm", None), ("metal", None)])
def test_auto_renderer_dispatch(platform, want):
    from reasoning_image_generation_tpu.utils.backend import auto_renderer
    if want is None:
        with pytest.raises(RuntimeError, match="no renderer"):
            auto_renderer(platform)
    else:
        assert auto_renderer(platform) == want


def test_auto_renderer_follows_default_device():
    from reasoning_image_generation_tpu.utils.backend import auto_renderer
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.pipeline import (
        LeafPipeline)
    assert auto_renderer() == "jnp"
    with pytest.raises(ValueError, match="unknown renderer"):
        LeafPipeline("平移", GenConfig(canvas_size=(64, 64),
                                       renderer="mosaic"))


def test_graft_parent_never_inits_backend():
    """dryrun_multichip's parent path must never initialize a jax backend
    (it would claim the accelerator); it must re-exec into a cpu child.
    The check is on backend state, not module import."""
    code = (
        "import __graft_entry__ as g\n"
        "assert g._CHILD_ENV == 'RIG_DRYRUN_CHILD'\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, 'backend initialized in parent'\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # simulate the driver's bare env
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO_ROOT), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout


def test_package_import_never_inits_backend():
    """Importing ANY package module must not initialize a jax backend:
    module-level jnp constants device_put at import time, which would
    start the backend (and claim the device) on every import of the
    package, e.g. through a module-level DCT matrix in ops/phash.py."""
    code = (
        "import pkgutil, importlib\n"
        "import reasoning_image_generation_tpu as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    if 'native' in m:\n"
        "        continue\n"
        "    importlib.import_module(m)\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, (\n"
        "    'backend initialized at import: %r' % (xla_bridge._backends,))\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the bare env every CLI user has
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO_ROOT), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ok" in proc.stdout


def test_bench_parent_has_no_jax_import():
    """bench.py's parent half (preflight + watchdog) must never import
    jax; only the --child subprocess may."""
    src = (REPO_ROOT / "bench.py").read_text()
    head = src.split("# child side:")[0]
    # line-anchored: the subprocess probe embeds "import jax" in a string
    # literal, which is exactly the point (it runs in a killable child)
    for line in head.splitlines():
        assert not line.strip().startswith("import jax"), line


def test_bench_error_json_shape():
    sys.path.insert(0, str(REPO_ROOT))
    import bench
    out = bench._error_json("boom", {"host_link_mbps": 3.0, "value": 12.5,
                                     "vs_baseline": 61.9, "error": "old"})
    assert out["metric"] == "rpm_samples_per_sec_device"
    assert out["error"] == "boom"
    assert out["host_link_mbps"] == 3.0
    assert out["value"] == 12.5 and out["vs_baseline"] == 61.9
    json.dumps(out)  # serializable


def test_bench_checkpointer_roundtrip(tmp_path):
    sys.path.insert(0, str(REPO_ROOT))
    import bench
    p = str(tmp_path / "res.json")
    ck = bench._Checkpointer(p)
    ck.update(value=1.5, vs_baseline=7.4)
    ck.update(host_link_mbps=9.9)
    with open(p) as f:
        got = json.load(f)
    assert got["value"] == 1.5 and got["host_link_mbps"] == 9.9
    assert got["metric"] == "rpm_samples_per_sec_device"
