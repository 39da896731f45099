# test_cli.py — CLI front-ends (small canvas for CPU speed).
import json
import os

import numpy as np
import pytest


def test_rpm_cli_main(tmp_path):
    from reasoning_image_generation_tpu import cli
    out = str(tmp_path / "out")
    cli.main(["--out_dir", out, "--n", "3", "--seed", "5",
              "--batch_size", "3"])
    idx = json.load(open(os.path.join(out, "index.json")))
    assert len(idx) == 3
    for m in idx:
        assert os.path.exists(m["grid_path"])
        assert os.path.exists(os.path.join(m["sample_dir"], "meta.json"))


def test_mg_cli_generate_all(tmp_path, monkeypatch):
    from reasoning_image_generation_tpu.models.multigraph.cli import generate_all
    monkeypatch.chdir(tmp_path)
    generate_all(num_samples=2, out_dir="output", dpi=25,
                 mode_choices=("adjacent",), batch_size=2)
    imgs = os.listdir("output/images")
    params = os.listdir("output/params")
    assert len(imgs) == 2 and len(params) == 2
    rec = json.load(open(os.path.join("output/params", params[0])))
    assert rec["mode"] == "adjacent"
    assert "qc" in rec and "shapes" in rec


def test_generate_sample_reference_api(tmp_path):
    from reasoning_image_generation_tpu.utils.config import GenConfig
    from reasoning_image_generation_tpu.models.rpm.generator import RPMGeneratorTPU
    cfg = GenConfig(out_dir=str(tmp_path), seed=9, batch_size=2,
                    canvas_size=(128, 128))
    gen = RPMGeneratorTPU(cfg)
    meta = gen.generate_sample(0)
    assert meta is not None and meta["id"] == 0
    assert os.path.exists(meta["grid_path"])
    # pinned category path
    meta2 = gen.generate_sample(1, category_path=["图形相似", "位置变换", "平移"])
    gen.close()
    assert meta2["rule"] == "平移"
    assert meta2["category_path"] == ["图形相似", "位置变换", "平移"]
    assert os.path.exists(os.path.join(meta2["sample_dir"], "meta.json"))


def test_clis_run_without_cv2_matplotlib_pil(tmp_path, monkeypatch):
    """Both CLIs' main paths import nothing beyond the core packages: with
    cv2, matplotlib and PIL unimportable they still write their outputs."""
    import sys
    for name in ("cv2", "matplotlib", "matplotlib.pyplot", "PIL",
                 "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    from reasoning_image_generation_tpu import cli
    from reasoning_image_generation_tpu.models.multigraph import cli as mg_cli
    out = str(tmp_path / "rpm")
    cli.main(["--out_dir", out, "--n", "3", "--seed", "5",
              "--batch_size", "3"])
    idx = json.load(open(os.path.join(out, "index.json")))
    assert len(idx) == 3 and all(os.path.exists(m["grid_path"]) for m in idx)
    mg_out = str(tmp_path / "mg")
    mg_cli.main(["--n", "2", "--out_dir", mg_out, "--dpi", "25",
                 "--batch_size", "2", "--modes", "random,nested"])
    assert len(os.listdir(os.path.join(mg_out, "images"))) == 2
    assert len(os.listdir(os.path.join(mg_out, "params"))) == 2
