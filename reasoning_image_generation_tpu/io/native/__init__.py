# native/__init__.py — builds + loads the C fastpng encoder on demand.
"""ctypes binding for fastpng.c.

Built lazily with the system C compiler (cc -O3 -shared -fPIC ... -lz) into
``build/`` beside the source (gitignored), under a name keyed on a hash of
fastpng.c, so a checkout always builds its own library from the committed
source and an edited source never loads a stale one.  ctypes releases the
GIL for the whole call, so the export thread pool encodes PNGs in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastpng.c")
_BUILD = os.path.join(_HERE, "build")
_lock = threading.Lock()
_lib = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD, f"libfastpng-{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run([cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp, "-lz"],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.fastpng_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.fastpng_write.restype = ctypes.c_int
            lib.fastpng_write_rle.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.fastpng_write_rle.restype = ctypes.c_int
            lib.fastpng_write_rle_overlay.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.fastpng_write_rle_overlay.restype = ctypes.c_int
            _lib = lib
    return _lib


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    assert img.ndim == 3 and img.shape[2] == 3, img.shape
    h, w = img.shape[:2]
    rc = _load().fastpng_write(path.encode(), img.ctypes.data, h, w, level)
    if rc != 0:
        raise IOError(f"fastpng_write failed with code {rc} for {path}")


def write_png_rle(path: str, lengths: np.ndarray, colors: np.ndarray,
                  count: int, h: int, w: int, level: int = 1,
                  overlay=None) -> None:
    """Encode a PNG straight from the rle2 run stream
    (ops/rle.py::pack_frame_rle2) — no pixel tensor ever materializes on
    the host.  lengths: u16 [>=count]; colors: u8 [>=count, 3].
    `overlay=(rgb_u8 [h,w,3], a8 [h,w])` alpha-blends a static overlay
    after decode with the exact device integer blend
    (ops/compose.py::apply_overlay_u8)."""
    lengths = np.ascontiguousarray(lengths[:count], np.uint16)
    colors = np.ascontiguousarray(colors[:count], np.uint8)
    if overlay is not None:
        ov_rgb = np.ascontiguousarray(overlay[0], np.uint8)
        ov_a = np.ascontiguousarray(overlay[1], np.uint8)
        assert ov_rgb.shape == (h, w, 3) and ov_a.shape == (h, w)
        rc = _load().fastpng_write_rle_overlay(
            path.encode(), lengths.ctypes.data, colors.ctypes.data,
            int(count), h, w, ov_rgb.ctypes.data, ov_a.ctypes.data, level)
    else:
        rc = _load().fastpng_write_rle(
            path.encode(), lengths.ctypes.data, colors.ctypes.data,
            int(count), h, w, level)
    if rc != 0:
        raise IOError(f"fastpng_write_rle failed with code {rc} for {path}")


# build at import so io.png backend probing succeeds or falls through
_load()
