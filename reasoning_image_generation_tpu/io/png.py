# png.py — PNG encoding with a native fast path.
"""PNG writers, fastest available first:

1. ``fastpng`` — our C extension (io/native/fastpng.c): PNG filter + zlib in
   C with the GIL released, so the threaded writer pool gets real overlap.
2. OpenCV ``imwrite`` (libpng) — what the reference uses
   (reference src/utils.py:17-21).
3. Pure zlib fallback (filter 0), always available.

All paths produce valid RGB8 PNGs; bytes are not guaranteed identical across
backends (PNG is lossless, pixel content is identical).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_BACKEND = None


def _try_fastpng():
    try:
        from . import native  # builds + loads libfastpng.so on demand
        return native
    except Exception:
        return None


def _try_cv2():
    try:
        import cv2
        return cv2
    except Exception:
        return None


def encode_png_zlib(img: np.ndarray, level: int = 3) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0 rows + one IDAT)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    raw = np.empty((H, 1 + W * 3), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(H, W * 3)
    comp = zlib.compress(raw.tobytes(), level)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", comp) + chunk(b"IEND", b""))


def write_png_rle3(path: str, frames, i: int, h: int, w: int,
                   overlay=None) -> None:
    """Write one frame of a compacted rle3 transfer (ops/rle.py::
    Rle3Frames) as PNG.  The palette/escape reconstruction to the rle2
    run stream happens HERE — in the export worker thread, off the batch
    critical path; the C encoder then consumes the stream without
    materializing pixels.  Raises OverflowError for truncated frames
    (callers pre-screen with overflow_indices and fetch those raw)."""
    ln, rgb = frames.frame(i)
    write_png_rle(path, ln, rgb, int(ln.shape[0]), h, w, overlay=overlay)


def write_png_rle(path: str, lengths: np.ndarray, colors: np.ndarray,
                  count: int, h: int, w: int, overlay=None) -> None:
    """Write a PNG from an rle2 run stream (u16 lengths + u8 RGB colors,
    ops/rle.py::pack_frame_rle2) without materializing pixels when the C
    encoder is available; decodes and falls through to write_png
    otherwise.  `overlay=(rgb_u8, a8)` blends a static overlay after
    decode (exact integer blend, ops/compose.py::apply_overlay_u8).
    Raises OverflowError for truncated streams so callers can fetch the
    raw frame, same contract as unpack_frame_rle2."""
    from ..ops.rle import unpack_frame_rle2
    if count > lengths.shape[0]:
        raise OverflowError(f"rle2 frame overflow: {count} > "
                            f"{lengths.shape[0]}")
    fp = _try_fastpng()
    if fp is not None:
        try:
            fp.write_png_rle(path, lengths, colors, int(count), h, w,
                             overlay=overlay)
            return
        except IOError:
            pass  # e.g. length-sum mismatch — decode path re-validates
    img = unpack_frame_rle2(lengths, colors, int(count), (h, w))
    if overlay is not None:
        from ..ops.compose import apply_overlay_u8
        img = apply_overlay_u8(img, np.asarray(overlay[0]),
                               np.asarray(overlay[1]))
    write_png(path, img)


def _backend():
    global _BACKEND
    if _BACKEND is None:
        fp = _try_fastpng()
        if fp is not None:
            _BACKEND = ("fastpng", fp)
        else:
            cv = _try_cv2()
            _BACKEND = ("cv2", cv) if cv is not None else ("zlib", None)
    return _BACKEND


def backend_name() -> str:
    """'fastpng' (the C encoder), 'cv2' or 'zlib': the encoder write_png
    uses in this process."""
    return _backend()[0]


def write_png(path: str, img: np.ndarray) -> None:
    """Write an RGB u8 image to path as PNG via the fastest backend."""
    name, mod = _backend()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:  # normalize grayscale BEFORE any channel flip
        img = np.repeat(img[..., None], 3, axis=2)
    if name == "fastpng":
        mod.write_png(path, img)
    elif name == "cv2":
        mod.imwrite(path, img[..., ::-1])  # cv2 wants BGR
    else:
        with open(path, "wb") as f:
            f.write(encode_png_zlib(img))
