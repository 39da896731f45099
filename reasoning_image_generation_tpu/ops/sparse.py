# sparse.py — lossless block-sparse codec for the device->host boundary.
"""Rendered canvases are mostly background, so raw u8 transfers waste most
of the link.  This codec packs each frame ON DEVICE into:

- a 1-bit/BLOCK background mask over 8x8 pixel blocks (packbits, MSB-first
  like np.unpackbits),
- a fixed-budget buffer of the non-background blocks in raster order
  (argsort + gather — block-level sort touches only H*W/64 keys, where a
  pixel-level scatter compaction touches every pixel),
- a per-frame nonempty-block count.

The host reconstructs exactly (bit-identical).  Frames whose nonempty-block
population exceeds the budget raise an overflow flag; callers fall back to
fetching the raw frame (kept on device).

This trades device time for fewer bytes over the device->host link; it
pays only where that link, not the device, limits the run."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BS = 8  # block side

# MSB-first bit weights, matching np.unpackbits(bitorder='big')
# numpy, not jnp: a module-level device array would initialize the
# backend at import time
_BIT_W = np.asarray([128, 64, 32, 16, 8, 4, 2, 1], np.uint8)


def n_blocks(H: int, W: int) -> int:
    assert H % BS == 0 and W % BS == 0, (H, W)
    return (H // BS) * (W // BS)


def _to_blocks(img: jnp.ndarray):
    H, W = img.shape[:2]
    nb0, nb1 = H // BS, W // BS
    b = img.reshape(nb0, BS, nb1, BS, 3)
    b = jnp.transpose(b, (0, 2, 1, 3, 4))
    return b.reshape(nb0 * nb1, BS * BS * 3)


def pack_frame(img: jnp.ndarray, budget: int, bg: int = 255):
    """u8 [H, W, 3] -> (mask u8 [NB/8], vals u8 [budget, 192], count i32).

    `budget` counts 8x8 blocks."""
    blocks = _to_blocks(img)
    nonbg = jnp.any(blocks != jnp.uint8(bg), axis=-1)
    count = jnp.sum(nonbg.astype(jnp.int32))

    bits = nonbg.reshape(-1, 8).astype(jnp.uint8)
    mask = jnp.sum(bits * _BIT_W, axis=-1).astype(jnp.uint8)

    order = jnp.argsort(~nonbg, stable=True)  # nonempty blocks first
    vals = blocks[order[:budget]]
    return mask, vals, count


@partial(jax.jit, static_argnames=("budget", "bg"))
def pack_batch(imgs: jnp.ndarray, budget: int, bg: int = 255):
    """u8 [..., H, W, 3] with any leading dims."""
    lead = imgs.shape[:-3]
    flat = imgs.reshape((-1,) + imgs.shape[-3:])
    mask, vals, count = jax.vmap(lambda x: pack_frame(x, budget, bg))(flat)
    return (mask.reshape(lead + mask.shape[1:]),
            vals.reshape(lead + vals.shape[1:]),
            count.reshape(lead))


def unpack_frame(mask: np.ndarray, vals: np.ndarray, count: int,
                 shape, bg: int = 255) -> np.ndarray:
    """Host-side exact reconstruction.  Raises OverflowError when the frame
    exceeded the block budget (caller falls back to the raw device frame)."""
    H, W = shape[:2]
    nb0, nb1 = H // BS, W // BS
    nb = nb0 * nb1
    if count > vals.shape[0]:
        raise OverflowError(f"sparse frame overflow: {count} > {vals.shape[0]}")
    bits = np.unpackbits(np.asarray(mask))[:nb].astype(bool)
    blocks = np.full((nb, BS * BS * 3), bg, np.uint8)
    blocks[bits] = np.asarray(vals)[:count]
    img = blocks.reshape(nb0, nb1, BS, BS, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(H, W, 3))
