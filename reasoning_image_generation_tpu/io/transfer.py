# transfer.py — device->host transfer helpers shared by both pipelines.
"""Every device->host transfer has a fixed cost beside its bytes, so
these helpers fuse a whole output tree into ONE u8 blob on device and
split it back on host, and reconstruct image tensors from the RLE / block-sparse
codecs with a single gathered fetch for budget-overflow frames."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def coalesce(leaves):
    """Fuse per-batch output arrays into ONE [B, bytes] u8 blob.

    Every leaf keeps its leading batch dim, so the blob stays
    data-sharded on a mesh.  Bools widen to u8; other dtypes bitcast to
    bytes."""
    parts = []
    for a in leaves:
        b = a.astype(jnp.uint8) if a.dtype == jnp.bool_ else a
        if b.dtype != jnp.uint8:
            b = jax.lax.bitcast_convert_type(b, jnp.uint8)
        parts.append(b.reshape(b.shape[0], -1))
    return jnp.concatenate(parts, axis=1)


def transfer_tier(max_seen, capacity: int):
    """Transfer tier (run count) for a packed buffer: 1.2x the largest
    run count observed so far plus slack, rounded up to a multiple of 512.
    None when no stats exist yet or no shrink is worthwhile.  Monotone in
    max_seen, so tiers only grow — at most a handful of distinct program
    shapes compile as statistics warm up."""
    if max_seen is None:
        return None
    t = -(-(int(max_seen * 1.2) + 64) // 512) * 512
    return t if t < capacity else None


@partial(jax.jit, static_argnames=("sizes",))
def coalesce_shrunk(leaves, sizes):
    """`coalesce` with per-leaf run-axis truncation fused in.

    The packed codecs (ops/rle.py, ops/sparse.py) emit STATIC per-frame
    buffers sized for the worst case; actual content is far below that on
    most batches.  `sizes` is a static tuple aligned with `leaves`: None
    to keep a leaf whole, or (axis, new_size) to slice that axis to
    new_size before coalescing — the host picks sizes adaptively from the
    true run counts of previous batches (which always travel in full) and
    the decode's existing overflow fallback absorbs the rare batch that
    exceeds the shrunken capacity.  Sizes are quantized to a few tiers so
    only a handful of program shapes ever compile."""
    parts = []
    for a, s in zip(leaves, sizes):
        if s is not None:
            axis, ns = s
            a = jax.lax.slice_in_dim(a, 0, ns, axis=axis % a.ndim)
        b = a.astype(jnp.uint8) if a.dtype == jnp.bool_ else a
        if b.dtype != jnp.uint8:
            b = jax.lax.bitcast_convert_type(b, jnp.uint8)
        parts.append(b.reshape(b.shape[0], -1))
    return jnp.concatenate(parts, axis=1)


def shrunk_specs(leaves, sizes):
    """Per-leaf (shape, dtype) as split_blob expects, after `sizes`
    truncation (mirrors coalesce_shrunk's slicing on host metadata)."""
    specs = []
    for a, s in zip(leaves, sizes):
        shape = list(a.shape)
        if s is not None:
            axis, ns = s
            shape[axis % len(shape)] = min(ns, shape[axis % len(shape)])
        specs.append((tuple(shape), np.dtype(a.dtype)))
    return specs


@jax.jit
def coalesce_flat(leaves):
    """`coalesce` without the per-sample row structure: ONE 1-D u8 blob.

    The rle3 codec's batch-compacted streams (ops/rle.py::compact_rle3)
    have no leading batch axis, so the [B, bytes] layout can't hold them;
    the flat blob concatenates every leaf's raw bytes instead.  Used on
    the single-transfer fetch path only (the compaction already gathered
    any mesh shards)."""
    parts = []
    for a in leaves:
        b = a.astype(jnp.uint8) if a.dtype == jnp.bool_ else a
        if b.dtype != jnp.uint8:
            b = jax.lax.bitcast_convert_type(b, jnp.uint8)
        parts.append(b.reshape(-1))
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("sizes",))
def coalesce_flat_shrunk(leaves, sizes):
    """`coalesce_flat` with per-leaf axis truncation fused in (same
    `sizes` contract as coalesce_shrunk)."""
    parts = []
    for a, s in zip(leaves, sizes):
        if s is not None:
            axis, ns = s
            a = jax.lax.slice_in_dim(a, 0, min(ns, a.shape[axis % a.ndim]),
                                     axis=axis % a.ndim)
        b = a.astype(jnp.uint8) if a.dtype == jnp.bool_ else a
        if b.dtype != jnp.uint8:
            b = jax.lax.bitcast_convert_type(b, jnp.uint8)
        parts.append(b.reshape(-1))
    return jnp.concatenate(parts)


def split_flat(blob_np: np.ndarray, treedef, specs):
    """Invert `coalesce_flat`: one host u8 [bytes] array -> the tree.
    Leaves come back as zero-copy views into the blob."""
    out, off = [], 0
    for shape, dtype in specs:
        store = np.dtype(np.uint8) if dtype == np.bool_ else np.dtype(dtype)
        nb = int(np.prod(shape, dtype=np.int64)) * store.itemsize
        arr = blob_np[off:off + nb].view(store).reshape(shape)
        if dtype == np.bool_:
            arr = arr.astype(bool)
        out.append(arr)
        off += nb
    return jax.tree.unflatten(treedef, out)


@jax.jit
def _gather_flat(flat_raw, idx):
    """Traced-index frame gather: ONE compiled program per raw-tensor
    shape x index-bucket size, reused across batches and runs.  An
    unjitted jnp.take with a data-dependent index shape compiles a fresh
    XLA program for EVERY distinct overflow count, so rare overflow
    fetches would stall on compiles inside timed windows."""
    return jnp.take(flat_raw, idx, axis=0)


def gather_frames(raw_dev, indices: np.ndarray) -> dict:
    """Fetch the listed flat frame indices of a device image tensor in ONE
    gathered transfer -> {flat_index: u8 [h, w, 3]}.  Indices pad to the
    next power of two (repeating the last index) so only O(log B) gather
    shapes ever compile per raw-tensor shape."""
    indices = np.asarray(indices).reshape(-1)
    if indices.size == 0:
        return {}
    flat_raw = raw_dev.reshape((-1,) + raw_dev.shape[-3:])
    bucket = 1 << (int(indices.size) - 1).bit_length()
    bucket = min(bucket, int(flat_raw.shape[0]))
    padded = np.full(max(bucket, indices.size), indices[-1], dtype=np.int32)
    padded[:indices.size] = indices
    sel = np.asarray(_gather_flat(flat_raw, jnp.asarray(padded)))
    return {int(i): sel[j] for j, i in enumerate(indices)}


def blob_specs(tree):
    """(leaves, treedef, per-leaf (shape, dtype)) for host reconstruction."""
    leaves, treedef = jax.tree.flatten(tree)
    specs = [(tuple(a.shape), np.dtype(a.dtype)) for a in leaves]
    return leaves, treedef, specs


def split_blob(blob_np: np.ndarray, treedef, specs):
    """Invert `coalesce`: one host u8 [B, bytes] array -> the output tree."""
    n = blob_np.shape[0]
    out, off = [], 0
    for shape, dtype in specs:
        store = np.dtype(np.uint8) if dtype == np.bool_ else dtype
        per = int(np.prod(shape[1:], dtype=np.int64)) * store.itemsize
        chunk = np.ascontiguousarray(blob_np[:, off:off + per])
        arr = chunk.view(store).reshape((n,) + shape[1:])
        if dtype == np.bool_:
            arr = arr.astype(bool)
        out.append(arr)
        off += per
    return jax.tree.unflatten(treedef, out)


class HostBufferRing:
    """Reusable host-side output buffers.

    On this microVM kernel, first-touch page faults on a fresh large
    allocation run at ~20 MB/s (a 61 MB np.empty costs ~3 s to fill the
    first time), and numpy buffers above glibc's 32 MB mmap-threshold cap
    are ALWAYS freshly mapped — decoding a full-export batch into fresh
    state/option tensors paid ~9 s/batch in page faults alone.  The ring
    hands out up to `slots` buffers per (shape, dtype) round-robin;
    `wrapped=True` tells the caller a previously-issued buffer is being
    reused, so any async consumer (the PNG export pool) must be drained
    first."""

    def __init__(self, slots: int = 3):
        self.slots = slots
        self._bufs: dict = {}
        self._idx: dict = {}

    def acquire(self, shape, dtype=np.uint8):
        key = (tuple(int(s) for s in shape), np.dtype(dtype).str)
        lst = self._bufs.setdefault(key, [])
        if len(lst) < self.slots:
            lst.append(np.empty(shape, dtype))
            return lst[-1], False
        i = self._idx.get(key, 0)
        self._idx[key] = (i + 1) % self.slots
        return lst[i], True


def overflow_pixels(packed, raw_dev, n_valid: int) -> dict:
    """Raw pixels for frames whose true run count exceeds the transferred
    capacity — all of them fetched in ONE gathered device->host transfer
    (gather_frames: bucketed traced-index take, no per-count compiles).
    `packed` is a host-side (lengths/starts, colors, counts) tuple; returns
    {flat_frame_index: u8 [h, w, 3]} over the first n_valid (batch-major)
    frames."""
    lengths, _colors, counts = packed
    cap = lengths.shape[-1]
    cnt = np.asarray(counts).reshape(-1)
    over = np.nonzero(cnt > cap)[0]
    over = over[over < n_valid]
    return gather_frames(raw_dev, over)


def unpack_images(packed, raw_dev, codec: str = "rle",
                  out: np.ndarray | None = None) -> np.ndarray:
    """Reconstruct a frame tensor from the transfer codec (ops/rle.py or
    ops/sparse.py); frames over budget fall back to the raw device frame,
    all overflowed frames gathered and fetched in ONE transfer.  Pass a
    HostBufferRing buffer as `out` to skip the (slow) fresh allocation."""
    if codec == "rle2":
        from ..ops.rle import unpack_frame_rle2 as unpack_frame
    elif codec == "rle":
        from ..ops.rle import unpack_frame_rle as unpack_frame
    else:
        from ..ops.sparse import unpack_frame
    mask, vals, count = (np.asarray(packed[0]), np.asarray(packed[1]),
                         np.asarray(packed[2]))
    shape = raw_dev.shape  # [..., H, W, 3]
    H, W = shape[-3], shape[-2]
    lead = shape[:-3]
    out = np.empty(shape, np.uint8) if out is None else out
    assert out.shape == tuple(shape) and out.dtype == np.uint8
    m2 = mask.reshape((-1,) + mask.shape[len(lead):])
    v2 = vals.reshape((-1,) + vals.shape[len(lead):])
    c2 = count.reshape(-1)
    o2 = out.reshape((-1,) + shape[-3:])
    capacity = v2.shape[1]
    over = np.nonzero(c2 > capacity)[0]
    if over.size:
        flat_raw = raw_dev.reshape((-1,) + shape[-3:])
        raw_sel = np.asarray(jnp.take(flat_raw, jnp.asarray(over), axis=0))
        for j, i in enumerate(over):
            o2[i] = raw_sel[j]
    for i in range(o2.shape[0]):
        if c2[i] <= capacity:
            o2[i] = unpack_frame(m2[i], v2[i], int(c2[i]), (H, W))
    return out
