# phash.py — on-device perceptual hashing + corpus dedup.
"""Batched 64-bit pHash and pairwise-Hamming dedup.

The reference claims corpus-level filtering of semantically duplicate
samples (reference README.md:8) but ships only the per-sample structural
frozenset dedup (reference src/generator.py:149-177).  This module provides
the corpus-level realization, on device:

- grayscale -> 32x32 antialiased resize -> 2D DCT-II as two 32x32 matmuls
  at full f32 precision -> sign-vs-median of the 8x8 low-frequency
  block = 64 bits;
- pairwise Hamming distance via XOR + population_count;
- greedy keep-first dedup as a fori_loop over the batch;
- a sharded variant all-gathers the compact hashes over the device mesh so
  images never cross devices (see parallel/mesh.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

HASH_SIDE = 32
LOW = 8


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2.0 * n))
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


# host-side constant: a module-level jnp.asarray would device_put at
# import time and start the backend on every import of this package
_DCT = _dct_matrix(HASH_SIDE)


def phash(img: jnp.ndarray) -> jnp.ndarray:
    """64-bit pHash of one u8 RGB image -> u8 [8] (row-packed bits)."""
    # full f32 precision throughout: TF32 products would move the DCT
    # coefficients and with them the hash bits (and dedup decisions)
    hp = jax.lax.Precision.HIGHEST
    gray = jnp.dot(img.astype(jnp.float32),
                   jnp.asarray([0.299, 0.587, 0.114], jnp.float32),
                   precision=hp)
    small = jax.image.resize(gray, (HASH_SIDE, HASH_SIDE), "linear",
                             antialias=True)
    dct = jnp.asarray(_DCT)
    freq = jnp.matmul(jnp.matmul(dct, small, precision=hp), dct.T,
                      precision=hp)
    block = freq[:LOW, :LOW].reshape(-1)
    med = jnp.median(block)
    bits = (block > med).astype(jnp.uint8).reshape(LOW, LOW)
    weights = (2 ** jnp.arange(LOW, dtype=jnp.uint32)).astype(jnp.uint8)
    return jnp.sum(bits * weights[None, :], axis=1).astype(jnp.uint8)


phash_batch = jax.jit(jax.vmap(phash))


def hamming_matrix(hashes: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distance of packed hashes [N, 8] u8 -> i32 [N, N]."""
    x = hashes[:, None, :] ^ hashes[None, :, :]
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


@partial(jax.jit, static_argnames=("threshold",))
def dedup_keep_mask(hashes: jnp.ndarray, threshold: int = 4) -> jnp.ndarray:
    """Greedy first-wins dedup: keep[i] unless a kept j<i is within threshold."""
    n = hashes.shape[0]
    dist = hamming_matrix(hashes)
    near = dist <= threshold

    def body(i, keep):
        dup = jnp.any(near[i] & keep & (jnp.arange(n) < i))
        return keep.at[i].set(~dup)

    # derive the init from `dist` so its sharding varyingness matches the
    # loop body under shard_map (dist[0,0] is always 0)
    init = (jnp.arange(n) == 0) & (dist[0, 0] == 0)
    return jax.lax.fori_loop(0, n, body, init)


@partial(jax.jit, static_argnames=("threshold",))
def dedup_keep_mask_vs_corpus(corpus: jnp.ndarray, corpus_count: jnp.ndarray,
                              hashes: jnp.ndarray,
                              threshold: int = 4) -> jnp.ndarray:
    """Greedy first-wins dedup of `hashes` against a fixed-capacity corpus.

    `corpus` is a [CAP, 8] u8 buffer of previously-kept hashes of which only
    the first `corpus_count` entries are live; a batch entry is dropped when
    it is within `threshold` of any live corpus entry or of an earlier kept
    batch entry.  Static shapes (CAP, N) keep this a single compiled program
    across batches; only `corpus_count` varies at runtime."""
    n = hashes.shape[0]
    dc = hashes[:, None, :] ^ corpus[None, :, :]
    dist_c = jnp.sum(jax.lax.population_count(dc).astype(jnp.int32), axis=-1)
    live = jnp.arange(corpus.shape[0]) < corpus_count
    dup_corpus = jnp.any((dist_c <= threshold) & live[None, :], axis=1)
    near = hamming_matrix(hashes) <= threshold

    def body(i, keep):
        dup = dup_corpus[i] | jnp.any(near[i] & keep & (jnp.arange(n) < i))
        return keep.at[i].set(~dup)

    # init derived from traced values so its sharding varyingness matches
    # the loop body under shard_map (cf. dedup_keep_mask above)
    init = dup_corpus & False
    return jax.lax.fori_loop(0, n, body, init)


@partial(jax.jit, static_argnames=("threshold",))
def dedup_append_step(corpus: jnp.ndarray, count: jnp.ndarray,
                      hashes: jnp.ndarray, n_valid: jnp.ndarray,
                      threshold: int = 4):
    """One batch of corpus dedup, entirely on device: keep mask for the
    batch + corpus with the kept hashes appended.

    The corpus state never crosses the host link — the host fetches only
    the [B] keep mask per batch, instead of uploading the corpus and
    fetching hashes and masks in small blocking transfers.  Entries at
    index >=
    n_valid are batch padding: never kept, never appended."""
    keep = dedup_keep_mask_vs_corpus(corpus, count, hashes,
                                     threshold=threshold)
    keep = keep & (jnp.arange(hashes.shape[0]) < n_valid)
    pos = count + jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, corpus.shape[0])
    corpus = corpus.at[tgt].set(hashes, mode="drop")
    return keep, corpus, count + jnp.sum(keep, dtype=jnp.int32)


def dedup_images(imgs, threshold: int = 4):
    """Convenience: hashes + keep mask for a u8 image batch [N, H, W, 3]."""
    h = phash_batch(jnp.asarray(imgs))
    return h, dedup_keep_mask(h, threshold=threshold)


class CorpusDedup:
    """Streaming corpus-level dedup state shared by both pipelines
    (models/rpm/generator.py, models/multigraph/generator.py).

    Realizes the reference README's claimed semantic-duplicate filter
    (reference README.md:8) across a whole run.  Two regimes:

    - single device (``mesh=None``): the corpus lives ON DEVICE and is
      advanced by one async `dedup_append_step` per batch — the host
      fetches only the [B] keep mask (no corpus upload and no hash fetch
      per batch).
    - device mesh: hashes stay device-resident and sharded; the keep mask
      is computed through `sharded_dedup_mask`'s all_gather against a
      replicated host-side corpus buffer, appended on host.

    ``submit`` is called at dispatch time (pipelined ahead of the
    transfer), ``resolve`` at flush time, in the same FIFO order.

    The corpus buffer is fixed-capacity (static shapes keep one compiled
    program across batches), pre-sized to the run's sample count and
    power-of-2 quantized so repeated runs with growing id lists stay
    logarithmic in compiled-shape count."""

    def __init__(self, capacity_hint: int, mesh=None, threshold: int = 4):
        cap = 4096
        while cap < capacity_hint:
            cap *= 2
        self.mesh = mesh
        self.threshold = int(threshold)
        self.device_resident = mesh is None
        if self.device_resident:
            self._corpus_dev = jnp.zeros((cap, 8), jnp.uint8)
            self._count_dev = jnp.int32(0)
        self._buf = np.zeros((cap, 8), np.uint8)
        self._count = 0

    def submit(self, hashes_dev, n_real: int):
        """Dispatch one batch's dedup; returns an opaque handle for
        `resolve`.  `hashes_dev` is the device-resident [B, 8] u8 batch
        (entries at index >= n_real are padding: never kept)."""
        if self.device_resident:
            keep_dev, self._corpus_dev, self._count_dev = dedup_append_step(
                self._corpus_dev, self._count_dev, hashes_dev,
                np.int32(n_real), threshold=self.threshold)
            getattr(keep_dev, "copy_to_host_async", lambda: None)()
            return ("dev", keep_dev, n_real)
        return ("host", hashes_dev, n_real)

    def resolve(self, handle) -> np.ndarray:
        """Block on one submitted batch; returns the bool keep mask
        [n_real].  Mesh-path batches also append kept hashes to the
        replicated corpus here, so calls must match `submit` order."""
        kind, val, n_real = handle
        if kind == "dev":
            return np.asarray(val)[:n_real].astype(bool)
        from ..parallel.mesh import sharded_dedup_mask
        hashes_dev = val
        while self._count + n_real > len(self._buf):
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)])
        count = np.int32(self._count)
        B = int(np.shape(hashes_dev)[0])
        if self.mesh is not None and B % self.mesh.size == 0:
            keep = sharded_dedup_mask(
                self.mesh, hashes_dev, threshold=self.threshold,
                corpus=self._buf, corpus_count=count)
        else:
            keep = dedup_keep_mask_vs_corpus(
                self._buf, count, hashes_dev, threshold=self.threshold)
        keep = np.asarray(keep)[:n_real].astype(bool)
        hashes = np.asarray(hashes_dev)[:n_real]
        kept = hashes[keep]
        self._buf[self._count:self._count + len(kept)] = kept
        self._count += len(kept)
        return keep
