# rle.py — lossless run-length codec for the device->host boundary.
"""Row-major RLE over packed-RGB pixels, encoded ON DEVICE.

Rendered canvases are long horizontal runs of identical color (background,
fills), so RLE beats the 8x8 block-sparse codec (ops/sparse.py) ~4x on
measured outputs: a 512^2 state frame is ~2.4k runs (p50, 19 KB at 8
bytes/run) vs 786 KB raw and ~275 KB block-sparse at the tuned budget.

Encoding per frame:
- pixels flatten row-major, RGB packed into one u32;
- run starts = positions where the packed value changes, compacted by
  cumsum + scatter-with-drop into a static [max_runs] buffer (a
  flatnonzero(size=...) formulation lowers through a full sort);
- transfer = (starts u32 [max_runs], colors u32 [max_runs], count i32).

The host reconstructs exactly (`np.repeat` over run lengths).  Frames with
more than `max_runs` runs raise OverflowError on unpack; callers fall back
to fetching the raw device-resident frame, same contract as ops/sparse.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def default_budget(H: int, W: int) -> int:
    """Default max_runs (capacity of the static device buffer).  Measured
    per-leaf maxima on production 512^2 frames: 3.8k (平移) to 10.6k
    (直接叠加 merged frames) — H*W/24 (~10.9k) covers every observed
    frame.  Capacity is cheap: the host-side adaptive shrink
    (io/transfer.py::coalesce_shrunk) truncates the transfer to the
    largest run count actually seen, so headroom costs device memory and
    first-batch bytes only."""
    return max(1024, (H * W) // 24)


def default_grid_budget(H: int, W: int) -> int:
    """Composed grids are denser (resized cells, AA text labels, borders):
    measured max 11.1k runs on 296x512 grids (组合), 9.3k on 216x512
    (直接叠加) — H*W/9 covers both.  An undersized budget is costly, not
    wrong: every overflow falls back to a raw device-frame fetch; the
    adaptive shrink reclaims the headroom."""
    return max(2048, (H * W) // 9)


def pack_frame_rle(img: jnp.ndarray, max_runs: int):
    """u8 [H, W, 3] -> (starts u32 [max_runs], colors u32 [max_runs],
    count i32)."""
    H, W = img.shape[:2]
    n = H * W
    flat = (img[..., 0].astype(jnp.uint32) << 16
            | img[..., 1].astype(jnp.uint32) << 8
            | img[..., 2].astype(jnp.uint32)).reshape(n)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), flat[1:] != flat[:-1]])
    pos = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    count = pos[-1] + 1
    # scatter each boundary pixel's index/color to its run slot; non-
    # boundary pixels and runs past the budget target max_runs -> dropped.
    # `pos` is nondecreasing, so `starts` comes out ascending — the host
    # decode needs no sort.
    tgt = jnp.where(boundary, pos, max_runs)
    starts = jnp.zeros((max_runs,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    colors = jnp.zeros((max_runs,), jnp.uint32).at[tgt].set(
        flat, mode="drop")
    return starts.astype(jnp.uint32), colors, count


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle(imgs: jnp.ndarray, max_runs: int):
    """u8 [..., H, W, 3] with any leading dims."""
    lead = imgs.shape[:-3]
    flat = imgs.reshape((-1,) + imgs.shape[-3:])
    starts, colors, count = jax.vmap(
        lambda x: pack_frame_rle(x, max_runs))(flat)
    return (starts.reshape(lead + starts.shape[1:]),
            colors.reshape(lead + colors.shape[1:]),
            count.reshape(lead))


def unpack_frame_rle(starts: np.ndarray, colors: np.ndarray, count: int,
                     shape) -> np.ndarray:
    """Host-side exact reconstruction.  Raises OverflowError when the frame
    exceeded the run budget (caller falls back to the raw device frame)."""
    H, W = shape[:2]
    n = H * W
    if count > starts.shape[0]:
        raise OverflowError(f"rle frame overflow: {count} > {starts.shape[0]}")
    s = np.asarray(starts[:count], np.int64)
    lengths = np.diff(np.append(s, n))
    flat = np.repeat(np.asarray(colors[:count], np.uint32), lengths)
    img = np.empty((n, 3), np.uint8)
    img[:, 0] = (flat >> 16) & 0xFF
    img[:, 1] = (flat >> 8) & 0xFF
    img[:, 2] = flat & 0xFF
    return img.reshape(H, W, 3)


# ---- v2: length+color codec at 5 bytes/run (u16 length + u8 RGB) ----
#
# The v1 transfer spends 8 bytes/run (u32 start + u32 packed color); the
# u32 start is redundant — consecutive run lengths describe the same
# positions in 2 bytes once no run exceeds 65535 pixels, which the encoder
# guarantees by forcing a run break at every multiple of 65535 (adds at
# most ceil(H*W/65535)-1 ~ 3 runs on a 512^2 frame).  Colors travel as
# 3 raw u8 channels.  Decode is np.repeat over lengths; the C PNG encoder
# (io/native/fastpng.c::fastpng_write_rle) consumes this stream directly
# without materializing host pixels.

U16_RUN = 65535


def _pack24(img: jnp.ndarray) -> jnp.ndarray:
    """u8 [H, W, 3] -> packed-RGB u32 [H*W] (row-major)."""
    return (img[..., 0].astype(jnp.uint32) << 16
            | img[..., 1].astype(jnp.uint32) << 8
            | img[..., 2].astype(jnp.uint32)).reshape(-1)


def _rle2_encode_values(val: jnp.ndarray, max_runs: int):
    """Core run encoder over an arbitrary u32 value stream:
    [n] -> (lengths u16 [max_runs], values u32 [max_runs], count i32)."""
    n = val.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), val[1:] != val[:-1]])
    boundary = boundary | (idx % U16_RUN == 0)
    pos = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    count = pos[-1] + 1
    # compact boundary positions/values into static run slots (cumsum +
    # scatter-with-drop; see pack_frame_rle for why not flatnonzero)
    tgt = jnp.where(boundary, pos, max_runs)
    starts = jnp.zeros((max_runs,), jnp.int32).at[tgt].set(idx, mode="drop")
    values = jnp.zeros((max_runs,), jnp.uint32).at[tgt].set(
        val, mode="drop")
    # run i length = next start - own start; the slot after the last live
    # run holds 0 (scatter-dropped), so patch it to n via the count test
    slot = jnp.arange(max_runs, dtype=jnp.int32)
    nxt = jnp.concatenate([starts[1:], jnp.zeros((1,), jnp.int32)])
    nxt = jnp.where(slot == count - 1, n, nxt)
    lengths = jnp.where(slot < count, nxt - starts, 0)
    lengths = jnp.clip(lengths, 0, U16_RUN).astype(jnp.uint16)
    return lengths, values, count


def _split24(colors: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([(colors >> 16) & 0xFF, (colors >> 8) & 0xFF,
                      colors & 0xFF], axis=-1).astype(jnp.uint8)


def pack_frame_rle2(img: jnp.ndarray, max_runs: int):
    """u8 [H, W, 3] -> (lengths u16 [max_runs], colors u8 [max_runs, 3],
    count i32)."""
    lengths, colors, count = _rle2_encode_values(_pack24(img), max_runs)
    return lengths, _split24(colors), count


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle2(imgs: jnp.ndarray, max_runs: int):
    """u8 [..., H, W, 3] with any leading dims."""
    lead = imgs.shape[:-3]
    flat = imgs.reshape((-1,) + imgs.shape[-3:])
    lengths, colors, count = jax.vmap(
        lambda x: pack_frame_rle2(x, max_runs))(flat)
    return (lengths.reshape(lead + lengths.shape[1:]),
            colors.reshape(lead + colors.shape[1:]),
            count.reshape(lead))


def pack_frame_rle2_delta(img: jnp.ndarray, base: jnp.ndarray,
                          max_runs: int):
    """Delta run encoding of one frame against a base frame.

    u8 [H, W, 3] x2 -> (lengths u16 [max_runs], colors u8 [max_runs, 3],
    copy bool [max_runs], count i32).  Pixels equal to `base` (all three
    channels) encode as the 25-bit sentinel, so unchanged spans collapse
    into single copy-from-base runs; `copy[i]` marks them (their color
    bytes are meaningless).  A keyframe is encoded by passing a base no
    pixel can equal (e.g. 255 - img: x == 255 - x has no u8 solution)."""
    flat = _pack24(img)
    val = jnp.where(flat == _pack24(base),
                    jnp.asarray(_DELTA_SENT), flat)
    lengths, colors, count = _rle2_encode_values(val, max_runs)
    slot = jnp.arange(max_runs, dtype=jnp.int32)
    copy = (colors == jnp.asarray(_DELTA_SENT)) & (slot < count)
    return lengths, _split24(colors), copy, count


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle2_delta(imgs: jnp.ndarray, bases: jnp.ndarray,
                          max_runs: int):
    """u8 [..., H, W, 3] frames + same-shaped bases, any leading dims."""
    lead = imgs.shape[:-3]
    flat = imgs.reshape((-1,) + imgs.shape[-3:])
    bflat = jnp.broadcast_to(bases, imgs.shape).reshape(flat.shape)
    lengths, colors, copy, count = jax.vmap(
        lambda x, b: pack_frame_rle2_delta(x, b, max_runs))(flat, bflat)
    return (lengths.reshape(lead + lengths.shape[1:]),
            colors.reshape(lead + colors.shape[1:]),
            copy.reshape(lead + copy.shape[1:]),
            count.reshape(lead))


# ---- v3: batch-compacted palette codec (~3 bytes/run, zero slack) ----
#
# Two structural wastes remain in the per-frame rle2 transfer:
#   1. every frame ships its full (tiered) run CAPACITY — the tier covers
#      the largest frame the leaf ever produced, but the p50 frame is
#      2-3x below it, so most of the stream is dead slots;
#   2. every run ships 3 raw color bytes although a frame draws from a
#      small working set (element fills + the AA ramp against them —
#      measured 78-850 distinct colors/frame on production outputs).
# v3 removes both ON DEVICE: all frames of a tensor scatter their live
# runs into ONE contiguous stream (per-frame offsets = exclusive cumsum
# of run counts, so the shipped axis is the batch TOTAL, whose relative
# variance is ~sqrt(F) smaller than a single frame's), and each frame
# gets a 255-entry most-frequent-color palette; runs outside it carry
# the marker index 255 and their RGB travels in a separate compacted
# escape stream, so >255-color frames degrade by a few bytes instead of
# falling back to a 786 KB raw fetch.  Per run: u16 length + u8 index =
# 3 bytes, plus amortized palette (<=765 B/frame, compacted to its true
# size) and escapes (3 B each, usually zero).
#
# Decode contract (host, exact): for frame f with run count c=cnt[f],
#   ln  = LN [off[f] : off[f]+c]          off = exclusive cumsum of cnt
#   ix  = IDX[off[f] : off[f]+c]
#   pal = PAL[poff[f] : poff[f]+min(nc[f],255)]
#   esc = ESC[eoff[f] : eoff[f]+ec[f]]
#   rgb = pal[ix];  rgb[ix == 255] = esc   (in stream order)
# A frame overflows (caller fetches it raw) iff c > the per-frame device
# capacity or its run/escape slice extends past the (adaptively shrunk)
# shipped stream.

PAL_K = 255          # palette entries per frame; index 255 = escape marker
ESC_MARK = 255
# ---- v3d: inter-frame delta extension (codec 'rle3d') ----
# Sequence frames differ from their predecessor by one or two element-
# sized regions (rule steps move/rotate single elements), and option
# frames are single-element variants of the last state.  The delta
# encoder runs the SAME run-length machinery over a synthetic value
# stream where pixels equal to a base frame carry a 25-bit sentinel (no
# 24-bit RGB can collide), so unchanged spans collapse to single
# "copy-from-base" runs regardless of their underlying content.  Copy
# runs travel as palette index 254, shrinking the per-frame palette to
# 254 real entries; everything else (stream shapes, tiers, coalescing,
# overflow fallback) is identical to rle3.  Decode needs the base
# frame's pixels, so state chains materialize sequentially on the host
# (state 0 is a keyframe: its base is the bitwise complement, which no
# u8 pixel ever equals).
COPY_MARK = 254
# numpy scalar (module-level jnp would device_put at import; see below)
_DELTA_SENT = np.uint32(0x1000000)   # bit 24: outside every packed RGB
# numpy scalar, not jnp.uint32(...): a module-level device scalar
# would initialize the backend at import time; np.uint32 carries the
# dtype without a device_put
_PAL_SENTINEL = np.uint32(0xFFFFFFFF)   # sorts past every 24-bit color


def palettize_frame_esc(rgb: jnp.ndarray, count: jnp.ndarray,
                        copy: jnp.ndarray | None = None, k: int = PAL_K):
    """(rgb u8 [cap, 3], count) -> (pal u8 [255, 3], nc i32, idx u8 [cap],
    esc_mask bool [cap]).

    Top-k-by-frequency palette over the LIVE runs: sort the packed
    colors, mark unique boundaries, measure each unique's multiplicity as
    boundary-to-boundary distance (the same cumsum/scatter compaction the
    run encoder uses), lax.top_k the multiplicities, then re-sort the
    winners by value so searchsorted can map runs to indices.  `nc` is
    the TRUE distinct-color count (may exceed k); runs whose color
    missed the palette get idx=255 and esc_mask set.

    With a `copy` mask (delta streams, k=COPY_MARK=254), copy runs are
    excluded from the palette and escapes and carry idx=254; the PAL
    output keeps its [255, 3] shape with the tail sentinel-padded."""
    cap = rgb.shape[0]
    col32 = (rgb[:, 0].astype(jnp.uint32) << 16
             | rgb[:, 1].astype(jnp.uint32) << 8
             | rgb[:, 2].astype(jnp.uint32))
    live = jnp.arange(cap, dtype=jnp.int32) < count
    pal_ok = live if copy is None else (live & ~copy)
    s = jnp.sort(jnp.where(pal_ok, col32, _PAL_SENTINEL))
    uniq = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    uniq = uniq & (s != _PAL_SENTINEL)
    pos = jnp.cumsum(uniq.astype(jnp.int32)) - 1
    nc = jnp.where(jnp.any(uniq), pos[-1] + 1, 0)
    # compact unique colors + their first sorted position into [cap] slots
    slot_i = jnp.arange(cap, dtype=jnp.int32)
    tgt = jnp.where(uniq, pos, cap)
    # dead slots carry the sentinel so unchosen top_k picks sort to the
    # END of the palette (0 would sort to the front and displace real
    # colors)
    u_col = jnp.full((cap,), _PAL_SENTINEL, jnp.uint32).at[tgt].set(
        s, mode="drop")
    u_start = jnp.zeros((cap,), jnp.int32).at[tgt].set(slot_i, mode="drop")
    # multiplicity = next unique's start - own start (last one ends at the
    # palette-eligible count); dead slots get 0 so top_k never prefers
    # them over real colors
    nxt = jnp.concatenate([u_start[1:], jnp.zeros((1,), jnp.int32)])
    n_live = jnp.sum(pal_ok, dtype=jnp.int32)
    nxt = jnp.where(slot_i == nc - 1, n_live, nxt)
    mult = jnp.where(slot_i < nc, nxt - u_start, 0)
    _topv, topi = jax.lax.top_k(mult, k)
    chosen = u_col[topi]                       # [k] u32, sentinel-padded
    pal32 = jnp.sort(chosen)                   # ascending for searchsorted
    # dead choices (mult 0 slots) carry the sentinel and sort to the end
    pal32 = jnp.where(jnp.arange(k) < jnp.minimum(nc, k),
                      pal32, _PAL_SENTINEL)
    if k < PAL_K:  # keep PAL's [255, 3] shape across codec variants
        pal32 = jnp.concatenate(
            [pal32, jnp.full((PAL_K - k,), _PAL_SENTINEL, jnp.uint32)])
    j = jnp.searchsorted(pal32, col32).astype(jnp.int32)
    jc = jnp.minimum(j, PAL_K - 1)
    # a real color never equals the sentinel, so hits land in [0, k)
    hit = (j < PAL_K) & (pal32[jc] == col32)
    idx = jnp.where(hit, jc, ESC_MARK).astype(jnp.uint8)
    esc_mask = live & ~hit
    if copy is not None:
        idx = jnp.where(copy, jnp.uint8(COPY_MARK), idx)
        esc_mask = esc_mask & ~copy
    pal = jnp.stack([(pal32 >> 16) & 0xFF, (pal32 >> 8) & 0xFF,
                     pal32 & 0xFF], axis=-1).astype(jnp.uint8)
    return pal, nc, idx, esc_mask


def _compact(values: jnp.ndarray, counts: jnp.ndarray, cap_out: int):
    """Scatter per-frame prefixes into one contiguous stream.

    values [F, cap, ...] / counts [F] -> stream [cap_out, ...]: frame f's
    first counts[f] slots land at offset exclusive-cumsum(counts)[f].
    Entries past cap_out drop (the host detects the truncation from the
    counts, which always travel whole)."""
    F, cap = values.shape[0], values.shape[1]
    off = jnp.cumsum(counts) - counts          # exclusive
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = slot < counts[:, None]
    tgt = jnp.where(live, off[:, None] + slot, cap_out)
    out_shape = (cap_out,) + values.shape[2:]
    return jnp.zeros(out_shape, values.dtype).at[tgt.reshape(-1)].set(
        values.reshape((-1,) + values.shape[2:]), mode="drop")


def _compact_rle3_impl(lengths, rgb, count, copy, k: int,
                       ln_mode: str = "u16"):
    lead = count.shape
    cap = lengths.shape[-1]
    ln = lengths.reshape(-1, cap)
    co = rgb.reshape(-1, cap, 3)
    cnt = count.reshape(-1).astype(jnp.int32)
    F = ln.shape[0]
    if copy is None:
        pal, nc, idx, esc_mask = jax.vmap(
            lambda c, n: palettize_frame_esc(c, n, None, k))(co, cnt)
    else:
        pal, nc, idx, esc_mask = jax.vmap(
            lambda c, n, m: palettize_frame_esc(c, n, m, k))(
                co, cnt, copy.reshape(-1, cap))
    c = jnp.minimum(cnt, cap)                  # runs past cap never packed
    IDX = _compact(idx, c, F * cap)
    # escapes compact twice: within the frame (run order), then across
    # frames — reuse _compact by first gathering each frame's escape RGBs
    # into its own prefix
    ec = jnp.sum(esc_mask, axis=1).astype(jnp.int32)
    epos = jnp.cumsum(esc_mask, axis=1) - 1
    etgt = jnp.where(esc_mask, epos, cap)
    esc_f = jnp.zeros((F, cap, 3), jnp.uint8)
    esc_f = jax.vmap(lambda t, v, buf: buf.at[t].set(v, mode="drop"))(
        etgt, co, esc_f)
    ESC = _compact(esc_f, ec, F * cap)
    nck = jnp.minimum(nc, k)
    PAL = _compact(pal, nck, F * PAL_K)
    if ln_mode == "u16":
        LN = _compact(ln, c, F * cap)
        return (LN, IDX, PAL, ESC, cnt.reshape(lead), nc.reshape(lead),
                ec.reshape(lead))
    # v4 wire format: u8 lengths + a compacted u16 extension stream.
    # Median run length on production frames is 1 (AA edge pixels), so
    # the u16 length byte is dead weight on most runs; lengths 1-255
    # ship as one u8, longer runs ship 0 (no live run has length 0) and
    # their true u16 length rides a per-frame extension stream compacted
    # exactly like the escapes (measured: 0.2% of grid runs and ~8% of
    # state/option runs exceed 255 -> 33%/28% run-byte savings).
    big = ln > 255                             # dead slots are 0, never big
    xc = jnp.sum(big, axis=1).astype(jnp.int32)
    xpos = jnp.cumsum(big, axis=1) - 1
    xtgt = jnp.where(big, xpos, cap)
    lnx_f = jnp.zeros((F, cap), jnp.uint16)
    lnx_f = jax.vmap(lambda t, v, buf: buf.at[t].set(v, mode="drop"))(
        xtgt, ln, lnx_f)
    LNX = _compact(lnx_f, xc, F * cap)
    if ln_mode == "u8":
        LN8 = _compact(jnp.where(big, 0, ln).astype(jnp.uint8), c, F * cap)
        return (LN8, IDX, PAL, ESC, LNX, cnt.reshape(lead),
                nc.reshape(lead), ec.reshape(lead), xc.reshape(lead))
    # v5 wire format ("bm1"): even the u8 length byte is dead weight on
    # the MAJORITY of runs — the median production run is a single AA
    # edge pixel.  Each live run contributes ONE BIT to a per-frame
    # bitmask (1 = length 1); only runs with length != 1 ship a length
    # byte, compacted within the frame in run order exactly like the
    # escapes (0 still marks a >255 run whose true u16 rides LNX, a
    # subset of the != 1 runs, so the two in-frame orders agree).
    # Per-frame bitmask bytes = ceil(c/8), byte-aligned so the host can
    # np.unpackbits each frame's slice independently (little bit order).
    assert ln_mode == "bm1", ln_mode
    live = jnp.arange(cap, dtype=jnp.int32)[None, :] < c[:, None]
    one = live & (ln == 1)
    capp = -(-cap // 8) * 8
    one_p = jnp.pad(one, ((0, 0), (0, capp - cap)))
    weights = (jnp.uint32(1) << jnp.arange(8, dtype=jnp.uint32))
    bm_f = (one_p.reshape(F, capp // 8, 8).astype(jnp.uint32)
            * weights[None, None, :]).sum(-1).astype(jnp.uint8)
    bc = (c + 7) // 8                          # live bitmask bytes/frame
    BM = _compact(bm_f, bc, F * (capp // 8))
    notone = live & (ln != 1)
    sc = jnp.sum(notone, axis=1).astype(jnp.int32)
    spos = jnp.cumsum(notone, axis=1) - 1
    stgt = jnp.where(notone, spos, cap)
    ln8s_f = jnp.zeros((F, cap), jnp.uint8)
    ln8s_f = jax.vmap(lambda t, v, buf: buf.at[t].set(v, mode="drop"))(
        stgt, jnp.where(big, 0, ln).astype(jnp.uint8), ln8s_f)
    LNS = _compact(ln8s_f, sc, F * cap)
    return (BM, LNS, IDX, PAL, ESC, LNX, cnt.reshape(lead),
            nc.reshape(lead), ec.reshape(lead), xc.reshape(lead),
            sc.reshape(lead))


@partial(jax.jit, static_argnames=())
def compact_rle3(lengths: jnp.ndarray, rgb: jnp.ndarray, count: jnp.ndarray):
    """Batch rle2 streams -> one compacted rle3 transfer tuple.

    (lengths u16 [..., cap], rgb u8 [..., cap, 3], count i32 [...]) ->
    (LN u16 [Tcap], IDX u8 [Tcap], PAL u8 [Pcap, 3], ESC u8 [Ecap, 3],
     cnt i32 [...], nc i32 [...], ec i32 [...])
    with Tcap = Ecap = F*cap and Pcap = F*255 STATIC device capacities
    (the adaptive transfer shrink truncates each stream axis to its tier
    before the bytes move)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K)


@partial(jax.jit, static_argnames=())
def compact_rle3d(lengths: jnp.ndarray, rgb: jnp.ndarray,
                  copy: jnp.ndarray, count: jnp.ndarray):
    """Delta rle2 streams (pack_batch_rle2_delta) -> compacted transfer.

    Identical tuple structure to compact_rle3; copy runs carry
    IDX=COPY_MARK (254), so per-frame palettes hold at most 254 real
    entries — the host must mirror that in its offsets
    (Rle3Frames(pal_k=COPY_MARK))."""
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK)


@partial(jax.jit, static_argnames=())
def compact_rle4(lengths: jnp.ndarray, rgb: jnp.ndarray, count: jnp.ndarray):
    """rle3 with the v4 wire format: LN travels as u8 (runs >255 ship 0
    + their true u16 length in a compacted extension stream).

    Returns (LN8 u8 [Tcap], IDX u8 [Tcap], PAL u8 [Pcap, 3],
    ESC u8 [Ecap, 3], LNX u16 [Xcap], cnt, nc, ec, xc)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K,
                              ln_mode="u8")


@partial(jax.jit, static_argnames=())
def compact_rle4d(lengths: jnp.ndarray, rgb: jnp.ndarray,
                  copy: jnp.ndarray, count: jnp.ndarray):
    """Delta rle2 streams -> compacted v4 transfer (compact_rle3d with the
    u8-length wire format; copy runs still carry IDX=COPY_MARK)."""
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK,
                              ln_mode="u8")


@partial(jax.jit, static_argnames=())
def compact_rle5(lengths: jnp.ndarray, rgb: jnp.ndarray, count: jnp.ndarray):
    """rle4 with the v5 wire format: a 1-bit-per-run "length is 1" bitmask
    replaces the length byte on single-pixel runs (the production median).

    Returns (BM u8 [Bcap], LNS u8 [Scap], IDX u8 [Tcap], PAL u8 [Pcap, 3],
    ESC u8 [Ecap, 3], LNX u16 [Xcap], cnt, nc, ec, xc, sc)."""
    return _compact_rle3_impl(lengths, rgb, count, None, PAL_K,
                              ln_mode="bm1")


@partial(jax.jit, static_argnames=())
def compact_rle5d(lengths: jnp.ndarray, rgb: jnp.ndarray,
                  copy: jnp.ndarray, count: jnp.ndarray):
    """Delta rle2 streams -> compacted v5 transfer (copy runs still carry
    IDX=COPY_MARK; length-1 copy runs ride the bitmask like any other)."""
    return _compact_rle3_impl(lengths, rgb, count, copy, COPY_MARK,
                              ln_mode="bm1")


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle3(imgs: jnp.ndarray, max_runs: int):
    """Render batch -> compacted rle3 transfer tuple in ONE dispatch
    (pack_batch_rle2 + compact_rle3 fused under a single jit)."""
    ln, co, cnt = pack_batch_rle2(imgs, max_runs)
    return compact_rle3(ln, co, cnt)


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle4(imgs: jnp.ndarray, max_runs: int):
    """Render batch -> compacted rle4 transfer tuple in ONE dispatch."""
    ln, co, cnt = pack_batch_rle2(imgs, max_runs)
    return compact_rle4(ln, co, cnt)


@partial(jax.jit, static_argnames=("max_runs",))
def pack_batch_rle5(imgs: jnp.ndarray, max_runs: int):
    """Render batch -> compacted rle5 transfer tuple in ONE dispatch."""
    ln, co, cnt = pack_batch_rle2(imgs, max_runs)
    return compact_rle5(ln, co, cnt)


def rle3_offsets(cnt: np.ndarray, nc: np.ndarray, ec: np.ndarray, cap: int,
                 pal_k: int = PAL_K):
    """Host-side per-frame stream offsets (exclusive cumsums, flat frame
    order) mirroring compact_rle3's scatter targets."""
    c = np.minimum(np.asarray(cnt, np.int64).reshape(-1), cap)
    nck = np.minimum(np.asarray(nc, np.int64).reshape(-1), pal_k)
    e = np.asarray(ec, np.int64).reshape(-1)
    return (np.cumsum(c) - c, np.cumsum(nck) - nck, np.cumsum(e) - e)


class Rle3Frames:
    """Host view over one tensor's compacted rle3 transfer.

    frame(i) -> (lengths u16 [c], rgb u8 [c, 3]) reconstructed exactly;
    OverflowError when the frame exceeded its device run capacity or its
    slice was truncated by the adaptive shrink (caller fetches raw).
    `overflow_indices(n)` lists those frames up front so the raw
    fallbacks batch into one gathered fetch.

    Delta streams (compact_rle3d) pass delta=True: pal_k drops to
    COPY_MARK and `unpack_delta(i, base)` splices copy runs from the
    base frame's pixels.

    9-tuples (compact_rle4/compact_rle4d) carry the v4 wire format:
    LN is u8 and runs >255 pull their true u16 length from the LNX
    extension stream (detected by tuple arity; everything else is
    identical).

    11-tuples (compact_rle5/compact_rle5d) carry the v5 wire format:
    per-frame byte-aligned bitmask BM (bit set = run length 1, little
    bit order), LNS holding u8 lengths of the != 1 runs only (0 still
    marking >255 runs extended via LNX)."""

    def __init__(self, packed, cap: int, delta: bool = False):
        self.BM = self.LNS = self.sc = None
        if len(packed) == 11:
            BM, LNS, IDX, PAL, ESC, LNX, cnt, nc, ec, xc, sc = packed
            self.BM = np.asarray(BM)
            self.LNS = np.asarray(LNS)
            self.sc = np.asarray(sc).reshape(-1)
            self.LN = None
            self.LNX = np.asarray(LNX)
            self.xc = np.asarray(xc).reshape(-1)
        elif len(packed) == 9:
            LN, IDX, PAL, ESC, LNX, cnt, nc, ec, xc = packed
            self.LN = np.asarray(LN)
            self.LNX = np.asarray(LNX)
            self.xc = np.asarray(xc).reshape(-1)
        else:
            LN, IDX, PAL, ESC, cnt, nc, ec = packed
            self.LN = np.asarray(LN)
            self.LNX = None
            self.xc = None
        self.IDX = np.asarray(IDX)
        self.PAL = np.asarray(PAL)
        self.ESC = np.asarray(ESC)
        self.cnt = np.asarray(cnt).reshape(-1)
        self.nc = np.asarray(nc).reshape(-1)
        self.ec = np.asarray(ec).reshape(-1)
        self.cap = cap
        self.delta = delta
        self.pal_k = COPY_MARK if delta else PAL_K
        self.off, self.poff, self.eoff = rle3_offsets(
            self.cnt, self.nc, self.ec, cap, self.pal_k)
        if self.xc is not None:
            x = np.asarray(self.xc, np.int64)
            self.xoff = np.cumsum(x) - x
        else:
            self.xoff = None
        if self.BM is not None:
            c = np.minimum(np.asarray(self.cnt, np.int64), cap)
            bc = (c + 7) // 8
            self.bmoff = np.cumsum(bc) - bc
            s = np.asarray(self.sc, np.int64)
            self.soff = np.cumsum(s) - s

    def _bad(self, i: int) -> bool:
        # Empty slices never overflow: offsets are cumulative, so one
        # burst frame that truncates a shrunk stream must not cascade
        # "bad" onto later frames that take nothing from that stream
        # (measured: a single >255-color frame flagging the whole batch
        # tail turned ~225 KB/sample transfers into ~2 MB/sample of raw
        # 786 KB fallback fetches).
        c, e = int(self.cnt[i]), int(self.ec[i])
        nck = min(int(self.nc[i]), self.pal_k)
        if self.xc is not None:
            x = int(self.xc[i])
            if x > 0 and self.xoff[i] + x > self.LNX.shape[0]:
                return True
        if self.BM is not None:
            bc = (c + 7) // 8
            s = int(self.sc[i])
            if bc > 0 and self.bmoff[i] + bc > self.BM.shape[0]:
                return True
            if s > 0 and self.soff[i] + s > self.LNS.shape[0]:
                return True
        run_stream = self.IDX if self.LN is None else self.LN
        return (c > self.cap
                or (c > 0 and self.off[i] + c > run_stream.shape[0])
                or (e > 0 and self.eoff[i] + e > self.ESC.shape[0])
                or (nck > 0 and self.poff[i] + nck > self.PAL.shape[0]))

    def overflow_indices(self, n_frames: int) -> np.ndarray:
        return np.asarray([i for i in range(n_frames) if self._bad(i)],
                          np.int64)

    def overflow_reasons(self, n_frames: int) -> dict:
        """Per-stream attribution of overflowed frames ('T'/'E'/'P'/'X'
        counts; one frame can hit several).  Diagnostic only — the
        decode path uses overflow_indices."""
        out = {"T": 0, "E": 0, "P": 0, "X": 0, "B": 0, "S": 0}
        run_stream = self.IDX if self.LN is None else self.LN
        for i in range(n_frames):
            if not self._bad(i):
                continue
            c, e = int(self.cnt[i]), int(self.ec[i])
            nck = min(int(self.nc[i]), self.pal_k)
            if c > self.cap or (c > 0
                                and self.off[i] + c > run_stream.shape[0]):
                out["T"] += 1
            if e > 0 and self.eoff[i] + e > self.ESC.shape[0]:
                out["E"] += 1
            if nck > 0 and self.poff[i] + nck > self.PAL.shape[0]:
                out["P"] += 1
            if (self.xc is not None and int(self.xc[i]) > 0
                    and self.xoff[i] + int(self.xc[i]) > self.LNX.shape[0]):
                out["X"] += 1
            if self.BM is not None:
                bc = (c + 7) // 8
                if bc > 0 and self.bmoff[i] + bc > self.BM.shape[0]:
                    out["B"] += 1
                s = int(self.sc[i])
                if s > 0 and self.soff[i] + s > self.LNS.shape[0]:
                    out["S"] += 1
        return {k: v for k, v in out.items() if v}

    def frame(self, i: int):
        """(lengths, rgb) of frame i; delta streams additionally return
        the per-run copy mask as a third element."""
        if self._bad(i):
            raise OverflowError(f"rle3 frame {i} overflowed")
        c, e = int(self.cnt[i]), int(self.ec[i])
        nck = min(int(self.nc[i]), self.pal_k)
        o = int(self.off[i])
        if self.BM is not None:
            # v5: rebuild lengths from the length-1 bitmask + the != 1
            # length stream (whose 0 markers still extend via LNX)
            bc = (c + 7) // 8
            bo = int(self.bmoff[i])
            bits = np.unpackbits(self.BM[bo:bo + bc],
                                 bitorder="little")[:c].astype(bool)
            s = int(self.sc[i])
            if int((~bits).sum()) != s:
                raise OverflowError(
                    f"rle5 frame {i}: non-one count mismatch")
            so = int(self.soff[i])
            ln8s = self.LNS[so:so + s]
            ln_no = ln8s.astype(np.uint16)
            ext = ln8s == 0
            x = int(self.xc[i])
            if int(ext.sum()) != x:
                raise OverflowError(
                    f"rle5 frame {i}: extension count mismatch")
            if x:
                xo = int(self.xoff[i])
                ln_no[ext] = self.LNX[xo:xo + x]
            ln = np.ones(c, np.uint16)
            ln[~bits] = ln_no
        else:
            ln = self.LN[o:o + c]
            if self.LNX is not None:
                # v4: splice extended lengths over the u8 stream's 0 markers
                ln8 = ln
                ln = ln8.astype(np.uint16)
                ext = ln8 == 0
                x = int(self.xc[i])
                if int(ext.sum()) != x:
                    raise OverflowError(
                        f"rle4 frame {i}: extension count mismatch")
                if x:
                    xo = int(self.xoff[i])
                    ln[ext] = self.LNX[xo:xo + x]
        ix = self.IDX[o:o + c].astype(np.int64)
        pal = self.PAL[int(self.poff[i]):int(self.poff[i]) + nck]
        if nck:
            rgb = pal[np.minimum(ix, nck - 1)]
        else:
            # no palette entries at all — every run is a copy (delta
            # streams: e.g. the correct option IS the last state) or an
            # escape; colors come entirely from ESC / the base frame
            rgb = np.zeros((c, 3), np.uint8)
        m = ix == ESC_MARK
        if int(m.sum()) != e:
            raise OverflowError(f"rle3 frame {i}: escape count mismatch")
        if e:
            eo = int(self.eoff[i])
            rgb = rgb.copy()
            rgb[m] = self.ESC[eo:eo + e]
        if self.delta:
            return (np.ascontiguousarray(ln), np.ascontiguousarray(rgb),
                    ix == COPY_MARK)
        return np.ascontiguousarray(ln), np.ascontiguousarray(rgb)

    def unpack(self, i: int, shape) -> np.ndarray:
        if self.delta:
            raise ValueError("delta stream: use unpack_delta(i, base, ...)")
        ln, rgb = self.frame(i)
        return unpack_frame_rle2(ln, rgb, ln.shape[0], shape)

    def unpack_delta(self, i: int, base: np.ndarray, shape) -> np.ndarray:
        """Exact reconstruction of delta frame i against `base` (the
        previous frame's decoded [H, W, 3] pixels — or anything of that
        shape for keyframes, whose streams contain no copy runs)."""
        ln, rgb, copy = self.frame(i)
        H, W = shape[:2]
        n = H * W
        l64 = np.asarray(ln, np.int64)
        if int(l64.sum()) != n:
            raise OverflowError(f"rle3d frame {i} length sum != {n}")
        flat = np.repeat(rgb, l64, axis=0)
        if copy.any():
            px_copy = np.repeat(copy, l64)
            bflat = np.asarray(base, np.uint8).reshape(n, 3)
            flat[px_copy] = bflat[px_copy]
        return flat.reshape(H, W, 3)

    def nbytes_shipped(self) -> int:
        n = (self.IDX.nbytes + self.PAL.nbytes
             + self.ESC.nbytes + self.cnt.nbytes + self.nc.nbytes
             + self.ec.nbytes)
        if self.LN is not None:
            n += self.LN.nbytes
        if self.BM is not None:  # v5: bitmask + != 1 length stream
            n += self.BM.nbytes + self.LNS.nbytes + self.sc.nbytes
        if self.LNX is not None:
            n += self.LNX.nbytes + self.xc.nbytes
        return n


def unpack_frame_rle2(lengths: np.ndarray, colors: np.ndarray, count: int,
                      shape) -> np.ndarray:
    """Host-side exact reconstruction of the v2 stream.  OverflowError when
    the frame exceeded the run budget (caller fetches the raw frame)."""
    H, W = shape[:2]
    n = H * W
    if count > lengths.shape[0]:
        raise OverflowError(
            f"rle2 frame overflow: {count} > {lengths.shape[0]}")
    ln = np.asarray(lengths[:count], np.int64)
    total = int(ln.sum())
    if total != n:  # truncated/corrupt stream — treat as overflow
        raise OverflowError(f"rle2 length sum {total} != {n}")
    return np.repeat(np.asarray(colors[:count], np.uint8), ln,
                     axis=0).reshape(H, W, 3)
