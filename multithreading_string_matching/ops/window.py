"""Shifted-window equality matcher — the fast path for short patterns.

The reference's KMP exists to avoid re-scanning text on a mismatch — the
right trade on a scalar CPU.  On a vector device the per-byte dependent
table gather that a DFA scan needs serializes the scan, while bulk shifts
and byte compares are cheap.  For short patterns (the reference corpus is
2-12 bytes; the fscanf token buffer caps patterns at 99) the occurrence count
has a fully data-parallel form with NO sequential dependency at all::

    match[n, i] = AND_{j < m} (payload[n, i+j] == pattern[j])
    count       = sum over (n, i with i + m <= length[n]) of match

i.e. every text position is tested independently — which is exactly the
overlapping-occurrence semantics of kmp_matcher (serial.c:190-215): an
occurrence per position where the pattern ends.  Work is Sum(m_p) ops/byte of
pure integer compare/AND, with zero gathers and zero carried state; XLA fuses the
j-loop into a handful of elementwise kernels.

Chunking/streaming: a chunk needs the previous chunk's last (m_max - 1)
bytes as a left halo — no carried DFA state, just bytes (stream/pipeline
callers keep that tail around).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class WindowProgram(NamedTuple):
    """Host-compiled pattern tensors for the window matcher.

    Patterns are packed into little-endian uint32 words with per-word byte
    masks, so the device compares 4 payload bytes per op.  Words past a
    pattern's end get ``mask=0, word=0`` — ``(w & 0) == 0`` is always true,
    so short patterns need no extra predicate.
    """

    pat_words: np.ndarray   # uint32[U, K] packed pattern words
    pat_masks: np.ndarray   # uint32[U, K] per-word byte masks (0 past end)
    pat_lens: np.ndarray    # int32[U]
    dup_map: np.ndarray     # int32[P] original index -> unique index
    max_len: int            # M (bytes)
    unique_patterns: tuple  # the deduplicated pattern bytes, build order

    @staticmethod
    def build(patterns) -> "WindowProgram":
        pats = [bytes(p) for p in patterns]
        if not pats or any(len(p) == 0 for p in pats):
            raise ValueError("patterns must be non-empty")
        uniq, index, dup = [], {}, []
        for p in pats:
            if p not in index:
                index[p] = len(uniq)
                uniq.append(p)
            dup.append(index[p])
        m = max(len(p) for p in uniq)
        k = -(-m // 4)
        pw = np.zeros((len(uniq), k), dtype=np.uint32)
        pm = np.zeros((len(uniq), k), dtype=np.uint32)
        pl = np.zeros(len(uniq), dtype=np.int32)
        for i, p in enumerate(uniq):
            pl[i] = len(p)
            padded = p + b"\x00" * (4 * k - len(p))
            words = np.frombuffer(padded, dtype="<u4")
            for w in range(k):
                rem = len(p) - 4 * w
                if rem <= 0:
                    break
                nb = min(4, rem)
                mask = np.uint32(0xFFFFFFFF) if nb == 4 else np.uint32((1 << (8 * nb)) - 1)
                pm[i, w] = mask
                pw[i, w] = words[w] & mask
        return WindowProgram(pw, pm, pl, np.asarray(dup, np.int32), m, tuple(uniq))


# Patterns are processed in groups of G so the broadcast [G, N, L] compare
# chain stays small enough for XLA to fuse straight into its reduction —
# a full [U, N, L] intermediate would be hundreds of MB of HBM traffic.
GROUP = 8


def _word_views(payloads, K: int):
    """The shared window algebra, step 1: right-pad so every shifted window
    is a static [N, L] slice, then build the little-endian 4-byte word
    starting at EVERY byte position once — all patterns and word offsets
    reuse shifted views of the result (uint32[N, L + 4(K-1) + 1])."""
    n, L = payloads.shape
    x = jnp.pad(payloads, ((0, 0), (0, 4 * K + 4))).astype(jnp.uint32)
    L4 = L + 4 * (K - 1) + 1

    def shifted(j):
        return jax.lax.slice(x, (0, j), (n, j + L4))

    return shifted(0) | (shifted(1) << 8) | (shifted(2) << 16) | (shifted(3) << 24)


def _group_bitmap(pat_words, pat_masks, pat_lens, w32, lengths, positions, g0, g1):
    """The shared window algebra, step 2: acc[g, n, i] = pattern g (of group
    [g0, g1)) matches at position i.  One masked word compare per 4 pattern
    bytes — words past a pattern's end have mask 0 and word 0, which compare
    true automatically — then the whole-pattern fit mask.  Counting and
    offset extraction both reduce from THIS bitmap, so they cannot diverge."""
    n, L = positions.shape
    K = pat_words.shape[1]
    pw = pat_words[g0:g1]
    pm = pat_masks[g0:g1]
    pl = pat_lens[g0:g1]
    acc = None
    for k in range(K):
        wk = jax.lax.slice(w32, (0, 4 * k), (n, 4 * k + L))   # [N, L]
        hit = (wk[None, :, :] & pm[:, k, None, None]) == pw[:, k, None, None]
        acc = hit if acc is None else acc & hit
    fit = positions[None, :, :] + pl[:, None, None] <= lengths[None, :, None]
    return acc & fit


def _window_one(
    pat_words, pat_masks, pat_lens, payloads, lengths, per_packet: bool,
    min_end: int = 0, min_start: int = 0,
):
    """Core tile matcher.

    ``min_end``: count only matches whose END index is >= min_end.  Used by
    halo-chunked streaming: a chunk is processed with the previous chunk's
    last (m_max - 1) bytes prepended, and min_end = halo width assigns every
    match to exactly one chunk (the one its end falls in) — a match never
    needs forward bytes, so a backward halo is sufficient and exact.
    ``min_start``: count only matches starting at/after this index — a
    stream's halo starts as fabricated zeros, and a NUL-containing pattern
    must not match into them.  Accepts a TRACED scalar (halo-fill chunking
    passes H - real_fill, which shrinks to 0 as real bytes arrive) or a
    static int (0 skips the mask entirely on the hot paths).
    """
    n, L = payloads.shape
    U, K = pat_words.shape
    w32 = _word_views(payloads, K)
    positions = jax.lax.broadcasted_iota(jnp.int32, (n, L), 1)

    outs = []
    for g0 in range(0, U, GROUP):
        g1 = min(g0 + GROUP, U)
        acc = _group_bitmap(
            pat_words, pat_masks, pat_lens, w32, lengths, positions, g0, g1
        )
        pl = pat_lens[g0:g1]
        if min_end:
            # end index = i + m - 1 must fall at/after min_end
            acc = acc & (positions[None, :, :] + pl[:, None, None] - 1 >= min_end)
        if not (isinstance(min_start, int) and min_start == 0):
            acc = acc & (positions[None, :, :] >= min_start)
        if per_packet:
            outs.append(acc.sum(axis=2, dtype=jnp.int32).T)       # [N, g]
        else:
            outs.append(acc.sum(axis=(1, 2), dtype=jnp.int32))    # [g]
    return jnp.concatenate(outs, axis=-1)


@functools.partial(jax.jit, static_argnames=("per_packet",))
def _window_count(
    pat_words: jax.Array,   # uint32[U, K]
    pat_masks: jax.Array,   # uint32[U, K]
    pat_lens: jax.Array,    # int32[U]
    payloads: jax.Array,    # uint8[N, L]
    lengths: jax.Array,     # int32[N]
    per_packet: bool = False,
):
    return _window_one(pat_words, pat_masks, pat_lens, payloads, lengths, per_packet)


@functools.partial(jax.jit, static_argnames=("per_packet",))
def _window_count_tiles(
    pat_words, pat_masks, pat_lens, tiles, per_packet: bool = False
):
    """All length-bucketed tiles in ONE executable (one dispatch round-trip).

    ``tiles`` is a tuple of (payloads, lengths) pairs of differing static
    shapes.  Global counts sum across tiles; per-packet rows are returned
    per tile for the caller to scatter back.
    """
    outs = [
        _window_one(pat_words, pat_masks, pat_lens, p, l, per_packet)
        for p, l in tiles
    ]
    if per_packet:
        return tuple(outs)
    return functools.reduce(jnp.add, outs)


def count_matches_window(
    wp: WindowProgram,
    payloads,
    lengths,
    *,
    per_packet: bool = False,
    expand_duplicates: bool = True,
):
    """Counts via the shifted-window matcher (exact variant-A semantics)."""
    counts = _window_count(
        jnp.asarray(wp.pat_words),
        jnp.asarray(wp.pat_masks),
        jnp.asarray(wp.pat_lens),
        jnp.asarray(payloads, jnp.uint8),
        jnp.asarray(lengths, jnp.int32),
        per_packet=per_packet,
    )
    if expand_duplicates:
        counts = jnp.take(counts, jnp.asarray(wp.dup_map), axis=-1)
    return counts


@functools.partial(jax.jit, static_argnames=("g0", "g1"))
def _window_bitmap_group(pat_words, pat_masks, pat_lens, payloads, lengths, g0: int, g1: int):
    """Match bitmap acc[g, n, i] for one pattern group (offset extraction) —
    the same _word_views/_group_bitmap algebra the counting path reduces."""
    n, L = payloads.shape
    K = pat_words.shape[1]
    w32 = _word_views(payloads, K)
    positions = jax.lax.broadcasted_iota(jnp.int32, (n, L), 1)
    return _group_bitmap(
        pat_words, pat_masks, pat_lens, w32, lengths, positions, g0, g1
    )


def find_matches(wp: WindowProgram, payloads, lengths, *, group: int = GROUP):
    """Exact match OFFSETS: int64[K, 3] rows of (packet, start, unique_pattern).

    The reference only ever reports counts; offsets are the natural extra
    the position-parallel formulation provides (counts == len(rows) per
    pattern).  Streams pattern groups through a jitted bitmap kernel and
    nonzeros on the host — intended for inspection/forensics, not the
    counting hot path.
    """
    payloads = jnp.asarray(payloads, jnp.uint8)
    lengths = jnp.asarray(lengths, jnp.int32)
    U = wp.pat_words.shape[0]
    pw = jnp.asarray(wp.pat_words)
    pm = jnp.asarray(wp.pat_masks)
    pl = jnp.asarray(wp.pat_lens)
    rows = []
    for g0 in range(0, U, group):
        g1 = min(g0 + group, U)
        bitmap = np.asarray(
            _window_bitmap_group(pw, pm, pl, payloads, lengths, g0=g0, g1=g1)
        )
        g, n, i = np.nonzero(bitmap)
        if g.size:
            rows.append(np.stack([n, i, g + g0], axis=1))
    if not rows:
        return np.zeros((0, 3), dtype=np.int64)
    out = np.concatenate(rows, axis=0)
    return out[np.lexsort((out[:, 2], out[:, 1], out[:, 0]))]


class StreamHalo(NamedTuple):
    """Carried streaming state: the previous chunk's tail bytes plus how
    many of them are REAL stream bytes (the rest are the fabricated zeros
    the stream started with — matches must never begin inside those).
    ``fill`` is a scalar when every lane shares one stream position (the
    long-payload chunking shape) or an int32[N] vector when lanes carry
    independent histories (the per-FLOW streaming shape, where a revived
    flow sits next to a brand-new one in the same round)."""

    data: jax.Array  # uint8[N, H]
    fill: jax.Array  # int32 scalar or int32[N], 0 <= fill <= H


@jax.jit
def _window_chunk(pat_words, pat_masks, pat_lens, chunk, rel_len, halo, fill):
    H = halo.shape[1]
    C = chunk.shape[1]
    x = jnp.concatenate([halo, chunk], axis=1)            # [N, H+C]
    # Valid bytes: the halo plus whatever of the payload remains; capping at
    # the array width keeps match ends inside this chunk's real bytes.
    eff_len = jnp.minimum(jnp.clip(rel_len, 0, None) + H, H + C).astype(jnp.int32)
    # The first H - fill halo columns are fabricated zeros (shrinks to none
    # once H real bytes have streamed) — a NUL-containing pattern must not
    # start inside them, on ANY chunk.  Traced, so chunk 1..k share one
    # executable instead of recompiling per offset.  A VECTOR fill reshapes
    # to broadcast against the [g, n, L] position grid (per-lane zeros
    # boundary — the flow-stream case).
    ms = H - fill
    if getattr(ms, "ndim", 0):
        ms = ms.reshape(1, -1, 1)
    counts = _window_one(
        pat_words, pat_masks, pat_lens, x, eff_len,
        per_packet=False, min_end=H, min_start=ms,
    )
    return counts, x[:, -H:], jnp.minimum(fill + C, H)


def window_stream_chunk(
    wp: WindowProgram, chunk, rel_len, halo=None, *, expand_duplicates: bool = True
):
    """Scan one chunk of per-lane byte streams with a carried byte halo.

    ``rel_len``: remaining payload bytes from this chunk's first column
    (values > chunk width mean the payload continues; NEGATIVE values are a
    supported input meaning the lane's payload ended in an earlier chunk —
    callers pass raw ``lengths - start`` without clipping, and the fit masks
    treat any non-positive remainder as an empty lane).  ``halo=None`` marks
    the stream start.  Returns ``(counts, new_halo)`` where ``new_halo`` is
    an opaque :class:`StreamHalo` to thread into the next call; feeding
    consecutive chunks sums to exactly the unchunked counts, matches
    straddling chunk edges included (see _window_one for the assignment
    argument).  The halo carries its REAL-byte fill so fabricated stream-
    start zeros are excluded on every chunk, even when the chunk width is
    smaller than the halo (NUL-pattern exactness for any chunk size).
    """
    chunk = jnp.asarray(chunk, jnp.uint8)
    n = chunk.shape[0]
    H = max(int(wp.max_len) - 1, 1)
    if halo is None:
        halo_b, fill = jnp.zeros((n, H), jnp.uint8), jnp.int32(0)
    elif isinstance(halo, StreamHalo):
        halo_b, fill = halo.data, halo.fill
    else:
        # Legacy raw-array halo: the caller asserts all H bytes are real.
        halo_b, fill = jnp.asarray(halo, jnp.uint8), jnp.int32(H)
    counts, new_halo, new_fill = _window_chunk(
        jnp.asarray(wp.pat_words),
        jnp.asarray(wp.pat_masks),
        jnp.asarray(wp.pat_lens),
        chunk,
        jnp.asarray(rel_len, jnp.int32),
        halo_b,
        fill,
    )
    if expand_duplicates:
        counts = jnp.take(counts, jnp.asarray(wp.dup_map), axis=-1)
    return counts, StreamHalo(new_halo, new_fill)


def count_matches_window_tiles(
    wp: WindowProgram,
    tiles,
    *,
    per_packet: bool = False,
    expand_duplicates: bool = True,
):
    """Count over a tuple of device-resident (payloads, lengths) tiles with a
    single dispatch (see ops/bucketing.py for why tiles exist)."""
    if not tiles:
        if per_packet:
            return []
        n = len(wp.dup_map) if expand_duplicates else wp.pat_words.shape[0]
        return jnp.zeros((n,), jnp.int32)
    tiles = tuple((jnp.asarray(p, jnp.uint8), jnp.asarray(l, jnp.int32)) for p, l in tiles)
    out = _window_count_tiles(
        jnp.asarray(wp.pat_words),
        jnp.asarray(wp.pat_masks),
        jnp.asarray(wp.pat_lens),
        tiles,
        per_packet=per_packet,
    )
    if not expand_duplicates:
        return out
    dm = jnp.asarray(wp.dup_map)
    if per_packet:
        return tuple(jnp.take(o, dm, axis=-1) for o in out)
    return jnp.take(out, dm, axis=-1)
