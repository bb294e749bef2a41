"""Length-bucketed execution: don't pay padded-scan cost for short packets.

Payload lengths are heavy-tailed (very_big_udp.pcap: mean 96 B, max 328 B),
so a single padded [N, Lmax] launch wastes ~4x the real byte work.  Counting
is order-independent, so we sort packets by length (host-side, stable) and
form ONE tile per quantized width class — a handful of launches with padded
bytes tight against real bytes, and a small compiled-shape set (quantized
widths x geometrically-quantized row counts).

This is the reference's scheduling problem in tensor form: OpenMP guided
scheduling (openmp_data.c:128) exists to balance uneven per-packet work
across threads; here the imbalance is removed before launch instead.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def quantize_rows(n: int) -> int:
    """Row-count padding target: next power of two up to 1024, then the next
    multiple of 1024.  Keeps the set of compiled tile shapes logarithmic in
    corpus size while bounding padded-row waste (<2x small, <7% large)."""
    n = max(int(n), 8)
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return -(-n // 1024) * 1024


def bucket_plan(
    lengths: np.ndarray,
    n_tile: int = 2048,
    l_quant: int = 128,
    min_rows: Optional[int] = None,
) -> List[Tuple[np.ndarray, int]]:
    """Partition packets into (row_indices, tile_byte_len) tiles, one tile
    per quantized payload *width* class.

    Width classes (multiples of ``l_quant``) keep padded bytes tight against
    real bytes; one tile per class keeps the number of device dispatches at
    ~Lmax/l_quant instead of N/rows_per_tile, and so the per-dispatch
    launch cost paid per corpus.  Sparse wide classes are
    merged downward into the accumulating tile until it holds ``min_rows``
    (default ``n_tile // 4``) rows: scanning a few narrow rows at the wider
    width costs less than another launch.  Rows inside a tile stay sorted by
    descending length.
    """
    lengths = np.asarray(lengths)
    if min_rows is None:
        min_rows = max(1, n_tile // 4)
    merge_budget = 128 * 1024  # extra padded bytes a merge may cost (~a launch)
    order = np.argsort(-lengths, kind="stable")  # widest first
    widths = np.maximum(lengths[order], 1)
    widths = (-(-widths // l_quant) * l_quant).astype(np.int64)
    bounds = [0, *(np.flatnonzero(np.diff(widths)) + 1), len(order)]
    plan: List[Tuple[np.ndarray, int]] = []
    start = 0
    for b in range(1, len(bounds) - 1):
        stop = bounds[b]
        rows_next = bounds[b + 1] - stop
        waste = rows_next * (int(widths[start]) - int(widths[stop]))
        if stop - start >= min_rows or waste > merge_budget:
            plan.append((order[start:stop], int(widths[start])))
            start = stop
    if start < len(order):
        plan.append((order[start:], int(widths[start])))
    # Re-chunk oversized classes: n_tile stays the per-tile row bound so the
    # XLA window engine's [G, rows, L] intermediates keep a fixed memory
    # ceiling (a million-packet class must not become one million-row tile).
    bounded: List[Tuple[np.ndarray, int]] = []
    for idx, lt in plan:
        for s in range(0, len(idx), n_tile):
            bounded.append((idx[s : s + n_tile], lt))
    return bounded


def pack_rows(
    payloads: np.ndarray,
    lengths: np.ndarray,
    width: int = 2048,
    *,
    plan: Optional[Tuple[List[List[int]], List[int]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequence-pack payloads into fixed-width rows with a single 0x00
    separator byte between segments.

    The padding floor of per-packet rows is the 128-byte lane quantum (~1.6x
    real bytes on the bundled corpus); packing brings padded bytes to within
    a few percent of real bytes.  Exactness argument: patterns that contain
    no NUL byte cannot match a window that crosses a separator (one of its
    bytes is 0x00), and segments are never split across rows — so counts
    over packed rows equal counts over the original payloads.  Callers MUST
    reject NUL-containing patterns (api.Matcher.prepare does).

    Returns ``(packed uint8[R, width], fill int32[R])`` where ``fill`` is
    each row's used byte count (rows are zero beyond it, preserving the
    zero-padding invariant packing exactness relies on).

    Packing is two-pointer over length-sorted segments: each row starts with
    the largest remaining segment, then fills with the smallest ones that
    still fit — near-optimal for heavy-tailed packet corpora and O(n).
    """
    payloads = np.asarray(payloads)
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size:
        lmax = int(lengths.max())
        if lmax > width:
            raise ValueError(
                f"payload of {lmax} bytes exceeds pack width {width}"
            )
        # Guard BOTH paths: the native memcpy would read past the row
        # (heap garbage into scan tiles), the Python slice would raise a
        # cryptic broadcast error mid-pack.
        if lmax > payloads.shape[1]:
            raise ValueError(
                f"length {lmax} exceeds payload tensor width {payloads.shape[1]}"
            )
    from multithreading_string_matching.io import native

    if native.available():
        got = native.pack(payloads, lengths, width)
        if got is not None:
            return got
        return (
            np.zeros((1, width), dtype=np.uint8),
            np.zeros(1, dtype=np.int32),
        )
    # ``plan`` lets a caller that already ran pack_plan (e.g. the staging
    # policy decision) skip the duplicate argsort + two-pointer walk.
    rows, fills = plan if plan is not None else pack_plan(lengths, width)
    # Per-segment slice copies: measurably faster than any numpy
    # fancy-indexed scatter (contiguous memcpy per segment vs per-element
    # index arithmetic — 0.4 s vs 15 s on a 72 MB corpus).
    packed = np.zeros((max(len(rows), 1), width), dtype=np.uint8)
    for r, members in enumerate(rows):
        pos = 0
        for idx in members:
            ln = int(lengths[idx])
            if pos:
                pos += 1  # the separator byte is already 0
            packed[r, pos : pos + ln] = payloads[idx, :ln]
            pos += ln
    fill = np.asarray(fills if fills else [0], dtype=np.int32)
    return packed, fill


def pack_plan(
    lengths: np.ndarray, width: int
) -> Tuple[List[List[int]], List[int]]:
    """Row assignment for :func:`pack_rows` from lengths alone (no payload
    bytes touched) — lets callers evaluate packing efficiency before paying
    the materialization copy.  Returns ``(rows, fills)``."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size and int(lengths.max()) > width:
        raise ValueError(
            f"payload of {int(lengths.max())} bytes exceeds pack width {width}"
        )
    order = np.argsort(lengths, kind="stable")  # ascending
    order = order[lengths[order] > 0]
    rows: List[List[int]] = []
    fills: List[int] = []
    lo, hi = 0, len(order) - 1
    while lo <= hi:
        idx = order[hi]
        hi -= 1
        members = [int(idx)]
        fill = int(lengths[idx])
        while lo <= hi and fill + 1 + int(lengths[order[lo]]) <= width:
            members.append(int(order[lo]))
            fill += 1 + int(lengths[order[lo]])
            lo += 1
        rows.append(members)
        fills.append(fill)
    return rows, fills


def run_bucketed(
    count_fn: Callable,
    payloads: np.ndarray,
    lengths: np.ndarray,
    *,
    n_tile: int = 2048,
    l_quant: int = 128,
    per_packet: bool = False,
):
    """Apply ``count_fn(payloads_tile, lengths_tile, per_packet=...)`` per
    bucket and merge.  Global counts sum across tiles (exact, associative);
    per-packet rows are scattered back to input order.

    Tiles are dispatched without host synchronization in between, so the
    device pipeline stays full (the openmp_task.c overlap, for free).
    """
    payloads = np.asarray(payloads)
    lengths = np.asarray(lengths)
    plan = bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant)
    if not plan:
        # Zero-row batch: one dummy tile yields the correctly-shaped zeros
        # (global counts of nothing are zero; per-packet rows slice empty).
        out = np.asarray(
            count_fn(
                np.zeros((8, 8), np.uint8),
                np.zeros(8, np.int32),
                per_packet=per_packet,
            )
        )
        return out[:0] if per_packet else out
    total = None
    rows = []
    row_idx = []
    for idx, lt in plan:
        tile_p = payloads[idx, :lt]
        tile_l = lengths[idx]
        target = quantize_rows(tile_p.shape[0])  # padding rows mask out (len 0)
        if tile_p.shape[0] < target:
            pad = target - tile_p.shape[0]
            tile_p = np.pad(tile_p, ((0, pad), (0, 0)))
            tile_l = np.pad(tile_l, (0, pad))
        out = count_fn(tile_p, tile_l, per_packet=per_packet)
        if per_packet:
            rows.append(out)
            row_idx.append(idx)
        else:
            total = out if total is None else total + out
    if per_packet:
        first = np.asarray(rows[0])
        merged = np.zeros((len(lengths), first.shape[1]), dtype=first.dtype)
        for idx, out in zip(row_idx, rows):
            merged[idx] = np.asarray(out)[: len(idx)]
        return merged
    return total
