"""Batched producer/consumer pipeline (component C10, openmp_task.c analogue).

The reference's task program has one producer thread reading batches of 100
packets and extracting payloads inline, handing each batch to an OpenMP task
that matches it and atomically merges counts (openmp_task.c:126-186).

Shape here: the host is the producer (pcap walk + vectorized extract),
the device is the consumer.  JAX dispatch is asynchronous, so enqueueing each
batch's jitted scan WITHOUT blocking gives producer/consumer overlap for
free — while the device scans batch k, the host extracts batch k+1 (the
double-buffering the reference builds manually with task queues).  Count
merging is a device-side add of the per-batch count vectors — associative
and exact, so batch order cannot change results (unlike the reference's
atomic-merge, which is order-dependent only in timing, not value).

To keep one compiled executable across batches, payload tensors are padded
to a fixed batch size and a fixed power-of-two byte length per pipeline.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from multithreading_string_matching.io.pcap import PcapFile, iter_pcap, slice_pcap
from multithreading_string_matching.io.decode import extract_payloads
from multithreading_string_matching.ops.window import count_matches_window

DEFAULT_BATCH = 100  # openmp_task.c:113

# Drain device-side int32 accumulators to host int64 after this many scanned
# positions: one position contributes at most one match per pattern, so the
# int32 can never wrap between drains (2x margin).  Module-level so overflow
# tests can lower it without scanning 2 GiB.
DRAIN_POSITIONS = 2**30


def _iter_pcap_paths(pcap_path, batch_packets):
    """Stream chunks from one source or a sequence of them (rotated captures).

    A source is a path, ``"-"``, or an open binary file object (the
    ``tcpdump -w - |`` pipe shape) — anything with ``read`` is ONE source,
    not a sequence (iterating a file object would read it as lines)."""
    paths = (
        [pcap_path]
        if isinstance(pcap_path, (str, bytes, os.PathLike))
        or hasattr(pcap_path, "read")
        else list(pcap_path)
    )
    for p in paths:
        yield from iter_pcap(p, batch_packets=batch_packets)


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def _iter_extracted(
    pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
):
    """Yield (chunk, extracted_batch) pairs in capture order.

    ``host_workers >= 1`` runs ingest in a prefetch thread and extraction on
    an ordered worker pool (parallel.host) — the reference's producer/worker
    thread split (openmp_task.c:126-186) applied to the HOST stages, which
    all release the GIL in their hot paths (file reads, the native record
    walk, the native decode/fill).  Order is preserved: packet numbering and
    dump/offsets attribution depend on it.  0 = sequential (identical
    results either way — tested)."""
    chunks = _iter_pcap_paths(pcap_path, batch_packets)
    if host_workers:
        from multithreading_string_matching.parallel.host import (
            map_prefetch,
            prefetch_iter,
        )

        def ex(chunk):
            return chunk, extract_payloads(
                chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6
            )

        yield from map_prefetch(
            ex, prefetch_iter(chunks, depth=max(2, host_workers)),
            workers=host_workers,
        )
        return
    for chunk in chunks:
        yield chunk, extract_payloads(
            chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6
        )


def iter_batches(
    pcap: PcapFile,
    mode: str,
    batch_size: int,
    *,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    fixed_len: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield fixed-shape (payloads[B, Lfix], lengths[B]) batches.

    ``fixed_len=None`` buckets each batch's byte axis to the next power of
    two (few distinct compiled shapes); pass e.g. the snaplen for exactly one.
    """
    for start in range(0, pcap.num_packets, batch_size):
        part = slice_pcap(pcap, start, start + batch_size, copy=False)
        batch = extract_payloads(
            part, mode, strict=strict, vlan=vlan, ipv6=ipv6,
            keep_invalid=True, pad_n_to=batch_size,
        )
        payloads, lengths = batch.payloads, batch.lengths
        want = fixed_len or _next_pow2(payloads.shape[1])
        if payloads.shape[1] < want:
            payloads = np.pad(payloads, ((0, 0), (0, want - payloads.shape[1])))
        elif payloads.shape[1] > want:  # only when fixed_len undersized
            raise ValueError(
                f"payload length {payloads.shape[1]} exceeds fixed_len {want}"
            )
        yield payloads, lengths


def count_pcap_streamed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_packets: int = 8192,
    tile_rows: int = 4096,
    pack_width: int = 2048,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    engine: Optional[str] = None,
    stats: Optional[dict] = None,
    sharded: bool = False,
    mesh=None,
    shard_axis: str = "packets",
    sync_dispatch: bool = False,
    host_workers: int = 0,
) -> np.ndarray:
    """Production-rate streaming scan: bounded-memory ingest feeding the
    fast engine through ONE fixed compiled shape.

    ``host_workers >= 1`` threads the host stages (prefetched ingest +
    ordered parallel extract, see :func:`_iter_extracted`); counts are
    identical, only the schedule changes.

    ``engine`` defaults to the matcher's engine; every engine accepts the
    packed tiles (their automata all fail at the 0x00 separator, so counts
    are identical — tested).  Pass a dict as ``stats`` to receive packet /
    valid-payload / byte totals accumulated during ingest.

    The task pipeline (below) mirrors the reference's 100-packet batches and
    scans each batch at its own (pow2-bucketed) shape with the XLA window
    engine — faithful, but neither the batch size nor the engine is what the
    hardware wants.  This path is the serving shape: stream the capture
    (``iter_pcap``), sequence-pack payloads into ``[tile_rows, pack_width]``
    rows (0x00-separated — exact for NUL-free pattern sets, see
    ops/bucketing.pack_rows), and dispatch each full tile asynchronously to
    the matcher's engine.  One executable for the
    whole run, device-side count accumulation, one fetch at the end; peak
    host memory is one ingest batch + one tile regardless of capture size.

    Payloads wider than ``pack_width`` (can't pack) are routed per-chunk
    through the bucketed engine; NUL-containing pattern sets (packing
    inexact) fall back to :func:`scan_pcap_streamed` entirely.  Counts are
    bit-identical to the one-shot scan in every case (tested).

    ``sharded=True`` is the pod-scale serving shape: each packed tile's
    rows shard over the device ``mesh`` (default: all devices), the per-
    pattern merge is one psum per tile, and accumulation stays device-side
    — streamed ingest feeding every chip of a slice through one fixed
    executable.  (NUL-pattern sets can't pack and route through the
    per-row scanner instead — sharded over the same mesh.)

    ``shard_axis`` picks WHICH axis shards (with ``sharded=True``):
    ``'packets'`` (default — the classic data-parallel form),
    ``'patterns'`` (each device scans every tile with 1/N of the rule set —
    the large-rule-set form, parallel.pattern_shard), or ``'both'`` (2-D
    mesh).  Counts are bit-identical in every case.
    """
    if mesh is not None and not sharded:
        raise ValueError("mesh= is only meaningful with sharded=True")
    if shard_axis not in ("packets", "patterns", "both"):
        raise ValueError(f"unknown shard_axis {shard_axis!r}")
    if any(0 in p for p in matcher.window.unique_patterns):
        if sync_dispatch:
            # The blocking-schedule measurement mode only exists on the
            # packed-tile path; silently timing the per-row fallback would
            # report a fictitious "overlap gain".
            raise ValueError(
                "sync_dispatch requires the packed-tile path (NUL-free "
                "patterns); this set falls back to the per-row scanner"
            )
        # Packing is inexact for NUL-containing patterns; the per-row
        # streamed scanner is still bounded-memory and fills the caller's
        # stats (the pipelined path would silently drop them).  The sharded
        # flavor shards each chunk's rows over the mesh (exact fit masks —
        # no packing needed), so NUL sets keep pod-scale throughput too.
        return scan_pcap_streamed(
            matcher, pcap_path, mode,
            batch_packets=batch_packets,
            strict=strict, vlan=vlan, ipv6=ipv6, stats=stats,
            sharded=sharded, mesh=mesh, shard_axis=shard_axis,
            host_workers=host_workers,
        )
    counter = PackedTileCounter(
        matcher, engine=engine, tile_rows=tile_rows, pack_width=pack_width,
        sharded=sharded, mesh=mesh, shard_axis=shard_axis,
        sync_dispatch=sync_dispatch,
    )
    if stats is not None:
        # Observability: report the engine the counter ACTUALLY resolved
        # (incl. its sharded kmp->ac remap) so CLI blobs echo the truth
        # instead of re-deriving the remap rules.
        stats["engine_resolved"] = counter.engine
        if host_workers:
            stats["host_workers"] = host_workers
    n_packets = n_valid = n_bytes = 0
    for _chunk, batch in _iter_extracted(
        pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
    ):
        n_packets += batch.num_packets
        n_valid += int(batch.valid.sum())
        n_bytes += batch.total_payload_bytes
        counter.add(batch.payloads, batch.lengths)
    if stats is not None:
        stats.update(
            packets=n_packets, valid_payloads=n_valid, payload_bytes=n_bytes
        )
    counts = counter.totals()
    if counts.size and counts.max() > np.iinfo(np.int32).max:
        return counts  # beyond int32: return the exact int64 totals
    return counts.astype(np.int32)


class PackedTileCounter:
    """Fixed-shape packed-tile scan accumulator — the serving engine behind
    :func:`count_pcap_streamed` and the live ``StreamMatcher``'s packed mode.

    Feed ``(payloads, lengths)`` groups of any size through :meth:`add`;
    rows sequence-pack into ``[tile_rows, pack_width]`` tiles
    (ops/bucketing.pack_rows, 0x00-separated) and every FULL tile dispatches
    asynchronously through one fixed executable, so the per-dispatch cost
    amortizes over the tile no matter how small the feeds are — the
    property that lets a live capture loop (10-packet batches,
    live_openmp_task.c:142) run at the scan's rate instead of the dispatch
    rate.  Payloads wider than ``pack_width`` route through the
    bucketed one-shot engine; device int32 accumulators drain to host int64
    before they can wrap (DRAIN_POSITIONS).

    Count-exactness requires NUL-free patterns (callers guard; the argument
    is in pack_rows's docstring).  :meth:`totals` is safe to call repeatedly
    mid-stream: it flushes the partial tile, drains, and returns exact int64
    counts over the original pattern list.
    """

    def __init__(
        self,
        matcher,
        *,
        engine: Optional[str] = None,
        tile_rows: int = 4096,
        pack_width: int = 2048,
        sharded: bool = False,
        mesh=None,
        shard_axis: str = "packets",
        sync_dispatch: bool = False,
    ):
        # sync_dispatch=True blocks on every tile's counts before packing
        # the next — it DISABLES the producer/consumer overlap (host packs
        # tile k+1 while the device stages+scans tile k) that asynchronous
        # dispatch provides.  It exists so benches can MEASURE that overlap:
        # the async/sync end-to-end ratio is the pipelining gain.
        self._sync_dispatch = sync_dispatch
        self.matcher = matcher
        engine = matcher._resolve_engine(engine)
        if sharded and engine == "kmp":
            engine = "ac"  # per-pattern DFAs have no sharded path; AC is exact
        self.engine = engine
        self.sharded = sharded
        self.pack_width = pack_width
        self._engine_fn = matcher._engine_fn(engine)
        self._shard_fn = None
        self._pattern_plan = None
        if sharded and (
            shard_axis in ("patterns", "both")
            or (mesh is not None and "patterns" in mesh.axis_names)
        ):
            # PATTERN-axis sharding (parallel.pattern_shard): every device
            # scans the full packed tile with 1/N of the rule set; the
            # device accumulator stays in the sharded [n_sh*S] layout and
            # the drain's gather maps it back to build-order uniques.
            from multithreading_string_matching.parallel.pattern_shard import (
                make_tile_counter,
                resolve_shard_mesh,
            )

            mesh = mesh if mesh is not None else resolve_shard_mesh(shard_axis)
            if "packets" in mesh.axis_names:
                n_pkt = mesh.shape["packets"]
                tile_rows = -(-tile_rows // n_pkt) * n_pkt
            self._shard_fn, self._pattern_plan = make_tile_counter(
                matcher, mesh, engine
            )
            self.engine = engine = "window"
        elif sharded:
            # Multi-card serving: every packed tile's rows shard over the
            # device mesh, counts merge with one psum per tile and accumulate
            # device-side (UNIQUE-pattern counts; dup expansion happens after
            # the final drain).  Same fixed executable per tile as the
            # single-card path.
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            from multithreading_string_matching.parallel.mesh import (
                _sharded_count,
                _sharded_count_window,
                make_mesh,
            )

            mesh = mesh or make_mesh()
            axis = mesh.axis_names[0]
            n_dev = mesh.devices.size
            tile_rows = -(-tile_rows // n_dev) * n_dev  # shard rows evenly
            sharding = NamedSharding(mesh, P(axis))
            # Stage the pattern program ONCE — never re-upload in the
            # per-tile loop.
            if engine == "window":
                w = matcher.window
                pat_w = jnp.asarray(w.pat_words)
                pat_m = jnp.asarray(w.pat_masks)
                pat_l = jnp.asarray(w.pat_lens)

            def shard_fn(buf, fill):
                pay_d = jax.device_put(jnp.asarray(buf, jnp.uint8), sharding)
                len_d = jax.device_put(jnp.asarray(fill, jnp.int32), sharding)
                if engine == "window":
                    return _sharded_count_window(
                        pat_w, pat_m, pat_l, pay_d, len_d,
                        mesh=mesh, axis=axis,
                    )
                cac = matcher.cac
                return _sharded_count(
                    cac.goto_flat, cac.emit_ids, cac.emit_sub,
                    pay_d, len_d, dead=cac.dead, mesh=mesh, axis=axis,
                )

            self._shard_fn = shard_fn
        self.tile_rows = tile_rows
        self._buf = np.zeros((tile_rows, pack_width), dtype=np.uint8)
        self._fill = np.zeros(tile_rows, dtype=np.int32)
        self._r = 0
        self._total = None          # device-resident counts (int32)
        self._host_total = None     # int64 accumulator drained periodically
        self._tiles_since_drain = 0
        # One tile can contribute at most tile_rows*pack_width matches per
        # pattern; drain the device int32 accumulator to host int64 before
        # it can wrap (with margin).
        self._drain_every = max(
            1, DRAIN_POSITIONS // max(1, tile_rows * pack_width)
        )
        self._over_total = None     # host-side counts for oversized payloads
        self.tiles_dispatched = 0   # observability: dispatches, not feeds

    def reset(self):
        """Discard ALL accumulated state (counts, partial tile, oversized-
        row totals, dispatch count) — checkpoint restore replaces state, so
        the restoring caller must be able to zero this counter."""
        self._buf = np.zeros((self.tile_rows, self.pack_width), dtype=np.uint8)
        self._fill = np.zeros(self.tile_rows, dtype=np.int32)
        self._r = 0
        self._total = None
        self._host_total = None
        self._tiles_since_drain = 0
        self._over_total = None
        self.tiles_dispatched = 0

    def _drain(self):
        if self._total is None:
            return
        t = np.asarray(self._total).astype(np.int64)
        self._host_total = t if self._host_total is None else self._host_total + t
        self._total = None
        self._tiles_since_drain = 0

    def _dispatch(self):
        # Fresh host buffers each tile: the dispatch is asynchronous and
        # jnp.asarray may alias a numpy buffer (zero-copy on CPU backends),
        # so mutating the old tile after dispatch would corrupt the pending
        # computation.  That same freshness is what lets the host pack tile
        # k+1 while the device stages+scans tile k (producer/consumer
        # overlap with no explicit double buffering).
        buf, fill = self._buf, self._fill
        if self._shard_fn is not None:
            out = self._shard_fn(buf, fill)  # UNIQUE counts, replicated
        else:
            out = self._engine_fn(
                jnp.asarray(buf), jnp.asarray(fill), per_packet=False
            )
        self._total = out if self._total is None else self._total + out
        self.tiles_dispatched += 1
        self._tiles_since_drain += 1
        if self._sync_dispatch:
            # Fetch: serializes transfer, scan and dispatch with host-side
            # packing.
            self._drain()
        if self._tiles_since_drain >= self._drain_every:
            self._drain()  # one fetch per ~2^30 scanned positions: async
            # dispatch stays the common case, int32 wrap impossible
        self._buf = np.zeros((self.tile_rows, self.pack_width), dtype=np.uint8)
        self._fill = np.zeros(self.tile_rows, dtype=np.int32)
        self._r = 0

    def add(self, payloads, lengths):
        """Pack one feed's rows into the current tile, dispatching every
        tile that fills.  Any row count and byte width accepted."""
        from multithreading_string_matching.ops.bucketing import pack_rows

        # Case-insensitive matchers fold bytes before packing (idempotent,
        # so the oversized-payload detour through matcher.count is safe).
        payloads_m = self.matcher._maybe_fold(
            np.asarray(payloads, dtype=np.uint8)
        )
        lens = np.asarray(lengths).astype(np.int64)
        big = lens > self.pack_width
        if big.any():
            # Host int64 from the first add: int32 accumulation across many
            # oversized feeds could wrap long before totals() casts.
            over = np.asarray(self.matcher.count(
                payloads_m[big], lens[big], engine=self.engine
            )).astype(np.int64)
            self._over_total = (
                over if self._over_total is None else self._over_total + over
            )
            lens = np.where(big, 0, lens)
        rows_c, fill_c = pack_rows(payloads_m, lens, width=self.pack_width)
        if not fill_c.any():
            return
        i = 0
        while i < rows_c.shape[0]:
            take = min(self.tile_rows - self._r, rows_c.shape[0] - i)
            self._buf[self._r : self._r + take, : rows_c.shape[1]] = (
                rows_c[i : i + take]
            )
            self._fill[self._r : self._r + take] = fill_c[i : i + take]
            self._r += take
            i += take
            if self._r == self.tile_rows:
                self._dispatch()

    def flush(self):
        """Dispatch the partial tile (drain point: SIGINT, checkpoint)."""
        if self._r:
            self._dispatch()

    def totals(self) -> np.ndarray:
        """Exact int64 counts over the original pattern list, so far."""
        self.flush()
        self._drain()
        counts = (
            self._host_total
            if self._host_total is not None
            else np.zeros(len(self.matcher.patterns), dtype=np.int64)
        )
        if self.sharded and self._host_total is not None:
            if self._pattern_plan is not None:
                # Pattern-sharded accumulators live in the [n_sh*S] shard
                # layout; gather to build-order uniques, then dup-expand.
                counts = self._pattern_plan.gather(counts)[
                    self.matcher.window.dup_map
                ]
            else:
                # The sharded per-tile reducers return UNIQUE-pattern counts
                # (the collective payload stays minimal); expand here.
                dup = (
                    self.matcher.ac.dup_map
                    if self.engine == "ac"
                    else self.matcher.window.dup_map
                )
                counts = counts[dup]
        if self._over_total is not None:
            counts = counts + np.asarray(self._over_total).astype(np.int64)
        return counts


def scan_pcap_streamed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    dump_path=None,
    offsets: bool = False,
    batch_packets: int = 8192,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    stats: Optional[dict] = None,
    sharded: bool = False,
    mesh=None,
    shard_axis: str = "packets",
    host_workers: int = 0,
):
    """Bounded-memory scan with per-packet attribution: counts, plus
    optionally a matched-packet dump and/or exact match offsets.

    ``host_workers >= 1`` threads the host stages (prefetched ingest +
    ordered parallel extract) — attribution is order-dependent, and the
    ordered map preserves capture order exactly (tested).

    The packed serving path (:func:`count_pcap_streamed`) deliberately
    destroys row↔packet identity, so this variant runs each ingest chunk
    through the per-row (bucketed) kernel instead: per-packet counts give
    the aggregate totals (exact column sums — tested invariant) and the
    matched-packet selection, appended to ``dump_path`` incrementally via
    :class:`~..io.pcap.PcapWriter`.  ``offsets=True`` additionally collects
    (packet, start, unique_pattern) triples with ORIGINAL capture packet
    numbers, global across chunks and input files — the numbering a user
    sees in wireshark, and consistent with the dump.  Peak host memory is
    one ingest chunk + one [chunk, P] count matrix (+ the offsets found).

    ``sharded=True`` makes attribution multi-card: each chunk's rows shard
    over the device ``mesh`` through the per-row kernel (counts stay with
    their rows — no collective), shapes quantized to powers of two so the
    whole run reuses a handful of executables.  Match POSITIONS are then
    extracted only from the (typically sparse) rows the sharded scan
    flagged — the heavy full-corpus scan is what the mesh parallelizes.
    Works for any pattern set, NUL-containing included (the per-row kernel
    carries exact fit masks).  The ac/kmp engines remap to the window
    family here (identical counts; attribution is window-native).

    Returns ``counts`` or ``(counts, offsets)`` when ``offsets=True``;
    ``stats`` (if given) receives packet/byte totals plus
    ``dumped_packets`` when dumping.
    """
    from multithreading_string_matching.io.pcap import PcapWriter

    if mesh is not None and not sharded:
        raise ValueError("mesh= is only meaningful with sharded=True")
    # The two-phase per-row scan when sharded: the mesh counts EVERY row,
    # and find_matches (window engine) then touches only the flagged rows —
    # so requesting positions/dumps never demotes the heavy full-corpus
    # pass to one device.
    row_fn = None
    pattern_sharded = sharded and (
        shard_axis in ("patterns", "both")
        or (mesh is not None and "patterns" in mesh.axis_names)
    )
    if sharded:
        if pattern_sharded:
            from multithreading_string_matching.parallel.pattern_shard import (
                resolve_shard_mesh,
            )

            mesh = mesh if mesh is not None else resolve_shard_mesh(shard_axis)
        else:
            from multithreading_string_matching.parallel.mesh import (
                make_mesh,
            )

            mesh = mesh or make_mesh()
        from multithreading_string_matching.parallel.mesh import (
            count_rows_summary,
        )

        if pattern_sharded:
            # Rows only need padding to the PACKET axis of the mesh (a
            # pattern-only mesh replicates payloads — no row constraint).
            n_dev = (
                mesh.shape["packets"] if "packets" in mesh.axis_names else 1
            )
        else:
            n_dev = mesh.devices.size
        if stats is not None:
            stats["engine_resolved"] = "window"

        def row_fn(payloads, lengths):
            # ONE quantization rule for both mesh flavors: pow2 rows x pow2
            # width (padding rows are length-0, zero bytes), so a long
            # stream reuses O(log) compiled shapes instead of one per
            # chunk geometry.  The per-row counts REDUCE ON DEVICE
            # (count_*_summary): only the unique totals [U] and the per-row
            # hit flags [n] come back over the host link, not the [n, U]
            # matrix — ~300x less d2h at the default chunk shape, and the
            # hit rows are re-scanned host-side only when positions are
            # requested.
            n, L = payloads.shape
            lq = max(128, _next_pow2(L))
            nq = -(-max(n_dev, _next_pow2(n)) // n_dev) * n_dev
            payloads = np.pad(payloads, ((0, nq - n), (0, lq - L)))
            lengths = np.pad(lengths, (0, nq - n))
            if pattern_sharded:
                from multithreading_string_matching.parallel.pattern_shard import (
                    count_rows_summary_pattern_sharded,
                )

                tot, hits = count_rows_summary_pattern_sharded(
                    matcher, payloads, lengths, mesh
                )
                return tot, np.asarray(hits)[:n]
            # count_rows_summary slices internally for the device int32
            # bound.
            tot, hits = count_rows_summary(matcher, payloads, lengths, mesh)
            return tot, np.asarray(hits)[:n]

    if stats is not None and row_fn is None:
        # Only the offsets branch is window-native (find_matches); the
        # dump/plain per-row branch runs count_batch with the matcher's
        # resolved engine — report what will ACTUALLY execute.
        stats["engine_resolved"] = (
            "window" if offsets else matcher._resolve_engine(None)
        )
    if stats is not None and host_workers:
        stats["host_workers"] = host_workers
    total = None
    n_packets = n_valid = n_bytes = 0
    found = [] if offsets else None
    w = PcapWriter(dump_path) if dump_path is not None else None
    try:
        for chunk, batch in _iter_extracted(
            pcap_path, mode, batch_packets, strict, vlan, ipv6, host_workers
        ):
            packet_base = n_packets
            n_packets += batch.num_packets
            n_valid += int(batch.valid.sum())
            n_bytes += batch.total_payload_bytes
            valid_idx = np.flatnonzero(batch.valid)
            if valid_idx.size == 0:
                if w is not None:
                    # Still lock the writer's header to THIS capture's
                    # linktype/resolution (an all-invalid capture must not
                    # dump with guessed metadata).
                    w.write(chunk, valid_idx)
                continue
            if row_fn is not None:
                # Per-row scan sharded over the mesh, reduced device-side;
                # attribution follows from the
                # totals + hit flags, positions (if wanted) from the hit
                # rows only.
                uniq_tot, hits = row_fn(batch.payloads, batch.lengths)
                chunk_counts = uniq_tot[matcher.window.dup_map]
                total = chunk_counts + (0 if total is None else total)
                row_hits = hits[: valid_idx.size]
                if w is not None:
                    w.write(chunk, valid_idx[row_hits])
                if found is not None and row_hits.any():
                    hit = np.flatnonzero(row_hits)
                    rows = np.asarray(
                        matcher.find_matches(
                            batch.payloads[hit], batch.lengths[hit]
                        )
                    )
                    if rows.size:
                        rows = rows.copy()
                        rows[:, 0] = packet_base + valid_idx[hit[rows[:, 0]]]
                        found.append(rows)
                continue
            if found is not None:
                # One scan serves all three outputs: the occurrence rows ARE
                # the counts (bincount over unique patterns, expanded via
                # dup_map) and the dump selection (rows with any hit).
                rows = np.asarray(
                    matcher.find_matches(batch.payloads, batch.lengths)
                )
                chunk_counts = matcher.counts_from_match_rows(rows)
                total = chunk_counts + (0 if total is None else total)
                if w is not None:
                    hit_rows = (
                        np.unique(rows[:, 0]) if rows.size
                        else np.zeros(0, np.int64)
                    )
                    hit_rows = hit_rows[hit_rows < valid_idx.size]
                    w.write(chunk, valid_idx[hit_rows])
                if rows.size:
                    rows = rows.copy()
                    # Original capture packet numbers, global across chunks.
                    rows[:, 0] = packet_base + valid_idx[rows[:, 0]]
                    found.append(rows)
            else:
                per_row = np.asarray(
                    matcher.count_batch(batch, per_packet=True)
                )
                total = per_row.sum(axis=0, dtype=np.int64) + (
                    0 if total is None else total
                )
                if w is not None:
                    row_hits = per_row[: valid_idx.size].sum(axis=1) > 0
                    w.write(chunk, valid_idx[row_hits])
    finally:
        if w is not None:
            w.close()
    if stats is not None:
        stats.update(
            packets=n_packets, valid_payloads=n_valid, payload_bytes=n_bytes,
        )
        if w is not None:
            stats["dumped_packets"] = w.packets_written
    if total is None:
        counts = np.zeros(len(matcher.patterns), dtype=np.int32)
    elif total.size and total.max() > np.iinfo(np.int32).max:
        counts = total  # beyond int32: exact int64 (mirror count_pcap_streamed)
    else:
        counts = total.astype(np.int32)
    if offsets:
        all_rows = (
            np.concatenate(found, axis=0)
            if found
            else np.zeros((0, 3), dtype=np.int64)
        )
        return counts, all_rows
    return counts


def dump_matches_streamed(
    matcher,
    pcap_path,
    out_path,
    mode: str = "udp",
    **kw,
) -> np.ndarray:
    """Bounded-memory scan that re-emits every matching packet
    (:func:`scan_pcap_streamed` with ``dump_path`` fixed)."""
    return scan_pcap_streamed(matcher, pcap_path, mode, dump_path=out_path, **kw)


def count_pcap_pipelined(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_size: int = DEFAULT_BATCH,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    host_workers: int = 0,
) -> np.ndarray:
    """Full-file counting through the batched pipeline; counts are identical
    to the one-shot scan (tested), only the execution schedule differs.

    Ingest is streamed (``io.pcap.iter_pcap``), exactly as the reference's
    producer pulls packets from libpcap incrementally instead of loading the
    capture first (openmp_task.c:131-156) — so captures larger than host RAM
    flow through with bounded residency (one batch + one read buffer).

    ``host_workers >= 1`` threads the read/extract host stages exactly like
    count_pcap_streamed does (parallel.host: prefetch + ordered worker
    pool) — this is what the reference's ``num_threads(thread_count)``
    sizes (openmp_task.c:128), so the compat ``task`` subcommand's
    positional thread count drives it.  Order preserved, counts identical
    (tested).

    The batch kernel is the XLA window engine (each reference task runs
    the same full-speed matcher as serial, openmp_task.c:171-183); pow2
    width bucketing keeps the compiled-shape count logarithmic."""
    total = None          # device-resident int32 accumulator
    host_total = None     # int64 accumulator drained periodically
    pos_since_drain = 0   # scanned positions bound the per-pattern growth

    def drain():
        nonlocal total, host_total, pos_since_drain
        if total is None:
            return
        t = np.asarray(total).astype(np.int64)
        host_total = t if host_total is None else host_total + t
        total = None
        pos_since_drain = 0

    chunks = _iter_pcap_paths(pcap_path, batch_size)

    def _extract(chunk):
        return list(iter_batches(
            chunk, mode, batch_size, strict=strict, vlan=vlan, ipv6=ipv6
        ))

    if host_workers:
        from multithreading_string_matching.parallel.host import (
            map_prefetch,
            prefetch_iter,
        )

        batch_lists = map_prefetch(
            _extract, prefetch_iter(chunks, depth=max(2, host_workers)),
            workers=host_workers,
        )
    else:
        batch_lists = (_extract(c) for c in chunks)

    for batches in batch_lists:
        for payloads, lengths in batches:
            # Async dispatch: does NOT block — device consumes batch k while
            # the host (producer) reads + extracts batch k+1.
            counts = count_matches_window(
                matcher.window,
                jnp.asarray(matcher._maybe_fold(payloads)),
                jnp.asarray(lengths),
            )
            total = counts if total is None else total + counts
            # A batch contributes at most rows*cols matches per pattern;
            # drain the int32 device accumulator to host int64 before it can
            # wrap (same rule as count_pcap_streamed's drain_every).
            pos_since_drain += payloads.shape[0] * payloads.shape[1]
            if pos_since_drain >= DRAIN_POSITIONS:
                drain()
    drain()
    if host_total is None:
        return np.zeros(len(matcher.patterns), dtype=np.int32)
    if host_total.size and host_total.max() > np.iinfo(np.int32).max:
        return host_total  # beyond int32: exact int64 totals
    return host_total.astype(np.int32)
