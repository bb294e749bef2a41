"""Streaming matcher (component C11, live_openmp_task.c analogue).

The reference's live program pulls packets one at a time from a live capture,
buffers batches of 10, spawns a matching task per full batch, and on SIGINT
drains the partial batch serially, then prints totals
(live_openmp_task.c:160-241).

Shape here: a :class:`StreamMatcher` accumulates counts device-side
over an unbounded sequence of packet batches (whole packets per batch, as in
the reference — KMP state never needs to carry across batches because batch
boundaries are packet boundaries, live_openmp_task.c per-call kmp_matcher).
For the true long-context case — a payload longer than one scan window —
:meth:`feed_batch` chunks the byte axis internally with carried state (a
byte halo for the window engine, DFA states for AC) so straddling matches
count exactly once (SURVEY §5).

Graceful shutdown: :meth:`install_sigint` sets a flag exactly like the
reference's signalHandler (live_openmp_task.c:262-264); the driving loop
checks :attr:`stopped`, drains, and reports.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from multithreading_string_matching.io.decode import extract_payloads
from multithreading_string_matching.io.pcap import PcapFile
from multithreading_string_matching.ops.scan import count_matches_ac


def patterns_npz_fields(patterns) -> dict:
    """Pattern list as npz-safe arrays: a byte blob + lengths, NOT a
    unicode array — numpy 'U' arrays silently strip trailing NULs, which
    would fail the load-time identity check for a b"ab\\x00" pattern.
    Shared by StreamMatcher and FlowStreamMatcher checkpoints so the
    format cannot drift between them."""
    return {
        "pattern_blob": np.frombuffer(b"".join(patterns), np.uint8),
        "pattern_lens": np.array([len(p) for p in patterns], np.int64),
    }


def patterns_from_npz(data) -> list:
    """Inverse of :func:`patterns_npz_fields`; accepts pre-round-5
    checkpoints (unicode 'patterns' array — NUL-free sets only)."""
    if "pattern_blob" in data:
        blob = data["pattern_blob"].tobytes()
        pats, pos = [], 0
        for ln in data["pattern_lens"]:
            pats.append(blob[pos : pos + int(ln)])
            pos += int(ln)
        return pats
    return [p.encode("latin-1") for p in data["patterns"].tolist()]


def checkpoint_path(path) -> str:
    """np.savez appends .npz to extension-less paths; normalize for load
    (accept the same path save() was called with)."""
    path = str(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path

DEFAULT_BATCH = 10  # live_openmp_task.c:142


class StreamMatcher:
    """Engine 'window' (default): whole-packet batches via the shifted-window
    matcher; long payloads chunked with a carried byte halo.  Engine 'ac':
    the Aho-Corasick path with carried DFA states — same counts.

    ``packed`` ('auto' default) is the scan-rate serving shape: feeds
    accumulate into fixed ``[tile_rows, pack_width]`` sequence-packed tiles
    (parallel.pipeline.PackedTileCounter) and ONE dispatch per full tile
    runs the matcher's fast engine — so a live loop fed 10-packet batches
    (live_openmp_task.c:142) amortizes the per-dispatch round-trip ~100x
    instead of paying it per batch.  Counts are bit-identical; the partial
    tile flushes on :meth:`counts` (report, SIGINT drain, checkpoint).
    'auto' enables packing whenever the pattern set is NUL-free (packing is
    inexact otherwise — same rule as count_pcap_streamed); ``packed=True``
    on NUL patterns raises."""

    def __init__(
        self,
        matcher,
        batch_size: int = DEFAULT_BATCH,
        fixed_len: int = 2048,
        engine: str = "window",
        dump_writer=None,
        packed="auto",
        tile_rows: int = 1024,
        pack_width: int = 2048,
        sharded: bool = False,
        mesh=None,
    ):
        self.matcher = matcher
        self.batch_size = batch_size
        self.fixed_len = fixed_len
        if engine not in ("window", "ac"):
            # A typo must not silently run the window path (same rule as
            # Matcher._resolve_engine); only these two have carried-state
            # long-payload flavors.
            raise ValueError(
                f"unknown stream engine {engine!r}: expected window or ac"
            )
        self.engine = engine
        # Optional io.pcap.PcapWriter: batches fed through feed_pcap_slice
        # also append their MATCHING packets (original records) to it — the
        # live-capture analogue of `match --dump-matches`.
        self.dump_writer = dump_writer
        if mesh is not None and not sharded:
            # Same guard as count_pcap_streamed: a dropped mesh= would
            # silently run every tile on one device.
            raise ValueError("mesh= is only meaningful with sharded=True")
        # Tile config persists so reload() re-arms identically for a new set.
        self._packed = packed
        self._tile_rows = tile_rows
        self._pack_width = pack_width
        self._sharded = sharded
        self._mesh = mesh
        self._tiles = self._build_tiles(matcher)
        self._counts: Optional[jax.Array] = None
        # Host int64 base: restored checkpoints land here (jnp.asarray would
        # silently downcast int64 counts to int32 — wraparound on resume),
        # and the device int32 accumulator drains here before IT can wrap.
        self._host_counts: Optional[np.ndarray] = None
        self._pos_since_drain = 0
        # Packed-mode dump attribution is batched the same way counting is:
        # pend slices until ~dump_scan_rows rows, then ONE per-row scan
        # serves them all (a per-slice scan would reinstate the per-batch
        # dispatch round-trip that packed mode exists to amortize).
        self._dump_pending = []  # (pcap_slice, src_idx, payloads, lengths)
        self._dump_pending_rows = 0
        self.dump_scan_rows = 1024
        self.packets_seen = 0
        self.stopped = False
        self._old_handler = None

    def _build_tiles(self, matcher):
        """Validate the packed/sharded rules for ``matcher`` and build its
        tile counter (or None for the unpacked path).  Shared by __init__
        and :meth:`reload` so the two cannot diverge on the rules."""
        nul_free = not any(0 in p for p in matcher.window.unique_patterns)
        if self._packed is True and not nul_free:
            raise ValueError(
                "packed tiles require NUL-free patterns (sequence packing "
                "is inexact otherwise); use packed='auto' or False"
            )
        if self._sharded and not (
            self._packed is True or (self._packed == "auto" and nul_free)
        ):
            raise ValueError(
                "sharded live streaming rides the packed tiles; it needs "
                "packed=True/'auto' and a NUL-free pattern set"
            )
        if self._packed is True or (self._packed == "auto" and nul_free):
            from multithreading_string_matching.parallel.pipeline import (
                PackedTileCounter,
            )

            # engine=None: the tile path exists to run the matcher's FAST
            # engine — the ctor `engine` arg only steers the
            # carried-state long-payload fallback, which stays exact.
            # sharded=True scans each full tile across the mesh (a live
            # monitor on a multi-chip host keeps every chip busy).
            return PackedTileCounter(
                matcher, engine=None, tile_rows=self._tile_rows,
                pack_width=self._pack_width, sharded=self._sharded,
                mesh=self._mesh,
            )
        return None

    def reload(self, matcher) -> np.ndarray:
        """Swap the pattern set mid-stream — the IDS rule-update shape.

        Drains everything pending under the CURRENT set (partial packed
        tile, batched dump scans, device accumulator) and returns its final
        counts, then re-arms every accumulator for ``matcher``.  The
        source, ``packets_seen``, the SIGINT handler, and the dump writer
        all persist — the tap stays open across a rule update, and the
        dump file keeps appending under the new rules.  Batch boundaries
        are packet boundaries (no matcher state is carried between
        batches — SURVEY §5), so the swap is exact.

        Validation runs BEFORE any mutation: a reload that violates the
        packed/sharded rules (e.g. NUL patterns under packed=True) raises
        and leaves the stream untouched and usable.
        """
        tiles = self._build_tiles(matcher)
        final = self.counts()  # flushes dump scans + the partial tile
        self.matcher = matcher
        self._tiles = tiles
        self._counts = None
        self._host_counts = None
        self._pos_since_drain = 0
        self._dump_pending = []
        self._dump_pending_rows = 0
        return final

    # -- lifecycle ---------------------------------------------------------

    def install_sigint(self, on_stop=None):
        """SIGINT sets a drain flag (live_openmp_task.c:156-158,262-264).

        ``on_stop`` (e.g. ``LiveSource.stop``) also fires from the handler:
        a blocking capture loop on a QUIET interface never yields a batch,
        so a flag checked only between batches would never be seen — the
        source itself must stop iterating for the drain to happen."""

        def handler(signum, frame):
            self.stopped = True
            if on_stop is not None:
                on_stop()

        self._old_handler = signal.signal(signal.SIGINT, handler)

    def uninstall_sigint(self):
        if self._old_handler is not None:
            signal.signal(signal.SIGINT, self._old_handler)
            self._old_handler = None

    # -- whole-packet batches (the reference's streaming shape) -------------

    def _drain_counts(self):
        """Drain the device int32 accumulator to the host int64 base (same
        rule as PackedTileCounter: one fetch per ~2^30 scanned positions, so
        the int32 can never wrap between drains)."""
        if self._counts is not None:
            t = np.asarray(self._counts).astype(np.int64)
            self._host_counts = (
                t if self._host_counts is None else self._host_counts + t
            )
            self._counts = None
        self._pos_since_drain = 0

    def _note_positions(self, pos: int):
        from multithreading_string_matching.parallel.pipeline import (
            DRAIN_POSITIONS,
        )

        self._pos_since_drain += pos
        if self._pos_since_drain >= DRAIN_POSITIONS:
            self._drain_counts()

    def feed_batch(self, payloads: np.ndarray, lengths: np.ndarray):
        """Accumulate counts for one batch of whole packets (async dispatch)."""
        if self._tiles is not None:
            # Packed serving shape: rows accumulate host-side and dispatch
            # once per FULL tile (oversized rows detour internally) — the
            # batch size stops mattering to throughput.
            payloads = np.asarray(payloads, dtype=np.uint8)
            self.packets_seen += payloads.shape[0]
            self._tiles.add(payloads, np.asarray(lengths))
            return
        # The dispatch below is asynchronous and jnp.asarray may alias a
        # numpy buffer (zero-copy on CPU backends) — when asarray, fold and
        # the pad branches all no-op, the caller's buffer would be read by
        # an in-flight count after this method returns (the fresh-buffer
        # rule PackedTileCounter._dispatch documents).  Copy unless the
        # working array OWNS fresh memory: `is src` catches asarray's
        # ndarray pass-through, `base is not None` catches views over any
        # buffer-protocol input (memoryview/bytearray included).
        src_p, src_l = payloads, lengths
        payloads = self.matcher._maybe_fold(np.asarray(payloads, dtype=np.uint8))
        if payloads is src_p or payloads.base is not None:
            payloads = payloads.copy()
        lengths = np.asarray(lengths, dtype=np.int32)
        if lengths is src_l or lengths.base is not None:
            lengths = lengths.copy()
        self.packets_seen += payloads.shape[0]
        if payloads.shape[1] < self.fixed_len:
            payloads = np.pad(
                payloads, ((0, 0), (0, self.fixed_len - payloads.shape[1]))
            )
        elif payloads.shape[1] > self.fixed_len:
            # Longer-than-window payloads stream through the carried-state path.
            self._feed_long(payloads, lengths)
            return
        n0 = payloads.shape[0]
        n_pad = -(-n0 // self.batch_size) * self.batch_size
        if n_pad != n0:
            payloads = np.pad(payloads, ((0, n_pad - n0), (0, 0)))
            lengths = np.pad(lengths, (0, n_pad - n0))
        if self.engine == "ac":
            counts = count_matches_ac(
                self.matcher.cac,
                jnp.asarray(payloads),
                jnp.asarray(lengths),
                dup_map=self.matcher.ac.dup_map,
            )
        else:
            from multithreading_string_matching.ops.window import (
                count_matches_window,
            )

            counts = count_matches_window(
                self.matcher.window, payloads, lengths
            )
        self._counts = counts if self._counts is None else self._counts + counts
        self._note_positions(payloads.shape[0] * payloads.shape[1])

    def _feed_long(self, payloads: np.ndarray, lengths: np.ndarray):
        """Chunk the byte axis with carried state (straddle-correct): a byte
        halo for the window engine, DFA states for the AC engine."""
        n, L = payloads.shape
        if self.engine == "ac":
            states = jnp.zeros((n,), dtype=jnp.int32)
            for start in range(0, L, self.fixed_len):
                chunk = payloads[:, start : start + self.fixed_len]
                if chunk.shape[1] < self.fixed_len:
                    chunk = np.pad(
                        chunk, ((0, 0), (0, self.fixed_len - chunk.shape[1]))
                    )
                rel = np.clip(lengths - start, 0, None).astype(np.int32)
                counts, states = count_matches_ac(
                    self.matcher.cac,
                    jnp.asarray(chunk),
                    jnp.asarray(rel),
                    initial_states=states,
                    dup_map=self.matcher.ac.dup_map,
                    return_states=True,
                )
                self._counts = (
                    counts if self._counts is None else self._counts + counts
                )
                self._note_positions(n * self.fixed_len)
            return
        from multithreading_string_matching.ops.window import window_stream_chunk

        halo = None
        for start in range(0, L, self.fixed_len):
            chunk = payloads[:, start : start + self.fixed_len]
            if chunk.shape[1] < self.fixed_len:
                chunk = np.pad(chunk, ((0, 0), (0, self.fixed_len - chunk.shape[1])))
            rel = (lengths - start).astype(np.int32)
            counts, halo = window_stream_chunk(
                self.matcher.window, chunk, rel, halo
            )
            self._counts = counts if self._counts is None else self._counts + counts
            self._note_positions(n * self.fixed_len)

    def feed_pcap_slice(
        self, pcap: PcapFile, mode: str = "udp", *, bpf_filter: bool = False
    ):
        """``bpf_filter=True`` reproduces the live program's capture-filter
        semantics (live_openmp_task.c:127): only protocol-matching packets
        enter the stream at all, so ``packets_seen`` counts what the BPF
        filter passed — not everything the wire carried.

        Count caveat, faithful to the reference: in udp mode counts are
        identical either way (the extraction predicate already requires
        proto==17).  In tcp COMPAT mode the extractor has no protocol check
        (packet_dumping.h:150-188), so an unfiltered scan can count matches
        inside non-TCP packets that the filter excludes — exactly how the
        reference's BPF-filtered live program can differ from its own
        serial program on quirky captures."""
        batch = extract_payloads(pcap, mode, keep_invalid=True)
        src_idx = np.arange(pcap.num_packets, dtype=np.int64)
        # extract_payloads pads to >=1 row even for an EMPTY slice; rows
        # beyond num_packets are padding — they must not enter packets_seen
        # and the bpf mask (exactly num_packets entries) must not index them.
        payloads = batch.payloads[: src_idx.size]
        lengths = batch.lengths[: src_idx.size]
        if bpf_filter:
            from multithreading_string_matching.io.decode import (
                bpf_protocol_mask,
            )

            mask = bpf_protocol_mask(pcap, mode)
            payloads, lengths = payloads[mask], lengths[mask]
            src_idx = src_idx[mask]
        if self.dump_writer is not None:
            if payloads.shape[0] and self._tiles is not None:
                # keep_invalid=True means rows ARE the slice's packets (in
                # order), so per-row attribution maps straight back to
                # records.  Batched: pend the slice, scan once per
                # ~dump_scan_rows (one dispatch instead of one per batch).
                self._dump_pending.append((pcap, src_idx, payloads, lengths))
                self._dump_pending_rows += payloads.shape[0]
                if self._dump_pending_rows >= self.dump_scan_rows:
                    self._flush_dump()
            elif payloads.shape[0]:
                per_row = np.asarray(
                    self.matcher.count(payloads, lengths, per_packet=True)
                )
                hits = per_row[: src_idx.size].sum(axis=1) > 0
                self.dump_writer.write(pcap, src_idx[hits])
            else:
                # Lock the header to the capture's metadata even when the
                # slice produced no scannable payloads.
                self.dump_writer.write(pcap, src_idx[:0])
        if payloads.shape[0]:
            self.feed_batch(payloads, lengths)

    # -- checkpoint / resume -------------------------------------------------
    # The reference's live program loses all counts on a hard kill
    # (live_openmp_task.c prints only after graceful SIGINT).  Streams here
    # can checkpoint between batches and resume exactly.

    def save(self, path) -> str:
        np.savez(
            path,
            counts=self.counts(),
            packets_seen=np.int64(self.packets_seen),
            **patterns_npz_fields(self.matcher.patterns),
        )
        # np.savez appends .npz to extension-less paths; return the real one.
        path = str(path)
        return path if path.endswith(".npz") else path + ".npz"

    def load(self, path):
        data = np.load(checkpoint_path(path), allow_pickle=False)
        if patterns_from_npz(data) != self.matcher.patterns:
            raise ValueError("checkpoint pattern list does not match matcher")
        # Restore into the HOST int64 base: jnp.asarray would silently
        # downcast int64 checkpoint counts to int32 (wraparound on resume),
        # defeating the exact-int64 guarantee counts() provides.  load()
        # REPLACES stream state (checkpoint counts already include every
        # accumulator at save() time), so ALL of them reset — leaving the
        # tile totals or pending dump slices would double-count a rollback
        # onto a used instance.
        self._counts = None
        self._pos_since_drain = 0
        self._dump_pending = []
        self._dump_pending_rows = 0
        if self._tiles is not None:
            self._tiles.reset()
        self._host_counts = np.asarray(data["counts"]).astype(np.int64)
        self.packets_seen = int(data["packets_seen"])

    # -- results -----------------------------------------------------------

    def _flush_dump(self):
        """One per-row scan over all pending slices, hits written in feed
        order — the batched flavor of the per-slice dump attribution."""
        if not self._dump_pending:
            return
        pend, self._dump_pending = self._dump_pending, []
        self._dump_pending_rows = 0
        lmax = max(p.shape[1] for _, _, p, _ in pend)
        rows = sum(p.shape[0] for _, _, p, _ in pend)
        pays = np.zeros((rows, lmax), dtype=np.uint8)
        lens = np.zeros(rows, dtype=np.int32)
        r = 0
        for _, _, p, l in pend:
            pays[r : r + p.shape[0], : p.shape[1]] = p
            lens[r : r + p.shape[0]] = l
            r += p.shape[0]
        per_row = np.asarray(self.matcher.count(pays, lens, per_packet=True))
        r = 0
        for pcap, src_idx, p, _ in pend:
            hits = per_row[r : r + p.shape[0]][: src_idx.size].sum(axis=1) > 0
            self.dump_writer.write(pcap, src_idx[hits])
            r += p.shape[0]

    def flush(self):
        """Flush pending work — the batched dump scan and the partial
        packed tile.  Call before closing a dump writer; counts() also
        flushes."""
        self._flush_dump()
        if self._tiles is not None:
            self._tiles.flush()

    def counts(self) -> np.ndarray:
        """Synchronize and return counts over the original pattern list
        (flushes the packed partial tile and any pending dump scan first;
        exact int64 past int32)."""
        self._flush_dump()
        total = np.zeros(len(self.matcher.patterns), dtype=np.int64)
        if self._host_counts is not None:
            total = total + self._host_counts
        if self._counts is not None:
            total = total + np.asarray(self._counts).astype(np.int64)
        if self._tiles is not None:
            total = total + self._tiles.totals()
        if total.size and total.max() > np.iinfo(np.int32).max:
            return total  # beyond int32: exact int64 (reference wraps here)
        return total.astype(np.int32)

    @property
    def tiles_dispatched(self) -> int:
        """Packed-mode dispatch count (0 when unpacked) — the amortization
        observable: tiles, not batches."""
        return self._tiles.tiles_dispatched if self._tiles is not None else 0
