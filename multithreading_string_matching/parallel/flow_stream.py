"""Flow-aware streaming: per-TCP-flow carried DFA state across feeds.

`parallel.stream.StreamMatcher` counts per PACKET (the reference's model,
live_openmp_task.c) — a signature split across two segments of one
connection is invisible to it.  :class:`FlowStreamMatcher` keeps one
Aho-Corasick DFA state per flow: segments append to small per-flow pending
buffers, and each scan round lays active flows out as LANES of a
``[flows, width]`` tile fed through ``Matcher.count_chunk`` (the carried-
state AC scan, ops/scan.py) — the DFA step is a monoid action, so chunked
per-flow scans compose exactly and a match split across ANY boundary
(segment, feed, scan round) counts once, equal to the concatenated-flow
oracle (tested).

Memory model: pending bytes are bounded by ``scan_bytes`` (a round fires
when they exceed it, or at :meth:`flush`); the per-flow residue is one
int32 DFA state, so long-lived connections cost 4 bytes between rounds.
State eviction (idle timeout, FIN/RST tracking) is deployment policy and
out of scope — ``evict(keys)`` lets the caller apply one.

Lane layout quantizes (pow2 flows x fixed width) so a long capture reuses
O(log) compiled shapes, the same rule the packed-tile serving path uses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from multithreading_string_matching.io.flows import flow_keys


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << max(0, (x - 1).bit_length()))


class FlowStreamMatcher:
    # One scan round's padded host buffer budget; past it the round
    # falls back to bounded per-chunk tiles (pathological skew: one
    # huge flow padding every lane).  Class-level so tests can lower
    # it without streaming 64 MB.
    ROUND_BUDGET_BYTES = 64 << 20

    def __init__(
        self,
        matcher,
        mode: str = "tcp",
        *,
        engine: str = "ac",
        scan_bytes: int = 1 << 20,
        width: int = 2048,
        min_lanes: int = 128,
        sharded: bool = False,
        mesh=None,
        reorder: bool = False,
        ipv6: bool = False,
        vlan: bool = False,
        max_flows: Optional[int] = None,
        idle_rounds: Optional[int] = None,
        fin_evict: bool = False,
        collect_offsets: bool = False,
    ):
        self.matcher = matcher
        if mode not in ("udp", "tcp"):
            raise ValueError(f"mode must be 'udp' or 'tcp', got {mode!r}")
        if reorder and mode != "tcp":
            raise ValueError("reorder=True applies to TCP flows only")
        if fin_evict and mode != "tcp":
            # tcp_flags would read a PAYLOAD byte at the TCP-flags offset
            # on UDP datagrams — random data would close flows.
            raise ValueError("fin_evict=True applies to TCP flows only")
        # reorder=True: pending segments carry their TCP seq and each scan
        # round materializes them in SEQUENCE order with first-bytes-win
        # trimming (io.flows.reorder_plan's rule).  BOUND, documented: the
        # reorder window is ONE scan round (~scan_bytes of stream) — a
        # segment whose bytes were already scanned in an earlier round is
        # trimmed to its new bytes (dropped if pure retransmission), it
        # cannot be re-inserted before bytes the DFA already consumed.
        self.reorder = reorder
        self._flow_reorder: dict = {}  # key -> (seq_base int, covered int)
        # ipv6=True switches to the 37-byte version-tagged key space
        # (io.flows.flow_keys) so v4 and v6 conversations stream side by
        # side; evict()/save()/load() keys are in the same space.
        self.ipv6 = ipv6
        # vlan=True skips up to two stacked 802.1Q/802.1ad tags per packet
        # on every header read (keys, seqs, flags) — per-packet l2 shifts
        # via io.decode's own tag walk; the VLAN ID is not part of the key.
        self.vlan = vlan
        if engine not in ("ac", "window"):
            # Only these two have carried-state forms: the AC DFA carries
            # one int per flow; the window engine carries an (max_len - 1)-
            # byte halo per flow and scans at compare-chain rate (~30-100x
            # the gather-bound DFA — the high-rate flow-serving path).
            # Both shard (round 5): AC lanes carry device state with their
            # shard; window lanes carry HOST tail bytes, so sharded rounds
            # are stateless on device (mesh.count_flow_round_sharded).
            raise ValueError(
                f"unknown flow-stream engine {engine!r}: expected ac or window"
            )
        self.engine = engine
        self.mode = mode
        self.scan_bytes = scan_bytes
        self.width = width
        self.min_lanes = min_lanes
        if mesh is not None and not sharded:
            raise ValueError("mesh= is only meaningful with sharded=True")
        self.sharded = sharded
        if sharded:
            # Flow lanes shard over the mesh (pod-scale flow monitoring):
            # each scan round's tile splits by lane, states stay with their
            # shard across rounds, one [E]-histogram psum per chunk
            # (parallel.mesh.count_chunk_sharded).  Lane quantization must
            # cover the device count so shards are even.
            from multithreading_string_matching.parallel.mesh import (
                make_mesh,
            )

            self.mesh = mesh if mesh is not None else make_mesh()
            self._n_dev = int(np.prod(tuple(self.mesh.shape.values())))
            self.min_lanes = max(min_lanes, self._n_dev)
        else:
            self.mesh = None
            self._n_dev = 1
        self._states: dict = {}      # ac: key -> int DFA state;
                                     # window: key -> (tail bytes, fill int)
        self._pending: dict = {}     # key bytes -> bytearray (insertion order)
        self._pending_bytes = 0
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        # Device accumulator: single-dispatch window rounds leave their [U]
        # unique counts ON DEVICE across rounds (dispatch stays async; a
        # per-round fetch would block the host once per scan_bytes of
        # stream) and drain to host int64 before the int32 can wrap
        # (< 2^30 scanned positions between drains).
        self._dev_counts = None
        self._dev_expanded = False   # False: unique order, dup-expand at drain
        self._dev_pos = 0
        self.packets_seen = 0        # valid flow segments fed
        self.bytes_seen = 0
        # Built-in eviction policy (round 5): ``max_flows`` caps tracked
        # flows (oldest-activity first past the cap), ``idle_rounds`` drops
        # flows with no new bytes for that many scan rounds, ``fin_evict``
        # drops a flow after a FIN or RST is observed on it (and its bytes
        # scanned).  All run AFTER each scan round — pending bytes are
        # always scanned before their flow's state is dropped, so eviction
        # only ever FORGETS carried state (exactly evict()'s semantics),
        # it never loses counted bytes.
        if max_flows is not None and max_flows < 1:
            raise ValueError("max_flows must be >= 1")
        self.max_flows = max_flows
        self.idle_rounds = idle_rounds
        self.fin_evict = fin_evict
        self._round = 0              # scan rounds completed
        self._last_active: dict = {} # key -> round index of last fed bytes
        self._closing: set = set()   # FIN/RST-observed keys
        self.flows_evicted = 0
        # Streamed attribution (round-5 continuation): each scan round
        # ALSO runs one find_matches pass over [tail | new bytes] rows and
        # keeps (key, stream_offset, unique_pattern) triples for matches
        # whose END falls in the new bytes — the same (min_start, min_end)
        # algebra the halo count scan uses, so the triples bincount to
        # exactly the round's count delta.  Offsets are byte positions in
        # the flow's REASSEMBLED stream (reorder included); an evicted
        # flow that reappears restarts at 0, matching revival semantics.
        # Window engine only: the find pass needs the byte tail that only
        # the window layout carries.
        if collect_offsets and engine != "window":
            raise ValueError(
                "collect_offsets=True needs engine='window' (the find "
                "pass reads the per-flow byte tail)"
            )
        # sharded=True composes: the find pass is host-driven and
        # independent of how the COUNT rounds shard their lanes.
        self.collect_offsets = collect_offsets
        self._flow_base: dict = {}   # key -> stream bytes already scanned
        self._offsets: list = []     # undrained (key, offset, unique) hits

    @property
    def flows_seen(self) -> int:
        return len(self._states) + sum(
            1 for k in self._pending if k not in self._states
        )

    def feed_pcap_slice(self, pcap) -> None:
        """Append each valid segment's payload to its flow's pending buffer
        (capture order — the same reassembly contract as io.flows; with
        ``reorder`` the segment's TCP seq rides along and ordering happens
        at scan time)."""
        from multithreading_string_matching.io.flows import _flow_geom

        # One per-packet geometry pass (VLAN tag walk + IHL reads) shared
        # by keys/seqs/flags — re-walking it per helper tripled the
        # vectorized host work on this ingest hot path.
        geom = _flow_geom(pcap, self.ipv6, self.vlan)
        valid, keys, off, ln = flow_keys(pcap, self.mode, ipv6=self.ipv6,
                                         vlan=self.vlan, _geom=geom)
        seqs = flags = None
        if self.reorder:
            from multithreading_string_matching.io.flows import tcp_seqs

            seqs = tcp_seqs(pcap, valid, ipv6=self.ipv6, vlan=self.vlan,
                            _geom=geom)
        if self.fin_evict:
            from multithreading_string_matching.io.flows import tcp_flags

            flags = tcp_flags(pcap, ipv6=self.ipv6, vlan=self.vlan,
                              _geom=geom)
        buf = pcap.buf
        for pkt in np.flatnonzero(valid):
            n = int(ln[pkt])
            self.packets_seen += 1
            k = None
            if flags is not None and flags[pkt] & 0x05:  # FIN | RST
                # Flag observation happens even on empty segments (a bare
                # FIN/ACK carries no payload) — the flow closes after its
                # pending bytes are scanned.
                k = keys[pkt].tobytes()
                self._closing.add(k)
            if not n:
                continue
            if k is None:
                k = keys[pkt].tobytes()
            s = int(pcap.offsets[pkt] + off[pkt])
            if seqs is not None:
                self._pending.setdefault(k, []).append(
                    (int(seqs[pkt]), bytes(buf[s : s + n]))
                )
            else:
                self._pending.setdefault(k, bytearray()).extend(buf[s : s + n])
            self._pending_bytes += n
            self.bytes_seen += n
            self._last_active[k] = self._round
        if self._pending_bytes >= self.scan_bytes:
            self._scan()

    def _materialize_reorder(self) -> None:
        """Convert each flow's pending (seq, bytes) segments to the flat
        byte form the scan lanes consume: sequence order, first-bytes-win
        trimming against this flow's carried coverage (the same rule as
        io.flows.reorder_plan, applied within the round window)."""
        for k, segs in list(self._pending.items()):
            if not isinstance(segs, list):
                continue
            raw = sum(len(b) for _, b in segs)
            st = self._flow_reorder.get(k)
            if st is None:
                s0 = segs[0][0]
                rels = [((sq - s0 + 2**31) % 2**32 - 2**31) for sq, _ in segs]
                base = s0 + min(rels)
            else:
                base, covered = st
            if st is None:
                covered = 0
            rels = [((sq - base + 2**31) % 2**32 - 2**31) for sq, _ in segs]
            order = sorted(range(len(segs)), key=lambda i: (rels[i], i))
            out = bytearray()
            for i in order:
                r, b = rels[i], segs[i][1]
                end = r + len(b)  # BEFORE trimming — the trim shortens b,
                # and coverage must advance to the segment's true end
                if end <= covered:
                    continue  # pure retransmission of scanned bytes
                if r < covered:
                    b = b[covered - r :]  # overlap: first bytes won
                out += b
                covered = max(covered, end)
            # Re-base the carried coverage to the new edge: rel values
            # stay near 0 for in-order traffic however long the flow lives
            # (a fixed base would exhaust the signed +/-2^31 window after
            # 2 GiB and silently drop everything as retransmission).  A
            # stale segment older than the edge lands at negative rel ->
            # end <= 0 = covered -> dropped, same semantics.
            self._flow_reorder[k] = ((base + covered) % 2**32, 0)
            self._pending_bytes += len(out) - raw
            self._pending[k] = out

    def _scan(self) -> None:
        had_bytes = self._pending_bytes > 0
        self._scan_impl()
        if had_bytes:
            self._round += 1
            self._apply_eviction()

    def _apply_eviction(self) -> None:
        """Post-round policy: FIN/RST closes, idle-age expiry, max-flows
        cap — all on flows whose pending bytes were just scanned."""
        def drop(doomed):
            # Count only flows whose tracked state is actually dropped: a
            # bare FIN on a never-payload flow (or a retransmitted FIN on
            # an already-evicted one) must not inflate the stat.
            self.flows_evicted += sum(1 for k in doomed if k in self._states)
            self.evict(doomed)

        if self._closing:
            doomed = [k for k in self._closing if k not in self._pending]
            drop(doomed)
            self._closing.difference_update(doomed)
        if self.idle_rounds is not None:
            # STRICTLY more than idle_rounds fully idle rounds: a flow that
            # fed bytes in the round just scanned has age exactly 1 after
            # the post-scan increment — >= would evict continuously-active
            # flows every round at idle_rounds=1.
            doomed = [
                k for k, r in self._last_active.items()
                if self._round - r > self.idle_rounds
                and k not in self._pending
            ]
            drop(doomed)
        if self.max_flows is not None and len(self._states) > self.max_flows:
            by_age = sorted(
                self._states,
                key=lambda k: self._last_active.get(k, -1),
            )
            drop(by_age[: len(self._states) - self.max_flows])

    # Find-pass column stride (new bytes per slice): bounds the offsets
    # matrix for skewed rounds; H context columns overlap between slices.
    OFFSET_CHUNK = 1 << 20

    def _collect_round_offsets(self, flows) -> None:
        """One find_matches pass over ``[tail | new bytes]`` rows, keeping
        matches whose END falls in the new bytes and whose START is at or
        past the fabricated-zero boundary — the count kernels' own
        (min_start, min_end) algebra, so the kept triples bincount to
        exactly this round's count delta.  Offsets are positions in the
        flow's reassembled stream (``base + row_start - H``)."""
        if not flows:
            return
        wp = self.matcher.window
        H = max(int(wp.max_len) - 1, 1)
        # The stride must cover the halo: past the first chunk min_start
        # is 0 on the assumption that all H context columns are REAL bytes
        # — true iff c >= S >= H keeps the fabricated-zero region (< H)
        # strictly below every later chunk's context window.
        S = max(self.OFFSET_CHUNK, H)
        ulens = np.array([len(p) for p in wp.unique_patterns], np.int64)
        rows_src = []
        fills = np.zeros(len(flows), np.int64)
        for i, k in enumerate(flows):
            tail, fl = self._states.get(k, (b"", 0))
            # Stored tails hold exactly ``fl`` real bytes; fabricated
            # zeros pad the context to a fixed H columns (min_start drops
            # anything starting inside them).
            rows_src.append(b"\x00" * (H - fl) + bytes(tail) + bytes(self._pending[k]))
            fills[i] = fl
        longest_new = max(len(r) - H for r in rows_src)
        for c in range(0, longest_new, S):
            sl = [r[c : c + H + S] for r in rows_src]
            lens_l = np.array([len(s) for s in sl], np.int32)
            # Quantize BOTH axes (pow2 rows, pow2 columns) so a long
            # stream reuses O(log) compiled find executables — the same
            # rule as the count path's lane layout; exact shapes would
            # recompile nearly every round.  Padding rows are length 0 and the column
            # pad is zeros past each row's length — neither can match.
            R = _pow2(len(sl), self.min_lanes)
            Lq = 1 << max(0, (int(lens_l.max()) - 1).bit_length())
            mat = np.zeros((R, Lq), np.uint8)
            lens = np.zeros(R, np.int32)
            lens[: len(sl)] = lens_l
            for i, s in enumerate(sl):
                mat[i, : len(s)] = np.frombuffer(s, np.uint8)
            rows = np.asarray(self.matcher.find_matches(mat, lens))
            for fi, st, u in rows:
                fi, st, u = int(fi), int(st), int(u)
                min_start = (H - int(fills[fi])) if c == 0 else 0
                if st < min_start or st + int(ulens[u]) <= H:
                    continue
                base = self._flow_base.get(flows[fi], 0)
                self._offsets.append((flows[fi], base + c + st - H, u))
        for k in flows:
            self._flow_base[k] = (
                self._flow_base.get(k, 0) + len(self._pending[k])
            )

    def drain_offsets(self):
        """Return (and clear) the accumulated ``(key_bytes, stream_offset,
        unique_pattern_idx)`` triples — ``collect_offsets=True`` mode's
        output.  Offsets index the flow's reassembled stream; render keys
        with :func:`io.flows.key_tuple_bytes`, pattern bytes live in
        ``matcher.window.unique_patterns``."""
        out = self._offsets
        self._offsets = []
        return out

    def _scan_impl(self) -> None:
        if not self._pending_bytes:
            self._pending.clear()
            return
        if self.reorder:
            self._materialize_reorder()
            if not self._pending_bytes:  # everything was retransmission
                self._pending.clear()
                return
        flows = [k for k, b in self._pending.items() if b]
        if self.collect_offsets:
            # BEFORE any tail/pending mutation: the find pass reads the
            # pre-round tails next to the pending bytes.
            self._collect_round_offsets(flows)
        F = _pow2(len(flows), self.min_lanes)
        # The sharded scan splits the lane axis over the mesh: round lanes
        # up to a device-count multiple (a non-pow2 min_lanes or device
        # count would otherwise leave shard_map an uneven split).
        F = -(-F // self._n_dev) * self._n_dev
        if self.engine == "window":
            wp = self.matcher.window
            H = max(int(wp.max_len) - 1, 1)
            halo_b = np.zeros((F, H), np.uint8)
            fill_v = np.zeros(F, np.int32)
            for i, k in enumerate(flows):
                tail, fl = self._states.get(k, (b"", 0))
                if fl:
                    # Real tail bytes sit RIGHT-ALIGNED in the halo buffer
                    # (the fabricated-zero columns shrink from the front) —
                    # the same layout _window_chunk's x[:, -H:] carry uses.
                    halo_b[i, H - fl:] = np.frombuffer(tail, np.uint8)
                    fill_v[i] = fl
            # (the device StreamHalo is built lazily below — only the
            # chunk-loop fallback consumes it, and uploading F x H bytes
            # per round on the single-dispatch hot path would be waste)
            halo = None
        else:
            states = np.zeros(F, np.int32)
            for i, k in enumerate(flows):
                states[i] = self._states.get(k, 0)
            states_v = self.matcher.streaming_state(F) + states
        lens_arr = np.array([len(self._pending[k]) for k in flows], np.int64)
        longest = int(lens_arr.max())
        long_q = -(-longest // self.width) * self.width
        rel_all = np.zeros(F, np.int64)
        rel_all[: len(flows)] = lens_arr
        if self.engine == "window":
            # The whole round in ONE dispatch.  The chunk loop below exists
            # to bound per-dispatch width, but each of its iterations is a
            # dispatch of its own — for the common case (round buffer under
            # the memory budget) scan the padded [F, long_q] buffer in one
            # halo-masked pass instead, lane-sharded over the mesh when
            # asked.  Widths quantize to powers of two so a long
            # stream reuses O(log) compiled shapes.
            round_q = max(
                self.width, 1 << max(0, (longest - 1).bit_length())
            )
            # Per-LAUNCH int32 bound: the sub-lane tile scans
            # ~F * nch_pow2 * (H + width) positions in ONE dispatch, and a
            # position starts at most one match per pattern — past 2^31
            # the dispatch's own int32 accumulator could wrap before the
            # drain guard ever sees it (the drain only bounds accumulation
            # BETWEEN dispatches).  Oversized rounds take the chunk loop,
            # whose own device_acc gate handles the same bound per chunk.
            nch_p = _pow2(max(1, -(-round_q // self.width)), 1)
            proj_positions = (F + 512) * nch_p * (
                max(int(self.matcher.window.max_len) - 1, 1) + self.width
            )
            if (
                F * round_q <= max(self.ROUND_BUDGET_BYTES, F * self.width)
                and proj_positions < 2**31
            ):
                buf = np.zeros((F, round_q), np.uint8)
                for i, k in enumerate(flows):
                    b = self._pending[k]
                    buf[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
                counts_u = self._window_round(
                    buf, rel_all.astype(np.int32), halo_b, fill_v
                )
                self._acc_device(
                    counts_u, expanded=False,
                    positions=self._round_positions,
                )
                for i, k in enumerate(flows):
                    prev_tail, prev_fill = self._states.get(k, (b"", 0))
                    combined = prev_tail + bytes(self._pending[k])
                    self._states[k] = (
                        combined[-H:],
                        min(H, prev_fill + len(self._pending[k])),
                    )
                self._pending.clear()
                self._pending_bytes = 0
                return
        # ONE padded round buffer, chunked by column slices: one host copy
        # per flow per round instead of one per flow per CHUNK (the old
        # inner loop dominated sustained rate).  Guard against pathological
        # skew (one huge flow padding every lane): past the budget, fall
        # back to the per-chunk build with bounded memory.
        padded = None
        if F * long_q <= max(self.ROUND_BUDGET_BYTES, F * self.width):
            padded = np.zeros((F, long_q), np.uint8)
            for i, k in enumerate(flows):
                b = self._pending[k]
                padded[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
        # Device-resident count accumulation, ONE fetch per round instead
        # of a blocking fetch per chunk (same rule as the packed-tile
        # serving path).  Only safe on the padded path AND
        # under the int32 position bound: the fallback path reuses a
        # mutable tile (async dispatch would read the next chunk's bytes —
        # the CLAUDE.md aliasing trap) and can scan unbounded positions, so
        # it drains to host int64 per chunk instead.
        device_acc = padded is not None and F * long_q < 2**31
        round_counts = None
        if self.engine == "window" and halo is None:
            import jax.numpy as jnp

            from multithreading_string_matching.ops.window import (
                StreamHalo,
            )

            # Stored tails are RAW capture bytes; fold here so nocase
            # matchers see folded halos next to folded chunks (folding is
            # idempotent, so the tile's own fold cannot double-apply).
            halo = StreamHalo(
                jnp.asarray(self.matcher._maybe_fold(halo_b)),
                jnp.asarray(fill_v),
            )
        for c in range(0, longest, self.width):
            if padded is not None:
                tile = padded[:, c : c + self.width]
            else:
                tile = np.zeros((F, self.width), np.uint8)  # FRESH per chunk
                for i, k in enumerate(flows):
                    seg = self._pending[k][c : c + self.width]
                    tile[i, : len(seg)] = np.frombuffer(bytes(seg), np.uint8)
            if self.engine == "window":
                from multithreading_string_matching.ops.window import (
                    window_stream_chunk,
                )

                counts, halo = window_stream_chunk(
                    self.matcher.window, self.matcher._maybe_fold(tile),
                    (rel_all - c).astype(np.int32), halo,
                )
            elif self.sharded:
                from multithreading_string_matching.parallel.mesh import (
                    count_chunk_sharded,
                )

                rel = np.clip(rel_all - c, 0, self.width).astype(np.int32)
                counts, states_v = count_chunk_sharded(
                    self.matcher.cac,
                    self.matcher._maybe_fold(tile), rel, states_v,
                    self.mesh, dup_map=self.matcher.ac.dup_map,
                )
            else:
                from multithreading_string_matching.ops.scan import (
                    count_matches_ac,
                )

                # Direct lazy scan (Matcher.count_chunk fetches its counts
                # eagerly — that round-trip per chunk is what the device
                # accumulator exists to avoid).
                rel = np.clip(rel_all - c, 0, self.width).astype(np.int32)
                counts, states_v = count_matches_ac(
                    self.matcher.cac, self.matcher._maybe_fold(tile), rel,
                    initial_states=states_v,
                    dup_map=self.matcher.ac.dup_map, return_states=True,
                )
            if device_acc:
                round_counts = (
                    counts if round_counts is None else round_counts + counts
                )
            else:
                self._counts += np.asarray(counts, dtype=np.int64)
        if round_counts is not None:
            self._counts += np.asarray(round_counts, dtype=np.int64)
        if self.engine == "window":
            # Store each flow's tail from the HOST bytes, not the device
            # carry: a lane whose pending ends mid-chunk gets zero PADDING
            # bytes in the returned halo (harmless within the round —
            # min_end masks them — but fatal for revival).  The real tail
            # is simply the last H bytes the flow has ever streamed.
            for i, k in enumerate(flows):
                prev_tail, prev_fill = self._states.get(k, (b"", 0))
                combined = prev_tail + bytes(self._pending[k])
                self._states[k] = (
                    combined[-H:], min(H, prev_fill + len(self._pending[k]))
                )
        else:
            final = np.asarray(states_v)
            for i, k in enumerate(flows):
                self._states[k] = int(final[i])
        self._pending.clear()
        self._pending_bytes = 0

    def _expand_round_lanes(self, buf, rel, halo_b, fill_v, CW: int):
        """Re-lay a ``[F, W]`` round as SUB-LANES of fixed width:
        ``([R, H + CW] tile, eff int32[R], ms int32[R])`` where flow i's
        chunk j is row i*nch+j, carrying the H columns preceding its body
        as halo context (overlapping views — one strided copy).  A match
        counts in the sub-lane its END falls in (the halo scan's
        min_end = H rule), so the tall tile's total equals the flat round's
        — and the scan always sees ONE narrow compiled width with full
        row parallelism, instead of one wide row per flow."""
        F, W = buf.shape
        wp = self.matcher.window
        H = max(int(wp.max_len) - 1, 1)
        # pow2 sub-lane count: rounds of any length reuse O(log) compiled
        # [F*nch, H+CW] shapes (padding sub-lanes are all-zero, eff 0).
        nch = _pow2(max(1, -(-W // CW)), 1)
        x = np.zeros((F, H + nch * CW), np.uint8)
        x[:, :H] = halo_b
        x[:, H : H + W] = buf
        s0, s1 = x.strides
        sub = np.lib.stride_tricks.as_strided(
            x, shape=(F, nch, H + CW), strides=(s0, CW * s1, s1)
        )
        x2 = np.ascontiguousarray(sub).reshape(F * nch, H + CW)
        i = np.repeat(np.arange(F), nch)
        j = np.tile(np.arange(nch), F)
        eff_abs = np.minimum(
            np.clip(rel, 0, None).astype(np.int64) + H, H + W
        )
        eff2 = np.clip(eff_abs[i] - j * CW, 0, H + CW).astype(np.int32)
        ms_abs = (H - fill_v).astype(np.int64)
        ms2 = np.clip(ms_abs[i] - j * CW, 0, None).astype(np.int32)
        return x2, eff2, ms2

    def _window_round(self, buf, rel, halo_b, fill_v):
        """ONE device dispatch for a whole window-engine scan round:
        returns DEVICE counts in build-order UNIQUE layout (dup expansion
        happens at drain).  Lane-sharded over the mesh when
        ``sharded=True``: wide rounds re-lay as fixed-width sub-lanes
        (_expand_round_lanes), so the shards split one compiled width."""
        fold = self.matcher._maybe_fold
        self._round_positions = buf.shape[0] * (
            buf.shape[1] + halo_b.shape[1]
        )
        if self.sharded:
            x2, eff2, ms2 = self._expand_round_lanes(
                fold(buf), rel, fold(halo_b), fill_v, self.width
            )
            # The drain guard must bound the ACTUAL positions scanned: the
            # sub-lane tile (pow2 nch + halo duplication) can exceed the
            # flat round's F*(W+H) by >2x, which would let the device int32
            # accumulator wrap between drains.
            self._round_positions = x2.shape[0] * x2.shape[1]
            from multithreading_string_matching.parallel.mesh import (
                count_flow_round_sharded,
            )

            return count_flow_round_sharded(
                self.matcher, x2, eff2, ms2, self.mesh
            )
        from multithreading_string_matching.ops.window import (
            StreamHalo,
            window_stream_chunk,
        )

        import jax.numpy as jnp

        counts, _ = window_stream_chunk(
            self.matcher.window, fold(buf), rel,
            StreamHalo(jnp.asarray(fold(halo_b)), jnp.asarray(fill_v)),
            expand_duplicates=False,
        )
        return counts

    def _acc_device(self, counts, *, expanded: bool, positions: int) -> None:
        self._dev_counts = (
            counts if self._dev_counts is None else self._dev_counts + counts
        )
        self._dev_expanded = expanded
        self._dev_pos += positions
        if self._dev_pos >= 2**30:
            self._drain_device()  # int32 wrap impossible between drains

    def _drain_device(self) -> None:
        if self._dev_counts is None:
            return
        c = np.asarray(self._dev_counts).astype(np.int64)
        if not self._dev_expanded:
            c = c[self.matcher.window.dup_map]
        self._counts += c
        self._dev_counts = None
        self._dev_pos = 0

    def flush(self) -> None:
        """Scan whatever is pending (end-of-capture / timer tick)."""
        self._scan()

    def counts(self) -> np.ndarray:
        """Totals over the ORIGINAL pattern list (duplicates expanded),
        int64, NOT including unflushed pending bytes."""
        self._drain_device()
        return self._counts.copy()

    # -- checkpoint / resume (round 5) -------------------------------------

    def _key_width(self) -> int:
        from multithreading_string_matching.io.flows import (
            V4_KEY_BYTES,
            V6_KEY_BYTES,
        )

        return V6_KEY_BYTES if self.ipv6 else V4_KEY_BYTES

    def save(self, path) -> str:
        """Checkpoint EVERYTHING the stream carries — counts, per-flow
        engine state (DFA ints / window tails), pending bytes (reorder
        segment lists included), reorder coverage, eviction bookkeeping —
        so a killed process resumes to counts identical to the
        uninterrupted run (full-rollback semantics, the flow flavor of
        StreamMatcher.save).  allow_pickle=False-safe layout: keys as
        fixed-width uint8 rows, variable-length byte payloads as one blob
        plus offset/length columns."""
        self._drain_device()
        kw = self._key_width()

        def key_rows(ks):
            out = np.zeros((len(ks), kw), np.uint8)
            for i, k in enumerate(ks):
                out[i] = np.frombuffer(k, np.uint8)
            return out

        from multithreading_string_matching.parallel.stream import (
            patterns_npz_fields,
        )

        state_keys = list(self._states)
        data = {
            **patterns_npz_fields(self.matcher.patterns),
            "engine": np.array(self.engine),
            "mode": np.array(self.mode),
            "flags": np.array(
                [int(self.reorder), int(self.ipv6), int(self.vlan),
                 int(self.collect_offsets)],
                np.int64,
            ),
            "counts": self._counts,
            "counters": np.array(
                [self.packets_seen, self.bytes_seen, self._round,
                 self.flows_evicted, self._pending_bytes], np.int64
            ),
            "state_keys": key_rows(state_keys),
        }
        if self.engine == "ac":
            data["state_vals"] = np.array(
                [self._states[k] for k in state_keys], np.int32
            )
        else:
            H = max(int(self.matcher.window.max_len) - 1, 1)
            tails = np.zeros((len(state_keys), H), np.uint8)
            fills = np.zeros(len(state_keys), np.int32)
            for i, k in enumerate(state_keys):
                tail, fl = self._states[k]
                if tail:
                    tails[i, : len(tail)] = np.frombuffer(tail, np.uint8)
                fills[i] = fl
                # invariant: len(tail) == fill (both min(H, total streamed))
            data["state_tails"] = tails
            data["state_fills"] = fills
        # Pending bytes as segments: flat flows contribute ONE segment with
        # seq 0; reorder flows one per held segment with its real seq.
        pend_keys = list(self._pending)
        blob = bytearray()
        seg_flow, seg_seq, seg_off, seg_len = [], [], [], []
        for i, k in enumerate(pend_keys):
            v = self._pending[k]
            segs = v if isinstance(v, list) else [(0, bytes(v))]
            for sq, b in segs:
                seg_flow.append(i)
                seg_seq.append(sq)
                seg_off.append(len(blob))
                seg_len.append(len(b))
                blob += b
        data["pend_keys"] = key_rows(pend_keys)
        data["pend_blob"] = np.frombuffer(bytes(blob), np.uint8)
        data["seg_flow"] = np.array(seg_flow, np.int64)
        data["seg_seq"] = np.array(seg_seq, np.int64)
        data["seg_off"] = np.array(seg_off, np.int64)
        data["seg_len"] = np.array(seg_len, np.int64)
        rkeys = list(self._flow_reorder)
        data["reorder_keys"] = key_rows(rkeys)
        data["reorder_vals"] = np.array(
            [self._flow_reorder[k] for k in rkeys], np.int64
        ).reshape(-1, 2)
        la = list(self._last_active.items())
        data["active_keys"] = key_rows([k for k, _ in la])
        data["active_rounds"] = np.array([r for _, r in la], np.int64)
        data["closing_keys"] = key_rows(sorted(self._closing))
        if self.collect_offsets:
            bk = list(self._flow_base)
            data["base_keys"] = key_rows(bk)
            data["base_vals"] = np.array(
                [self._flow_base[k] for k in bk], np.int64
            )
            data["off_keys"] = key_rows([k for k, _, _ in self._offsets])
            data["off_vals"] = np.array(
                [(o, u) for _, o, u in self._offsets], np.int64
            ).reshape(-1, 2)
        np.savez(path, **data)
        path = str(path)
        return path if path.endswith(".npz") else path + ".npz"

    def load(self, path) -> None:
        """Full rollback to a checkpoint: every accumulator and per-flow
        state REPLACED (resuming onto a used instance must not
        double-count).  The checkpoint must match this instance's
        patterns, engine, mode, and reorder/ipv6 configuration."""
        from multithreading_string_matching.parallel.stream import (
            checkpoint_path,
            patterns_from_npz,
        )

        data = np.load(checkpoint_path(path), allow_pickle=False)
        if patterns_from_npz(data) != self.matcher.patterns:
            raise ValueError("checkpoint pattern list does not match matcher")
        if str(data["engine"]) != self.engine or str(data["mode"]) != self.mode:
            raise ValueError(
                "checkpoint engine/mode does not match this stream "
                f"({data['engine']}/{data['mode']} vs "
                f"{self.engine}/{self.mode})"
            )
        fl = data["flags"].tolist()
        while len(fl) < 4:  # pre-vlan / pre-offsets checkpoints = off
            fl.append(0)
        if fl != [int(self.reorder), int(self.ipv6), int(self.vlan),
                  int(self.collect_offsets)]:
            raise ValueError(
                "checkpoint reorder/ipv6/vlan/offsets configuration does "
                "not match"
            )
        self._dev_counts = None
        self._dev_pos = 0
        self._counts = np.asarray(data["counts"]).astype(np.int64)
        (self.packets_seen, self.bytes_seen, self._round,
         self.flows_evicted, self._pending_bytes) = (
            int(x) for x in data["counters"]
        )
        skeys = [bytes(r) for r in data["state_keys"]]
        if self.engine == "ac":
            self._states = {
                k: int(v) for k, v in zip(skeys, data["state_vals"])
            }
        else:
            self._states = {
                k: (bytes(t[: int(f)]), int(f))
                for k, t, f in zip(
                    skeys, data["state_tails"], data["state_fills"]
                )
            }
        blob = data["pend_blob"].tobytes()
        pkeys = [bytes(r) for r in data["pend_keys"]]
        self._pending = {}
        for fi, sq, off, ln in zip(
            data["seg_flow"], data["seg_seq"], data["seg_off"],
            data["seg_len"],
        ):
            k = pkeys[int(fi)]
            b = blob[int(off) : int(off) + int(ln)]
            if self.reorder:
                self._pending.setdefault(k, []).append((int(sq), b))
            else:
                self._pending.setdefault(k, bytearray()).extend(b)
        self._flow_reorder = {
            bytes(r): (int(v[0]), int(v[1]))
            for r, v in zip(data["reorder_keys"], data["reorder_vals"])
        }
        self._last_active = {
            bytes(r): int(v)
            for r, v in zip(data["active_keys"], data["active_rounds"])
        }
        self._closing = {bytes(r) for r in data["closing_keys"]}
        self._flow_base = {}
        self._offsets = []
        if self.collect_offsets:
            self._flow_base = {
                bytes(r): int(v)
                for r, v in zip(data["base_keys"], data["base_vals"])
            }
            self._offsets = [
                (bytes(r), int(o), int(u))
                for r, (o, u) in zip(data["off_keys"], data["off_vals"])
            ]

    def reload(self, matcher) -> np.ndarray:
        """Swap the pattern set mid-stream — the rule-update shape for the
        long-running flow monitor (StreamMatcher.reload's flow flavor).

        Scans everything pending under the CURRENT rules (one final
        round), returns the old set's final counts, then re-arms for
        ``matcher``: counts reset; tracked flows, eviction bookkeeping,
        reorder coverage, and stream bases all persist.  Engine state
        across the swap:

        - window: per-flow byte tails carry over TRIMMED to the new
          ``max_len - 1`` — a match spanning the swap boundary is still
          found as long as it fits the SHORTER of the two halos;
        - ac: DFA states cannot map between automata and restart at 0 —
          a match already in progress at the boundary is missed (the
          flow-stream analogue of StreamMatcher.reload's packet-boundary
          contract).

        With ``collect_offsets``, undrained triples index the OLD pattern
        set; reload refuses to mix the spaces — ``drain_offsets()`` after
        the final scan (the raise happens after an ordinary flush, the
        stream stays usable)."""
        self.flush()
        if self.collect_offsets and self._offsets:
            raise ValueError(
                "undrained offsets from the old rule set: call "
                "drain_offsets() before reload()"
            )
        final = self.counts()
        self.matcher = matcher
        self._counts = np.zeros(len(matcher.patterns), np.int64)
        if self.engine == "window":
            H = max(int(matcher.window.max_len) - 1, 1)
            self._states = {
                k: (tail[-H:], min(fl, H))
                for k, (tail, fl) in self._states.items()
            }
        else:
            self._states = {k: 0 for k in self._states}
        return final

    def evict(self, keys) -> None:
        """Drop carried state (and pending bytes) for the given flow keys
        (12-byte ``bytes`` values) — the hook for idle/FIN eviction."""
        for k in keys:
            self._states.pop(k, None)
            self._flow_reorder.pop(k, None)
            self._last_active.pop(k, None)
            # A re-appearing evicted flow restarts at stream offset 0 —
            # the same revival semantics the scan state has.
            self._flow_base.pop(k, None)
            b = self._pending.pop(k, None)
            if b:
                self._pending_bytes -= (
                    sum(len(s) for _, s in b) if isinstance(b, list) else len(b)
                )
