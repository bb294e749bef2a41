"""High-level matcher API — the unified library the reference never had.

The reference is five standalone C programs sharing copy-pasted code
(SURVEY.md §1: kmp_prefix/kmp_matcher appear five times verbatim).  Here a
single :class:`Matcher` object owns the compiled automata and exposes every
execution mode as a method; the five reference programs become thin CLI
configurations over it (cli.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union
import os

import jax
import jax.numpy as jnp
import numpy as np

from multithreading_string_matching.io.patterns import load_patterns
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.decode import extract_payloads, PayloadBatch
from multithreading_string_matching.models.kmp import stack_kmp_dfas
from multithreading_string_matching.models.aho_corasick import AhoCorasick
from multithreading_string_matching.ops.scan import (
    CompiledAC,
    count_matches_ac,
    count_matches_kmp,
)
from multithreading_string_matching.ops.window import (
    WindowProgram,
    count_matches_window,
    count_matches_window_tiles,
)
from multithreading_string_matching.ops.bucketing import (
    bucket_plan,
    pack_plan,
    pack_rows,
    quantize_rows,
    run_bucketed,
)

# Staging quanta: the packet axis pads to multiples of LANE rows and the
# byte axis to multiples of SUBLANE bytes, so a stream of captures reuses a
# few compiled shapes instead of one per batch.
LANE = 128
SUBLANE = 8

ENGINES = ("auto", "pallas", "window", "ac", "kmp")


def select_engine(engine: str, platform: str) -> str:
    """The one place that decides what runs a resolved engine on a platform.

    ``'pallas'`` names the accelerator's hand-written kernel.  On ``gpu``
    there is none: a Pallas-Triton form of the window matcher was 3x the
    XLA window engine on resident tiles but no faster through the served
    path, which is host-bound (docs/DESIGN.md §1), so ``'pallas'`` is the
    XLA window engine there and on ``cpu``.  The XLA engines (``window``,
    ``ac``, ``kmp``) are returned unchanged.  Any other platform is an
    error."""
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(
            f"no matcher path for platform {platform!r}: expected gpu or cpu"
        )
    return "window" if engine == "pallas" else engine


_FOLD_TABLE = np.arange(256, dtype=np.uint8)
_FOLD_TABLE[65:91] |= 0x20  # A-Z -> a-z (ASCII only, like bytes.lower())


def _fold_ascii_bytes(p: bytes) -> bytes:
    return bytes(_FOLD_TABLE[np.frombuffer(p, np.uint8)]) if p else p


def _fold_ascii_array(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8)
    return _FOLD_TABLE[a]


@dataclass
class PreparedBatch:
    """A payload batch staged on device, optionally length-bucketed.

    Staging once and reusing matters: a host->device copy moves every
    payload byte once more, and serving can scan the same resident tensors
    repeatedly.
    """

    tiles: list                 # [(payloads_dev uint8[T, Lt], lengths_dev int32[T])]
    row_indices: list           # [int64[rows_in_tile]] original row ids per tile
    num_rows: int
    total_payload_bytes: int
    packed: bool = False        # rows are 0x00-separated payload concatenations


@dataclass
class Matcher:
    """Multi-pattern payload matcher with compiled automata.

    Engines (identical counts, different execution shapes):

    - ``'window'``: the shifted-window word-compare matcher in plain XLA —
      zero gathers, zero sequential dependency (ops/window.py).
    - ``'pallas'`` (default): the accelerator kernel's name; it resolves
      to ``'window'`` on every supported platform (:func:`select_engine`).
    - ``'ac'``: single Aho-Corasick DFA pass per byte — O(1) work per byte
      regardless of pattern count; wins for very long/many patterns and
      powers carried-DFA-state streaming.
    - ``'kmp'``: per-pattern KMP DFAs in lockstep — the reference-shaped
      conformance path.
    - ``'auto'``: ``window`` unless the pattern set is where the O(U)
      compare chain should lose to the AC DFA's O(1)-per-byte gather: very
      many patterns or very long ones.

    ``bucketed=True`` (default) sorts packets by length into fixed row tiles
    so padded work tracks real bytes (ops/bucketing.py).
    """

    patterns: List[bytes]
    engine: str = "pallas"
    bucketed: bool = True
    # ASCII-case-insensitive matching (the reference has no analogue; IDS
    # rule languages call this ``nocase``).  Both the pattern set and every
    # payload byte are folded A-Z -> a-z before matching, so counts are over
    # case-folded occurrences; reported pattern spellings stay as written.
    # Patterns that differ only by case fold together and report the same
    # count (duplicates already report independently, serial.c:163-166).
    case_insensitive: bool = False

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        self.patterns = [bytes(p) for p in self.patterns]
        # Validate eagerly (cheap) even though automata build lazily: the
        # caller should hear about a bad pattern list at construction, not
        # deep inside the first count() after ingesting a capture.
        if not self.patterns:
            raise ValueError("patterns must be non-empty")
        if any(len(p) == 0 for p in self.patterns):
            raise ValueError("empty pattern")
        # Automata build lazily and cache: a deployment uses one engine, and
        # e.g. the stacked per-pattern KMP tables are O(P·max_m·256) —
        # substantial for large pattern sets that will only ever run AC.
        self._ac = None
        self._cac = None
        self._window = None
        self._kmp = None
        # The byte strings the automata/kernels actually match on.
        self._match_patterns = (
            [_fold_ascii_bytes(p) for p in self.patterns]
            if self.case_insensitive else self.patterns
        )

    def _maybe_fold(self, payloads):
        """Case-fold payload bytes when case-insensitive (idempotent: folding
        already-folded bytes is a no-op, so layered call paths are safe).
        Zero padding is preserved (0x00 < 'A'), keeping the zero-padded-rows
        invariant intact."""
        if not self.case_insensitive:
            return payloads
        return _fold_ascii_array(payloads)

    @property
    def ac(self) -> AhoCorasick:
        if self._ac is None:
            self._ac = AhoCorasick.build(self._match_patterns)
        return self._ac

    @property
    def cac(self) -> CompiledAC:
        if self._cac is None:
            self._cac = CompiledAC.from_automaton(self.ac)
        return self._cac

    @property
    def window(self) -> WindowProgram:
        if self._window is None:
            self._window = WindowProgram.build(self._match_patterns)
        return self._window

    @property
    def _kmp_dfas(self):
        if self._kmp is None:
            self._kmp = stack_kmp_dfas(self._match_patterns)
        return self._kmp[0]

    @property
    def _kmp_accept(self):
        if self._kmp is None:
            self._kmp = stack_kmp_dfas(self._match_patterns)
        return self._kmp[1]

    def _pattern_stats(self):
        """(unique_patterns, max_len, total_words) from the pattern list
        alone — the ONE computation behind both engine-auto resolution and
        explain() (they previously used different word-count estimates and
        could disagree near the crossover boundary).  total_words is the
        exact sum of ceil(len/4) over unique patterns — equal by
        construction to the WindowProgram's nonzero mask words, without
        building the [U, K] tables the decision may route away from."""
        unique = list(dict.fromkeys(self._match_patterns))
        max_len = max(len(p) for p in unique)
        total_words = sum(-(-len(p) // 4) for p in unique)
        return unique, max_len, total_words

    # AC goto tables past this many bytes keep engine='auto' on the window
    # engine: the goto table is a [states, 256] int32 constant baked into
    # the AC executable (ROADMAP C3 would make it an argument), so its
    # compile grows with the rule set, while the window engine takes its
    # pattern tables as arguments.
    AC_GOTO_WALL_BYTES = 48 << 20

    def _ac_goto_too_big(self) -> bool:
        """Would the AC engine's goto table exceed AC_GOTO_WALL_BYTES?
        Estimated from the pattern list alone (states <= total pattern
        bytes + 1; the table is [states, 256] int32) — never builds the
        automaton it may route away from."""
        est_states = sum(len(p) for p in dict.fromkeys(self._match_patterns)) + 1
        return est_states * 256 * 4 > self.AC_GOTO_WALL_BYTES

    def explain(self) -> dict:
        """How this matcher will execute — for logs/observability, not for
        program logic (shapes may route differently per call, e.g.
        per-packet).

        The reference's only observability is the final printf; a serving
        deployment wants to log WHICH engine/kernel a rule-set compiled to
        before traffic arrives.
        """
        unique, max_len, total_words = self._pattern_stats()
        eng = self._resolve_engine(None)
        out = {
            "engine_requested": self.engine,
            "engine_resolved": eng,
            "patterns": len(self.patterns),
            "unique_patterns": len(unique),
            "total_pattern_words": total_words,
            "max_pattern_len": max_len,
            "case_insensitive": self.case_insensitive,
            "bucketed": self.bucketed,
            "nul_patterns": any(0 in p for p in unique),
        }
        if self.engine == "auto" and (
            total_words > 50_000 and max_len <= 256 and self._ac_goto_too_big()
        ):
            # auto's size rule wanted AC, but its goto table would exceed
            # AC_GOTO_WALL_BYTES: say why the set runs the window engine.
            out["auto_note"] = (
                f"ac goto table (~{(sum(len(p) for p in unique) + 1) * 1024} "
                f"bytes) exceeds {self.AC_GOTO_WALL_BYTES}; using the window "
                "engine"
            )
        out["platform"] = jax.default_backend()
        return out

    @staticmethod
    def from_file(path: Union[str, os.PathLike], engine: str = "pallas") -> "Matcher":
        return Matcher(load_patterns(path), engine=engine)

    def swap_patterns(self, new_patterns) -> bool:
        """Replace the pattern set in place — the rule-push path.

        Automata invalidate and rebuild lazily.  The XLA window engine takes
        its pattern tables as jit ARGUMENTS, so when the matcher runs that
        engine and the new set keeps the old ``[U, K]`` table geometry, the
        next count reuses the compiled executables outright and the swap
        costs one host table build.  Returns True in exactly that case,
        False when the next count compiles (other geometry, or an automaton
        engine).  Counts are correct either way."""
        new = [bytes(p) for p in new_patterns]
        if not new:
            raise ValueError("patterns must be non-empty")
        if any(len(p) == 0 for p in new):
            raise ValueError("empty pattern")
        old = self._window
        self.patterns = new
        self._match_patterns = (
            [_fold_ascii_bytes(p) for p in new]
            if self.case_insensitive else new
        )
        self._ac = self._cac = self._window = self._kmp = None
        return (
            old is not None
            and self._resolve_engine(None) == "window"
            and self.window.pat_words.shape == old.pat_words.shape
        )

    def flow_stream_engine(self) -> str:
        """Engine for per-flow carried-state streaming (FlowStreamMatcher):
        'window' (halo rounds, one dispatch per round) when 'window' was
        asked for, or when a 'pallas'/'auto' matcher resolves to the window
        engine on a GPU; otherwise 'ac', one carried DFA state per flow (on
        a CPU host compare chains are the expensive form).  Decided from the
        REQUESTED engine: 'pallas' resolving to 'window' on a CPU host must
        not read as a window request."""
        if self.engine == "window":
            return "window"
        if (
            self.engine in ("pallas", "auto")
            and jax.default_backend() == "gpu"
            and self._resolve_engine(None) == "window"
        ):
            return "window"
        return "ac"

    # -- core counting ----------------------------------------------------

    def count(
        self,
        payloads,
        lengths,
        *,
        per_packet: bool = False,
        engine: Optional[str] = None,
        bucketed: Optional[bool] = None,
        n_tile: int = 2048,
        l_quant: int = LANE,
    ) -> np.ndarray:
        """Counts over the ORIGINAL pattern list (duplicates as separate entries).

        Shapes: ``int32[P]`` or ``int32[N, P]`` with ``per_packet=True``.
        ``n_tile`` / ``l_quant`` tune the bucket tiling (see :meth:`prepare`).
        """
        bucketed = self.bucketed if bucketed is None else bucketed
        # Resolve (and VALIDATE) the engine before the empty-batch return —
        # a typo'd engine= must raise even when the first batch is empty.
        engine = self._resolve_engine(engine)
        if np.shape(payloads)[0] == 0:
            shape = (0, len(self.patterns)) if per_packet else (len(self.patterns),)
            return np.zeros(shape, dtype=np.int32)
        payloads = self._maybe_fold(payloads)
        fn = self._engine_fn(engine)
        if bucketed:
            return np.asarray(
                run_bucketed(
                    fn, payloads, lengths,
                    n_tile=n_tile, l_quant=l_quant, per_packet=per_packet,
                )
            )
        return np.asarray(fn(payloads, lengths, per_packet=per_packet))

    def _resolve_engine(self, engine: Optional[str]) -> str:
        """'auto' picks by pattern-set shape; the result then goes through
        :func:`select_engine`, the one platform rule."""
        engine = engine or self.engine
        if engine not in ENGINES:
            # A typo'd per-call override must not silently fall through to
            # the window engine (the constructor already validates eagerly).
            raise ValueError(
                f"unknown engine {engine!r}: expected "
                "auto/pallas/window/ac/kmp"
            )
        if engine == "auto":
            # Window cost per byte is O(U·K) compares, the AC scan's
            # one table gather per byte is O(1) in the set size, so the DFA
            # can only win far beyond the reference's 97-pattern shape.
            # Very long patterns mean many word views per position; AC's
            # table grows gracefully instead.  Decided from the pattern list
            # alone via the same exact word count explain() reports — never
            # build the WindowProgram the decision may route away from.
            _, max_len, total_words = self._pattern_stats()
            engine = "ac" if total_words > 50_000 or max_len > 256 else "window"
            if engine == "ac" and max_len <= 256 and self._ac_goto_too_big():
                engine = "window"
        return select_engine(engine, jax.default_backend())

    def _engine_fn(self, engine: Optional[str]):
        engine = engine or self.engine
        if engine == "kmp":
            return lambda p, l, per_packet: count_matches_kmp(
                self._kmp_dfas, self._kmp_accept, p, l, per_packet=per_packet
            )
        if engine == "ac":
            return lambda p, l, per_packet: count_matches_ac(
                self.cac, p, l, per_packet=per_packet, dup_map=self.ac.dup_map
            )
        return lambda p, l, per_packet: count_matches_window(
            self.window, p, l, per_packet=per_packet
        )

    # -- staged execution (device-resident tiles) --------------------------

    def prepare(
        self,
        payloads,
        lengths,
        *,
        bucketed: Optional[bool] = None,
        n_tile: int = 2048,
        l_quant: int = LANE,
        packed: Union[bool, str] = False,
        pack_width: int = 2048,
    ) -> PreparedBatch:
        """Stage a batch on device once (bucketed by length by default).

        ``packed=True`` sequence-packs payloads into fixed-width rows with a
        0x00 separator byte between them — padded bytes drop from the 128-
        lane quantization floor (~1.6x real) to within a few percent of real
        bytes, which is a proportional scan speedup.  Exact for NUL-free
        pattern sets ONLY (a window crossing a separator contains 0x00 and
        cannot match; every engine's state also resets at the separator), so
        NUL-containing patterns are rejected; per-packet attribution is
        unavailable in packed form (global counts are identical).
        ``packed="auto"`` packs only when it beats width-class bucketing by
        >20% padded bytes (short-payload corpora) and patterns allow it —
        long payloads near the pack width fragment rows and lose to
        bucketing.
        """
        payloads = self._maybe_fold(np.asarray(payloads))
        lengths = np.asarray(lengths)
        pre_plan = None
        if packed == "auto":
            # Decide from lengths alone (pack_plan copies no payload bytes);
            # decline — never raise — when packing can't apply (NUL patterns,
            # a payload wider than the pack row) or wouldn't pay.  The plan
            # computed for the decision is reused by the materialization.
            packed = False
            if (
                not any(0 in p for p in self.window.unique_patterns)
                and (lengths.size == 0 or int(lengths.max()) <= pack_width)
            ):
                from multithreading_string_matching.io import native

                if native.available():
                    n_rows = native.plan_rows(lengths, pack_width)
                else:
                    pre_plan = pack_plan(lengths, pack_width)
                    n_rows = len(pre_plan[0])
                plan = bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant)
                bucketed_bytes = sum(quantize_rows(len(i)) * lt for i, lt in plan)
                packed_bytes = (-(-max(n_rows, 1) // 64) * 64) * pack_width
                packed = packed_bytes < 0.8 * bucketed_bytes
        if packed:
            if any(0 in p for p in self.window.unique_patterns):
                raise ValueError(
                    "packed staging is exact only for NUL-free patterns"
                )
            pk, fill = pack_rows(payloads, lengths, width=pack_width, plan=pre_plan)
            # Row padding: multiples of 64 only — pow2 quantization would
            # waste up to 50% of the packing gain on mid-sized corpora.
            target = -(-pk.shape[0] // 64) * 64
            if pk.shape[0] < target:
                pk = np.pad(pk, ((0, target - pk.shape[0]), (0, 0)))
                fill = np.pad(fill, (0, target - fill.shape[0]))
            return PreparedBatch(
                tiles=[(jnp.asarray(pk, jnp.uint8), jnp.asarray(fill, jnp.int32))],
                row_indices=[],
                num_rows=int(payloads.shape[0]),
                total_payload_bytes=int(lengths.sum()),
                packed=True,
            )
        bucketed = self.bucketed if bucketed is None else bucketed
        tiles, rows = [], []

        def sanitize(tp, tl):
            # Enforce the staged-batch invariant: bytes past each row's true
            # length are ZERO (extract_payloads already guarantees this; an
            # arbitrary caller buffer might not).
            cols = np.arange(tp.shape[1], dtype=np.int64)[None, :]
            return np.where(cols < tl[:, None], tp, 0).astype(np.uint8)

        if bucketed:
            for idx, lt in bucket_plan(lengths, n_tile=n_tile, l_quant=l_quant):
                tp, tl = payloads[idx, :lt], lengths[idx]
                if tp.shape[1] < lt:  # tensor narrower than the quantized tile
                    tp = np.pad(tp, ((0, 0), (0, lt - tp.shape[1])))
                target = quantize_rows(tp.shape[0])
                if tp.shape[0] < target:
                    pad = target - tp.shape[0]
                    tp = np.pad(tp, ((0, pad), (0, 0)))
                    tl = np.pad(tl, (0, pad))
                tp = sanitize(tp, tl)
                tiles.append((jnp.asarray(tp, jnp.uint8), jnp.asarray(tl, jnp.int32)))
                rows.append(idx)
        else:
            tp = sanitize(payloads, lengths)
            # Fresh lengths copy: jnp.asarray may alias the CALLER'S buffer
            # on CPU backends, and a PreparedBatch is long-lived — a caller
            # reusing its lengths array would silently corrupt the staged
            # tile (the payload side is already fresh via sanitize()).
            tiles.append((
                jnp.asarray(tp, jnp.uint8),
                jnp.asarray(np.array(lengths, dtype=np.int32, copy=True)),
            ))
            rows.append(np.arange(payloads.shape[0]))
        return PreparedBatch(
            tiles=tiles,
            row_indices=rows,
            num_rows=int(payloads.shape[0]),
            total_payload_bytes=int(lengths.sum()),
        )

    def prepare_batch(self, batch: PayloadBatch, **kw) -> PreparedBatch:
        return self.prepare(batch.payloads, batch.lengths, **kw)

    def count_prepared(
        self,
        prep: PreparedBatch,
        *,
        per_packet: bool = False,
        engine: Optional[str] = None,
        block: bool = True,
    ):
        """Count over device-staged tiles; no host transfers in the hot path.

        With ``block=False`` returns the (lazy) device array of summed counts
        so callers can pipeline.
        """
        if not prep.tiles:  # zero-row batch bucketed into zero tiles
            shape = (prep.num_rows, len(self.patterns)) if per_packet else (
                len(self.patterns),
            )
            return np.zeros(shape, dtype=np.int32)
        engine = self._resolve_engine(engine)
        if prep.packed and per_packet:
            raise ValueError(
                "per-packet counts are unavailable for packed batches "
                "(prepare(packed=False) for per-packet attribution)"
            )
        if prep.packed and any(0 in p for p in self.window.unique_patterns):
            # prepare() rejects packing for NUL sets at staging time, but a
            # batch packed under an earlier set can outlive a
            # swap_patterns() that introduced a NUL pattern — which would
            # silently match across the 0x00 pack separators.
            raise ValueError(
                "packed batch is inexact for NUL-containing patterns "
                "(re-prepare after the pattern swap)"
            )
        if engine == "window":
            # One dispatch for every tile: each dispatch has a fixed cost
            # that small tiles would pay many times over.
            out = count_matches_window_tiles(
                self.window, prep.tiles, per_packet=per_packet
            )
            if per_packet:
                merged = np.zeros(
                    (prep.num_rows, len(self.patterns)), dtype=np.int32
                )
                for idx, o in zip(prep.row_indices, out):
                    merged[idx] = np.asarray(o)[: len(idx)]
                return merged
            return np.asarray(out) if block else out
        fn = self._engine_fn(engine)
        if per_packet:
            outs = [fn(p, l, per_packet=True) for p, l in prep.tiles]
            merged = np.zeros((prep.num_rows, len(self.patterns)), dtype=np.int32)
            for idx, out in zip(prep.row_indices, outs):
                merged[idx] = np.asarray(out)[: len(idx)]
            return merged
        total = None
        for p, l in prep.tiles:
            out = fn(p, l, per_packet=False)
            total = out if total is None else total + out
        return np.asarray(total) if block else total

    def count_batch(self, batch: PayloadBatch, **kw) -> np.ndarray:
        return self.count(batch.payloads, batch.lengths, **kw)

    def count_pcap(
        self,
        pcap_path: Union[str, os.PathLike],
        mode: str = "udp",
        *,
        strict: bool = False,
        vlan: bool = False,
        ipv6: bool = False,
        **kw,
    ) -> np.ndarray:
        pcap = read_pcap(pcap_path)
        batch = extract_payloads(
            pcap, mode, strict=strict, vlan=vlan, ipv6=ipv6,
            pad_n_to=LANE, pad_len_to=SUBLANE,
        )
        return self.count_batch(batch, **kw)

    def find_matches(self, payloads, lengths) -> np.ndarray:
        """Match offsets: int64[K, 3] rows of (packet, start, unique_pattern_idx).

        ``self.window.dup_map`` maps original pattern indices to the unique
        indices in column 2; ``self.window.unique_patterns`` hold the bytes.
        """
        from multithreading_string_matching.ops.window import find_matches

        return find_matches(self.window, self._maybe_fold(payloads), lengths)

    def counts_from_match_rows(self, rows) -> np.ndarray:
        """Expanded int64[P] counts from :meth:`find_matches` occurrence
        rows — the occurrence rows ARE the counts (bincount over unique
        patterns, dup_map expansion), a tested invariant.  The ONE
        reduction behind the CLI's, the streamed scanner's, and the demo's
        one-scan-serves-all shapes."""
        rows = np.asarray(rows)
        uniq = np.bincount(
            rows[:, 2] if rows.size else np.zeros(0, np.int64),
            minlength=len(self.window.unique_patterns),
        )
        return uniq[self.window.dup_map].astype(np.int64)

    # -- streaming (carried DFA state across chunks) ----------------------

    def streaming_state(self, num_lanes: int) -> jax.Array:
        return jnp.zeros((num_lanes,), dtype=jnp.int32)

    def count_chunk(self, payload_chunk, rel_lengths, states):
        """Scan one chunk of a long payload stream, carrying DFA state.

        ``rel_lengths`` are payload lengths RELATIVE to this chunk's first
        column (i.e. remaining bytes).  Returns (counts[P], new_states).
        """
        counts, new_states = count_matches_ac(
            self.cac, self._maybe_fold(payload_chunk), rel_lengths,
            initial_states=states, dup_map=self.ac.dup_map, return_states=True,
        )
        return np.asarray(counts), new_states
