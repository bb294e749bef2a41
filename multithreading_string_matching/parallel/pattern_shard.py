"""Pattern-axis sharding — the parallelism dimension the reference never had.

Every distributed path in the reference (mpi_dumping.c:75-97) and in
parallel/mesh.py replicates the PATTERN tables on every rank/device and
shards the PACKET axis.  That is the right call for small rule sets — but
window-family throughput scales ~1/U in unique pattern count (measured,
docs/DESIGN.md §1), so at IDS scale (3k-12k+ rules) each chip is ~45x below
the small-set headline while the packet axis has nothing left to give.
This module shards the OTHER axis: partition the unique-pattern set into
N contiguous build-order chunks, give each mesh shard its own chunk as
per-device DATA (the XLA window engine takes its pattern tables as
arguments), scan the SAME payload tiles on every shard, and concatenate
per-shard counts — ``out_specs=P("patterns")``, no arithmetic collective at
all.  The ~1/U law then predicts ~N_dev× on exactly the sets where the
framework is furthest from its headline; the cost is payload replication
(each chip scans all bytes — the same trade model parallelism makes for
weights vs activations).

Composability: a 2-D ``Mesh(("packets", "patterns"))`` shards payload rows
over one axis and pattern tables over the other; the only collective is the
count psum over the packet axis.  Every shard runs the XLA window engine;
requests for any engine map to it, the AC/KMP automata included — they
bake the whole set into one DFA (identical counts — tested invariant).

Geometry: all shards run ONE SPMD program, so every shard's table is padded
to a common ``[C, K]`` block with all patterns carried at the full set's
K_max (mask-0 words past a pattern's end compare trivially true —
ops/window.WindowProgram's own padding).  Padded slots carry a never-fit
length and count zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PATTERN_AXIS = "patterns"
PACKET_AXIS = "packets"

# Padded shard slots carry this length so the fit mask (pos + len <= L) can
# never pass: far above any payload width, far below int32 overflow when
# added to a position.
_NEVER_FIT = np.int32(2**30)


def make_pattern_mesh(devices=None) -> Mesh:
    """1-D mesh over the pattern axis: every device scans ALL packets with
    1/N of the rule set."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (PATTERN_AXIS,))


def make_2d_mesh(packet_shards: int, pattern_shards: int,
                 devices=None) -> Mesh:
    """2-D mesh: payload rows shard over ``packets``, pattern tables over
    ``patterns`` — the general large-corpus × large-rule-set shape."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    if devs.size != packet_shards * pattern_shards:
        raise ValueError(
            f"{devs.size} devices cannot form a "
            f"{packet_shards}x{pattern_shards} mesh"
        )
    return Mesh(devs.reshape(packet_shards, pattern_shards),
                (PACKET_AXIS, PATTERN_AXIS))


def _axes(mesh: Mesh) -> Tuple[str, Optional[str]]:
    """(pattern_axis, packet_axis_or_None) for a mesh handed to this module:
    an explicit "patterns" name wins; a 1-D mesh's single axis is the
    pattern axis whatever its name (so callers can reuse make_mesh())."""
    names = mesh.axis_names
    if PATTERN_AXIS in names:
        others = [a for a in names if a != PATTERN_AXIS]
        if not others:
            return PATTERN_AXIS, None
        if others == [PACKET_AXIS]:
            return PATTERN_AXIS, PACKET_AXIS
        raise ValueError(
            f"pattern-sharded mesh axes must be ('patterns',) or "
            f"('packets', 'patterns'); got {names}"
        )
    if len(names) == 1:
        return names[0], None
    raise ValueError(
        f"a multi-axis mesh must name its pattern axis 'patterns'; "
        f"got {names}"
    )


@dataclass(frozen=True)
class PatternShardPlan:
    """Host-built per-shard pattern tables + the build-order gather map.

    Shard d owns unique patterns [d*C, min((d+1)*C, U)) — contiguous in
    BUILD order, padded to the common shard size S, flattened to
    ``[n_shards*S, ...]`` arrays that shard over the mesh with
    ``P('patterns')`` on dim 0."""

    words: np.ndarray    # uint32[n_sh*S, K]
    masks: np.ndarray    # uint32[n_sh*S, K]
    lens: np.ndarray     # int32[n_sh*S, 1] (_NEVER_FIT in padded slots)
    n_shards: int
    S: int               # patterns per shard block (padded slots included)
    C: int               # real patterns per shard (last shard may be short)
    U: int
    K: int

    def gather(self, full: np.ndarray) -> np.ndarray:
        """[..., n_sh*S] concatenated shard outputs -> [..., U] build-order
        unique counts (drops the padded slots)."""
        full = np.asarray(full)
        parts = []
        for d in range(self.n_shards):
            valid = min(self.C, self.U - d * self.C)
            if valid <= 0:
                break
            parts.append(full[..., d * self.S : d * self.S + valid])
        return np.concatenate(parts, axis=-1)

    def shard_of_unique(self, u: int) -> Tuple[int, int]:
        """(shard, slot) carrying unique pattern u."""
        return u // self.C, u % self.C


def build_pattern_shards(wp, n_shards: int) -> PatternShardPlan:
    """Partition a WindowProgram's unique patterns into n_shards padded
    table blocks (see PatternShardPlan)."""
    U, K = wp.pat_words.shape
    C = -(-U // n_shards)
    S = C
    words = np.zeros((n_shards * S, K), np.uint32)
    masks = np.zeros((n_shards * S, K), np.uint32)
    # Padded slots: never-fit length, so they count zero.
    lens = np.full((n_shards * S, 1), _NEVER_FIT, np.int32)
    for d in range(n_shards):
        lo = d * C
        hi = min(lo + C, U)
        if hi <= lo:
            break
        v = hi - lo
        words[d * S : d * S + v] = wp.pat_words[lo:hi]
        masks[d * S : d * S + v] = wp.pat_masks[lo:hi]
        lens[d * S : d * S + v, 0] = wp.pat_lens[lo:hi]
    return PatternShardPlan(
        words=words, masks=masks, lens=lens, n_shards=n_shards, S=S, C=C,
        U=U, K=K,
    )


def _check_engine(engine: Optional[str]) -> None:
    """Every engine maps to the window engine here (module docstring); an
    unknown name is still an error."""
    if engine not in (None, "auto", "pallas", "window", "ac", "kmp"):
        raise ValueError(
            f"unknown pattern-shard engine {engine!r}: expected "
            "auto/pallas/window/ac/kmp (all run the window engine)"
        )


def _plan_for(matcher, n_shards: int) -> PatternShardPlan:
    """The plan cached on the MATCHER keyed by (WindowProgram identity,
    n_shards) — swap_patterns rebuilds the WindowProgram, which
    invalidates naturally; re-deriving the tables per call would pay the
    host build + upload per dispatch."""
    wp = matcher.window
    cache = getattr(matcher, "_pattern_shard_plans", None)
    if cache is None:
        cache = matcher._pattern_shard_plans = {}
    key = (id(wp), n_shards)
    plan = cache.get(key)
    if plan is None or cache.get("_wp") is not wp:
        if cache.get("_wp") is not wp:
            cache.clear()
            cache["_wp"] = wp
            # Old plans die with the cache — their staged device tables
            # must die too, or an id(plan)-keyed staging entry could alias
            # a NEW plan allocated at the same address and silently serve
            # the old rule set's tables (swap_patterns twice in a row).
            staged = getattr(matcher, "_pattern_shard_staged", None)
            if staged is not None:
                staged.clear()
        plan = build_pattern_shards(wp, n_shards)
        cache[key] = plan
    return plan


def _jit_cache(matcher) -> dict:
    cache = getattr(matcher, "_pattern_shard_jits", None)
    if cache is None:
        cache = matcher._pattern_shard_jits = {}
    return cache


def _stage_tables(matcher, plan: PatternShardPlan, mesh: Mesh, pat_ax: str):
    """Device-resident sharded tables, staged ONCE per (plan, mesh) — the
    per-tile serving loop must never re-upload them."""
    cache = getattr(matcher, "_pattern_shard_staged", None)
    if cache is None:
        cache = matcher._pattern_shard_staged = {}
    key = (id(plan), mesh, pat_ax)
    entry = cache.get(key)
    # The entry holds the PLAN it was staged from and is only valid while
    # that exact object is the one asked about — an id() key alone could
    # alias a new plan allocated at a freed plan's address (belt alongside
    # _plan_for's suspenders: it clears this cache on plan turnover).
    if entry is None or entry[0] is not plan:
        sh = NamedSharding(mesh, P(pat_ax))
        entry = (
            plan,
            jax.device_put(jnp.asarray(plan.words), sh),
            jax.device_put(jnp.asarray(plan.masks), sh),
            jax.device_put(jnp.asarray(plan.lens), sh),
        )
        cache[key] = entry
    return entry[1:]


def _pad_packets(payloads, lengths, n_pkt: int):
    n = payloads.shape[0]
    n_pad = -(-max(n, 1) // n_pkt) * n_pkt
    if n_pad != n:
        payloads = np.pad(payloads, ((0, n_pad - n), (0, 0)))
        lengths = np.pad(lengths, (0, n_pad - n))
    return payloads, lengths


def _counts_fn(matcher, plan, mesh, pat_ax, pkt_ax):
    """The jitted SPMD totals program for one (plan geometry, mesh):
    local shard counts [S] (+psum over the packet axis when present),
    out_specs P(patterns) — concatenation IS the merge."""
    cache = _jit_cache(matcher)
    key = ("counts", plan.K, plan.S, mesh)
    fn = cache.get(key)
    if fn is not None:
        return fn
    from multithreading_string_matching.ops.window import _window_one

    def local(words, masks, lens, payloads, lengths):
        counts = _window_one(
            words, masks, lens[:, 0], payloads, lengths, per_packet=False,
        )
        if pkt_ax is not None:
            counts = jax.lax.psum(counts, pkt_ax)
        return counts

    pay_spec = P(pkt_ax) if pkt_ax else P()
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(pat_ax), P(pat_ax), P(pat_ax), pay_spec, pay_spec),
            out_specs=P(pat_ax),
            check_vma=False,
        )
    )
    cache[key] = fn
    return fn


def _rows_fn(matcher, plan, mesh, pat_ax, pkt_ax):
    """Per-packet attribution program: rows stay with their packet shard,
    pattern columns with their pattern shard — fully collective-free
    ([N, n_sh*S] sharded on both axes)."""
    cache = _jit_cache(matcher)
    key = ("rows", plan.K, plan.S, mesh)
    fn = cache.get(key)
    if fn is not None:
        return fn
    from multithreading_string_matching.ops.window import _window_one

    def local(words, masks, lens, payloads, lengths):
        return _window_one(
            words, masks, lens[:, 0], payloads, lengths, per_packet=True,
        )

    pay_spec = P(pkt_ax) if pkt_ax else P()
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(pat_ax), P(pat_ax), P(pat_ax), pay_spec, pay_spec),
            out_specs=P(pkt_ax, pat_ax),
            check_vma=False,
        )
    )
    cache[key] = fn
    return fn


def _summary_fn(matcher, plan, mesh, pat_ax, pkt_ax):
    """Attribution summary: (totals [n_sh*S] P(patterns), row-hit flags
    bool[N] P(packets)) — the transfer-diet shape streamed attribution
    consumes.  The only collective is the hit-flag OR across pattern
    shards (psum of the int flags) and, on 2-D meshes, the totals psum
    over the packet axis."""
    cache = _jit_cache(matcher)
    key = ("summary", plan.K, plan.S, mesh)
    fn = cache.get(key)
    if fn is not None:
        return fn
    from multithreading_string_matching.ops.window import _window_one

    def local(words, masks, lens, payloads, lengths):
        rows = _window_one(
            words, masks, lens[:, 0], payloads, lengths, per_packet=True,
        )
        totals = rows.sum(axis=0)
        if pkt_ax is not None:
            totals = jax.lax.psum(totals, pkt_ax)
        # A row-hit flag must only fire on real patterns: mask padded slots
        # out before the any-reduce.  The LAST shard's valid count can be
        # below C (U need not divide n_shards evenly) — compute this
        # shard's own bound from its axis index, not the global C.
        d = jax.lax.axis_index(pat_ax)
        valid = jnp.clip(plan.U - d * plan.C, 0, plan.C)
        slot = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
        hits_local = ((rows > 0) & (slot < valid)).any(axis=1)
        hits = jax.lax.psum(hits_local.astype(jnp.int32), pat_ax) > 0
        return totals, hits

    pay_spec = P(pkt_ax) if pkt_ax else P()
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(pat_ax), P(pat_ax), P(pat_ax), pay_spec, pay_spec),
            out_specs=(P(pat_ax), pay_spec),
            check_vma=False,
        )
    )
    cache[key] = fn
    return fn


def _prepare_call(matcher, payloads, lengths, mesh, engine):
    """Shared entry plumbing: check the engine, build/stage the plan, fold +
    pad the payload batch, device_put with the right shardings."""
    pat_ax, pkt_ax = _axes(mesh)
    _check_engine(engine)
    plan = _plan_for(matcher, mesh.shape[pat_ax])
    payloads = matcher._maybe_fold(np.asarray(payloads))
    lengths = np.asarray(lengths)
    if pkt_ax is not None:
        payloads, lengths = _pad_packets(payloads, lengths,
                                         mesh.shape[pkt_ax])
    tabs = _stage_tables(matcher, plan, mesh, pat_ax)
    pay_sh = NamedSharding(mesh, P(pkt_ax) if pkt_ax else P())
    pay_d = jax.device_put(jnp.asarray(payloads, jnp.uint8), pay_sh)
    len_d = jax.device_put(jnp.asarray(lengths, jnp.int32), pay_sh)
    return plan, tabs, pay_d, len_d, pat_ax, pkt_ax


def count_matches_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Totals with the PATTERN axis sharded over the mesh (and the packet
    axis too, on a 2-D ``('packets', 'patterns')`` mesh).  Bit-identical to
    the single-device scan for any shard count (tested at 1/2/4/8)."""
    plan, tabs, pay_d, len_d, pat_ax, pkt_ax = _prepare_call(
        matcher, payloads, lengths, mesh, engine
    )
    fn = _counts_fn(matcher, plan, mesh, pat_ax, pkt_ax)
    full = np.asarray(fn(*tabs, pay_d, len_d))
    uniq = plan.gather(full)
    if expand_duplicates:
        uniq = uniq[matcher.window.dup_map]
    return uniq


def count_rows_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Per-packet counts [N, U or P] with pattern columns sharded (rows too
    on a 2-D mesh) — collective-free attribution for huge rule sets."""
    n = int(np.shape(payloads)[0])
    plan, tabs, pay_d, len_d, pat_ax, pkt_ax = _prepare_call(
        matcher, payloads, lengths, mesh, engine
    )
    fn = _rows_fn(matcher, plan, mesh, pat_ax, pkt_ax)
    full = np.asarray(fn(*tabs, pay_d, len_d))[:n]
    uniq = plan.gather(full)
    if expand_duplicates:
        uniq = uniq[:, matcher.window.dup_map]
    return uniq


def count_rows_summary_pattern_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    engine: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique totals int64[U] build order, row_hits bool[N])`` — the
    pattern-sharded flavor of mesh.count_rows_summary, feeding the streamed
    attribution path.  Device totals are int32: feeds scanning >= 2^31
    positions are sliced internally (host int64 across slices)."""
    from multithreading_string_matching.parallel.mesh import (
        SUMMARY_MAX_POSITIONS,
    )

    def once(payloads, lengths):
        n = int(np.shape(payloads)[0])
        plan, tabs, pay_d, len_d, pat_ax, pkt_ax = _prepare_call(
            matcher, payloads, lengths, mesh, engine
        )
        fn = _summary_fn(matcher, plan, mesh, pat_ax, pkt_ax)
        tot, hits = fn(*tabs, pay_d, len_d)
        uniq = plan.gather(np.asarray(tot)).astype(np.int64)
        return uniq, np.asarray(hits)[:n]

    n, L = int(np.shape(payloads)[0]), int(np.shape(payloads)[1])
    if n * max(L, 1) < SUMMARY_MAX_POSITIONS:
        return once(payloads, lengths)
    pat_ax, pkt_ax = _axes(mesh)
    n_pkt = mesh.shape[pkt_ax] if pkt_ax else 1
    step = max((SUMMARY_MAX_POSITIONS - 1) // max(L, 1), 1)
    step = max(step // n_pkt, 1) * n_pkt
    if step * L >= SUMMARY_MAX_POSITIONS:
        raise ValueError(
            f"rows of {L} bytes cannot be sliced below the device int32 "
            f"bound on a {n_pkt}-packet-shard mesh"
        )
    tot = np.zeros(len(matcher.window.unique_patterns), dtype=np.int64)
    hit_parts = []
    lengths = np.asarray(lengths)
    for s in range(0, n, step):
        t, h = once(payloads[s : s + step], lengths[s : s + step])
        tot += t
        hit_parts.append(h)
    return tot, np.concatenate(hit_parts)


def make_tile_counter(matcher, mesh: Mesh, engine: Optional[str] = None):
    """(tile_fn, plan) for the packed-tile serving loop
    (parallel.pipeline.PackedTileCounter): ``tile_fn(buf, fill)`` returns
    DEVICE-resident [n_sh*S] shard-concatenated unique counts (sharded
    layout — accumulation composes on device; the drain's np.asarray
    gathers), and ``plan.gather`` maps the drained vector back to
    build-order uniques.  Tables staged once; one executable per tile
    shape."""
    pat_ax, pkt_ax = _axes(mesh)
    _check_engine(engine)
    plan = _plan_for(matcher, mesh.shape[pat_ax])
    tabs = _stage_tables(matcher, plan, mesh, pat_ax)
    fn = _counts_fn(matcher, plan, mesh, pat_ax, pkt_ax)
    pay_sh = NamedSharding(mesh, P(pkt_ax) if pkt_ax else P())

    def tile_fn(buf, fill):
        pay_d = jax.device_put(jnp.asarray(buf, jnp.uint8), pay_sh)
        len_d = jax.device_put(jnp.asarray(fill, jnp.int32), pay_sh)
        return fn(*tabs, pay_d, len_d)

    return tile_fn, plan


def resolve_shard_mesh(shard_axis: str, n_dev: Optional[int] = None) -> Mesh:
    """The default mesh for a --shard-axis choice: 1-D packets (the classic
    mesh), 1-D patterns, or the most-square 2-D split for 'both'."""
    devs = np.asarray(jax.devices() if n_dev is None else
                      jax.devices()[:n_dev])
    if shard_axis == "patterns":
        return make_pattern_mesh(devs)
    if shard_axis == "both":
        n = devs.size
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        # Pattern axis gets the LARGER factor: the ~1/U law gives pattern
        # shards super-linear leverage on the big sets 'both' exists for.
        return make_2d_mesh(a, n // a, devs)
    from multithreading_string_matching.parallel.mesh import make_mesh

    return make_mesh(devs)


# --shard-axis auto shards the pattern axis above this many pattern words:
# each card then compiles and runs 1/N of the window engine's unrolled
# pattern groups.  Which axis is faster on four cards is not measured yet.
PATTERN_AXIS_MIN_WORDS = 512


def choose_shard_axis(matcher, n_dev: int) -> str:
    """'patterns' for sets of more than PATTERN_AXIS_MIN_WORDS pattern
    words (the ~1/U regime), 'packets' otherwise.  Used by the CLI's
    --shard-axis auto."""
    if n_dev <= 1:
        return "packets"
    _, _, total_words = matcher._pattern_stats()
    return "patterns" if total_words > PATTERN_AXIS_MIN_WORDS else "packets"
