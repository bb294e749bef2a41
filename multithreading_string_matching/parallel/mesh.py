"""Distributed data-parallel matching over a device mesh (component C13).

The reference's distributed path (mpi_dumping.c) is: rank 0 reads the whole
pcap (:107-134), MPI_Scatterv ships 65,539-byte fixed records to every rank
(:161), each rank extracts + matches its shard (:173-200), and per-pattern
counts are MPI_Reduce(SUM)-merged to rank 0 (:202).

Device-mesh redesign:

- the device mesh replaces the MPI communicator: ``Mesh(devices, ("packets",))``;
- there is NO Scatterv — the packet axis of the payload tensor is sharded
  with a ``NamedSharding``/``shard_map``, and on multi-host deployments each
  host reads its own pcap byte-range directly
  (:func:`io.pcap.read_pcap_range`), removing the reference's rank-0 I/O
  funnel (its scalability bottleneck);
- the automaton (goto/emit tables) is replicated, exactly as every MPI rank
  re-reads strings.txt and rebuilds its prefix tables (mpi_dumping.c:75-97);
- the count merge is ``jax.lax.psum`` over the mesh — XLA hands it to NCCL
  (NVLink between the cards of a host), instead of MPI over TCP.

Counts are integers, so the reduction is exact and order-independent: the
sharded result is bit-identical to the single-device scan for any device
count (tested on the 8-way CPU mesh).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multithreading_string_matching.ops.scan import CompiledAC

PACKET_AXIS = "packets"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None, axis: str = PACKET_AXIS) -> Mesh:
    """A 1-D mesh over the packet (data-parallel) axis.

    Multi-host: pass ``jax.devices()`` after ``jax.distributed.initialize()``
    and every process participates, exactly like MPI ranks after MPI_Init —
    but with XLA collectives instead of MPI_Reduce.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis,))


def _staged_window(matcher):
    """The matcher's WindowProgram pattern tables as device arrays, staged
    ONCE and cached on the matcher (WindowProgram is a NamedTuple — no
    attribute slots) — the sharded entry points run per chunk of a stream,
    and re-running jnp.asarray on the numpy tables would re-upload them
    every chunk."""
    w = matcher.window
    staged = getattr(matcher, "_staged_window_tables", None)
    if staged is None or staged[0] is not w:
        staged = (
            w,
            jnp.asarray(w.pat_words),
            jnp.asarray(w.pat_masks),
            jnp.asarray(w.pat_lens),
        )
        matcher._staged_window_tables = staged
    return staged[1], staged[2], staged[3]


def shard_batch(
    payloads: np.ndarray, lengths: np.ndarray, mesh: Mesh
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the packet axis so it divides the mesh (padding rows are length-0,
    which the scan masks out — the analogue of mpi_dumping.c's remainder
    handling at :149-151, without giving rank 0 extra work)."""
    n_dev = mesh.devices.size
    n = payloads.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    if n_pad != n:
        payloads = np.pad(payloads, ((0, n_pad - n), (0, 0)))
        lengths = np.pad(lengths, (0, n_pad - n))
    return payloads, lengths


@functools.partial(
    jax.jit, static_argnames=("dead", "mesh", "axis")
)
def _sharded_count(
    goto_flat: jax.Array,
    emit_ids: jax.Array,
    emit_sub: jax.Array,
    payloads: jax.Array,
    lengths: jax.Array,
    dead: int,
    mesh: Mesh,
    axis: str,
) -> jax.Array:
    """One SPMD program: local DFA scan on each device's packet shard, then a
    psum of the per-emitting-state visit histogram (the MPI_Reduce analogue).
    The [E] @ [E, U] emit contraction runs replicated after the collective —
    it is tiny, and reducing the [E] histogram instead of per-pattern counts
    keeps the collective payload minimal."""

    def local(goto_flat, emit_ids, emit_sub, payloads, lengths):
        from multithreading_string_matching.ops.scan import (
            ac_scan_chunk_impl,
        )

        n = payloads.shape[0]
        e = emit_ids.shape[0]
        # The carry is per-shard data: mark it varying over the mesh axis so
        # the scan's carry types match (shard_map VMA tracking).
        init_states, init_hist = jax.lax.pcast(
            (jnp.zeros((n,), jnp.int32), jnp.zeros((n, e), jnp.int32)),
            (axis,),
            to="varying",
        )
        _, hist = ac_scan_chunk_impl(
            goto_flat, emit_ids, payloads, lengths, init_states, dead,
            init_hist=init_hist,
        )
        local_hist = hist.sum(axis=0)                      # [E] per shard
        global_hist = jax.lax.psum(local_hist, axis)       # MPI_Reduce(SUM)
        return global_hist @ emit_sub                      # [U], replicated

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis)),
        out_specs=P(),
    )(goto_flat, emit_ids, emit_sub, payloads, lengths)


@functools.partial(jax.jit, static_argnames=("dead", "mesh", "axis"))
def _sharded_chunk(
    goto_flat: jax.Array,
    emit_ids: jax.Array,
    emit_sub: jax.Array,
    payloads: jax.Array,    # uint8[F, W] flow-lane chunk, sharded on F
    lengths: jax.Array,     # int32[F] bytes valid in this chunk
    states: jax.Array,      # int32[F] carried DFA states, sharded with lanes
    dead: int,
    mesh: Mesh,
    axis: str,
) -> Tuple[jax.Array, jax.Array]:
    """Carried-state AC chunk scan with FLOW LANES sharded over the mesh —
    the pod-scale form of parallel/flow_stream's scan round.  States ride
    with their shard in AND out (``P(axis)`` both ways — a flow never
    migrates between devices mid-stream), so the only cross-chip traffic
    is the [E] emit histogram psum per chunk; masked positions HOLD lane
    state (ops/scan.py), which is what makes the next round's revival of
    the same flows exact."""

    def local(goto_flat, emit_ids, emit_sub, payloads, lengths, states):
        from multithreading_string_matching.ops.scan import (
            ac_scan_chunk_impl,
        )

        n = payloads.shape[0]
        e = emit_ids.shape[0]
        (init_hist,) = jax.lax.pcast(
            (jnp.zeros((n, e), jnp.int32),), (axis,), to="varying"
        )
        new_states, hist = ac_scan_chunk_impl(
            goto_flat, emit_ids, payloads, lengths, states, dead,
            init_hist=init_hist,
        )
        local_hist = hist.sum(axis=0)
        counts = jax.lax.psum(local_hist, axis) @ emit_sub
        return counts, new_states

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(axis)),
    )(goto_flat, emit_ids, emit_sub, payloads, lengths, states)


def count_chunk_sharded(
    cac: CompiledAC,
    payloads,
    lengths,
    states,
    mesh: Mesh,
    *,
    dup_map: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, jax.Array]:
    """Public wrapper over :func:`_sharded_chunk`: returns ``(counts,
    new_states)`` with counts over unique patterns (or dup-expanded when
    ``dup_map`` is given).  The lane count must divide evenly over the
    mesh; flow_stream's pow2 lane quantization guarantees it."""
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    payloads = jax.device_put(jnp.asarray(payloads, jnp.uint8), sharding)
    lengths = jax.device_put(jnp.asarray(lengths, jnp.int32), sharding)
    states = jax.device_put(jnp.asarray(states, jnp.int32), sharding)
    counts, new_states = _sharded_chunk(
        cac.goto_flat, cac.emit_ids, cac.emit_sub, payloads, lengths,
        states, cac.dead, mesh, axis,
    )
    if dup_map is not None:
        counts = jnp.take(counts, jnp.asarray(dup_map, jnp.int32), axis=-1)
    return counts, new_states


@functools.partial(jax.jit, static_argnames=("min_end", "mesh", "axis"))
def _sharded_window_halo(
    pat_words: jax.Array,
    pat_masks: jax.Array,
    pat_lens: jax.Array,
    x: jax.Array,         # uint8[R, H + CW] sub-lane round tile, sharded on R
    eff: jax.Array,       # int32[R] valid bytes per sub-lane (incl. halo)
    ms: jax.Array,        # int32[R] first column a match may START at
    min_end: int,         # H: a match counts where its END falls
    mesh: Mesh,
    axis: str,
) -> jax.Array:
    """Window-engine flow ROUND with the sub-lane axis sharded: each device
    scans its rows with min_end/min_start masking (the same algebra as
    window_stream_chunk), one [U] psum merges counts.  Lane tails are HOST state in
    the flow stream (revival-exact), so unlike the AC form no carried state
    crosses rounds on device — which is what makes the window engine
    shardable at all."""
    from multithreading_string_matching.ops.window import _window_one

    def local(pw, pm, pl, x, eff, ms):
        counts = _window_one(
            pw, pm, pl, x, eff, per_packet=False, min_end=min_end,
            min_start=ms.reshape(1, -1, 1),
        )
        return jax.lax.psum(counts, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )(pat_words, pat_masks, pat_lens, x, eff, ms)


def count_flow_round_sharded(matcher, x2, eff2, ms2, mesh: Mesh):
    """One sharded window-engine flow round over a SUB-LANE tile
    (FlowStreamMatcher._expand_round_lanes's layout): device [U] unique
    counts (replicated after the psum; caller accumulates device-side and
    dup-expands at drain)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    R = x2.shape[0]
    R_pad = -(-R // n_dev) * n_dev
    if R_pad != R:  # padding sub-lanes: all-zero, eff 0 -> count 0
        x2 = np.pad(np.asarray(x2), ((0, R_pad - R), (0, 0)))
        eff2 = np.pad(np.asarray(eff2), (0, R_pad - R))
        ms2 = np.pad(np.asarray(ms2), (0, R_pad - R))
    sharding = NamedSharding(mesh, P(axis))
    x_d = jax.device_put(jnp.asarray(x2, jnp.uint8), sharding)
    eff_d = jax.device_put(jnp.asarray(eff2, jnp.int32), sharding)
    ms_d = jax.device_put(jnp.asarray(ms2, jnp.int32), sharding)
    H = max(int(matcher.window.max_len) - 1, 1)
    pw, pmk, plv = _staged_window(matcher)
    return _sharded_window_halo(
        pw, pmk, plv, x_d, eff_d, ms_d, min_end=H, mesh=mesh, axis=axis,
    )


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_count_window(
    pat_words: jax.Array,
    pat_masks: jax.Array,
    pat_lens: jax.Array,
    payloads: jax.Array,
    lengths: jax.Array,
    mesh: Mesh,
    axis: str,
) -> jax.Array:
    """Window-engine SPMD counting: each device runs the gather-free
    shifted-window matcher on its packet shard, then one psum merges the
    per-unique-pattern counts (the fast-path flavor of the MPI_Reduce
    analogue)."""
    from multithreading_string_matching.ops.window import _window_one

    def local(pw, pm, pl, payloads, lengths):
        counts = _window_one(pw, pm, pl, payloads, lengths, per_packet=False)
        return jax.lax.psum(counts, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis)),
        out_specs=P(),
    )(pat_words, pat_masks, pat_lens, payloads, lengths)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_rows_window(
    pat_words: jax.Array,
    pat_masks: jax.Array,
    pat_lens: jax.Array,
    payloads: jax.Array,
    lengths: jax.Array,
    mesh: Mesh,
    axis: str,
) -> jax.Array:
    """Row-sharded PER-PACKET counts int32[N, U]: each device scans its
    packet shard and keeps its rows — attribution needs row identity, so
    the output stays sharded over the mesh axis (no psum; the collective-
    free flavor of data parallelism)."""
    from multithreading_string_matching.ops.window import _window_one

    def local(pw, pm, pl, payloads, lengths):
        return _window_one(pw, pm, pl, payloads, lengths, per_packet=True)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis)),
        out_specs=P(axis),
    )(pat_words, pat_masks, pat_lens, payloads, lengths)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_rows_summary_window(
    pat_words: jax.Array,
    pat_masks: jax.Array,
    pat_lens: jax.Array,
    payloads: jax.Array,
    lengths: jax.Array,
    mesh: Mesh,
    axis: str,
) -> Tuple[jax.Array, jax.Array]:
    """Attribution SUMMARY over the mesh: each device scans its packet shard
    per-row, but only ``(psum'd unique totals int32[U], row-hit flags
    bool[n])`` leave the devices — the full [n, U] matrix never crosses the
    host link (it is what the streamed attribution consumer reduces to
    anyway).  Same int32 bound as the local summary: < 2^31 scanned
    positions per call."""
    from multithreading_string_matching.ops.window import _window_one

    def local(pw, pm, pl, payloads, lengths):
        rows = _window_one(pw, pm, pl, payloads, lengths, per_packet=True)
        return jax.lax.psum(rows.sum(axis=0), axis), rows.sum(axis=1) > 0

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(axis)),
    )(pat_words, pat_masks, pat_lens, payloads, lengths)


# One dispatch of the attribution summary must scan fewer positions than
# this, or its device int32 totals could wrap (a position starts at most
# one match per pattern).  Module-level so tests can lower it.
SUMMARY_MAX_POSITIONS = 2**31


def count_rows_summary(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique totals int64[U] in build order, row_hits bool[N])`` with the
    per-row scan sharded over the mesh and the reduction DONE ON DEVICE —
    the transfer-diet flavor of :func:`count_rows_sharded` for consumers
    (streamed attribution) that only need totals + which-rows-hit.  Feeds
    that would scan >= SUMMARY_MAX_POSITIONS in one dispatch are sliced
    internally (int64 host accumulation across slices), so any feed size is
    exact."""

    def once(payloads, lengths):
        axis = mesh.axis_names[0]
        n = int(np.shape(payloads)[0])
        payloads = matcher._maybe_fold(np.asarray(payloads))
        payloads, lengths = shard_batch(payloads, np.asarray(lengths), mesh)
        sharding = NamedSharding(mesh, P(axis))
        pay_d = jax.device_put(jnp.asarray(payloads, jnp.uint8), sharding)
        len_d = jax.device_put(jnp.asarray(lengths, jnp.int32), sharding)
        pw, pm, pl = _staged_window(matcher)
        tot, hits = _sharded_rows_summary_window(
            pw, pm, pl, pay_d, len_d, mesh=mesh, axis=axis,
        )
        return np.asarray(tot).astype(np.int64), np.asarray(hits)[:n]

    n, L = int(np.shape(payloads)[0]), int(np.shape(payloads)[1])
    if n * max(L, 1) < SUMMARY_MAX_POSITIONS:
        return once(payloads, lengths)
    n_dev = mesh.devices.size
    # STRICTLY below the bound (step*L == 2^31 exactly would still wrap a
    # saturating pattern); flooring to a mesh-divisible count only shrinks
    # it, except the one-row-per-device floor, which is guarded.
    step = max((SUMMARY_MAX_POSITIONS - 1) // max(L, 1), 1)
    step = max(step // n_dev, 1) * n_dev  # keep slices mesh-divisible
    if step * L >= SUMMARY_MAX_POSITIONS:
        raise ValueError(
            f"rows of {L} bytes cannot be sliced below the device int32 "
            f"bound on a {n_dev}-device mesh"
        )
    tot = np.zeros(len(matcher.window.unique_patterns), dtype=np.int64)
    hit_parts = []
    lengths = np.asarray(lengths)
    for s in range(0, n, step):
        t, h = once(payloads[s : s + step], lengths[s : s + step])
        tot += t
        hit_parts.append(h)
    return tot, np.concatenate(hit_parts)


def count_rows_sharded(
    matcher,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    expand_duplicates: bool = True,
) -> np.ndarray:
    """Per-packet counts [N, U or P] with the heavy scan sharded over the
    mesh (rows stay with their shard; no collective).  Pads the packet axis
    to the mesh and slices the padding back off, so the caller sees exactly
    its N rows."""
    axis = mesh.axis_names[0]
    n = int(np.shape(payloads)[0])
    payloads = matcher._maybe_fold(np.asarray(payloads))
    payloads, lengths = shard_batch(payloads, np.asarray(lengths), mesh)
    sharding = NamedSharding(mesh, P(axis))
    pay_d = jax.device_put(jnp.asarray(payloads, jnp.uint8), sharding)
    len_d = jax.device_put(jnp.asarray(lengths, jnp.int32), sharding)
    pw, pm, pl = _staged_window(matcher)
    out = _sharded_rows_window(pw, pm, pl, pay_d, len_d, mesh=mesh, axis=axis)
    out = np.asarray(out)[:n]
    if expand_duplicates:
        out = out[:, matcher.window.dup_map]
    return out


def count_matches_sharded(
    cac: CompiledAC,
    payloads,
    lengths,
    mesh: Mesh,
    *,
    dup_map: Optional[np.ndarray] = None,
    engine: str = "ac",
    window=None,
) -> np.ndarray:
    """Packet-sharded multi-device counting; bit-identical to the 1-device scan.

    ``engine='window'`` (pass the ``WindowProgram`` as ``window``) uses the
    fast shifted-window matcher per shard instead of the AC DFA scan.
    """
    axis = mesh.axis_names[0]
    payloads, lengths = shard_batch(np.asarray(payloads), np.asarray(lengths), mesh)
    sharding = NamedSharding(mesh, P(axis))
    payloads = jax.device_put(jnp.asarray(payloads, jnp.uint8), sharding)
    lengths = jax.device_put(jnp.asarray(lengths, jnp.int32), sharding)
    if engine == "window":
        assert window is not None, "pass window=WindowProgram for engine='window'"
        counts = _sharded_count_window(
            jnp.asarray(window.pat_words),
            jnp.asarray(window.pat_masks),
            jnp.asarray(window.pat_lens),
            payloads, lengths, mesh=mesh, axis=axis,
        )
    else:
        counts = _sharded_count(
            cac.goto_flat, cac.emit_ids, cac.emit_sub,
            payloads, lengths, dead=cac.dead, mesh=mesh, axis=axis,
        )
    counts = np.asarray(counts)
    if dup_map is not None:
        counts = counts[dup_map]
    return counts
