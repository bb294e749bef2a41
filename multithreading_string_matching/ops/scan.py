"""Branch-free DFA byte-scan kernels (device side of components C7/C9).

The reference's hot loop is one branchy byte-at-a-time KMP iteration per
(packet, pattern) pair (serial.c:198-213, fanned out by OpenMP/MPI in the
other programs).  On a vector device the same work is expressed as a *vectorized state
machine*: a ``lax.scan`` over byte positions whose carry is the DFA state of
EVERY packet lane at once — one table gather per byte per lane, no branches,
no dynamic shapes.  Parallelism comes from the packet axis (thousands of
lanes), not from the inherently sequential byte axis.

Two kernels:

- :func:`count_matches_ac` — the fast path.  A single Aho-Corasick automaton
  consumes each byte once; per-pattern counts come from comparing the state
  trajectory against the automaton's emitting states (or, globally, from a
  state-visit histogram contracted with the emit matrix, in int32).

- :func:`count_matches_kmp` — the conformance path, structurally mirroring
  the reference: one DFA per pattern, all patterns advanced in lockstep over
  every packet ([P, N] carry).  Counts are bit-identical to serial.c's
  per-pattern kmp_matcher sums (variant A semantics).

Both kernels support carried state (``initial_states``/returned final states)
so payload streams can be scanned in chunks with matches that straddle chunk
boundaries counted exactly once (the reference never needs this because its
batch boundaries are packet boundaries; see SURVEY.md §5 "long-context").
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multithreading_string_matching.models.aho_corasick import AhoCorasick


class CompiledAC(NamedTuple):
    """Device-resident tensors of an Aho-Corasick automaton."""

    goto_flat: jax.Array    # int32[(S+1) * 256] row-major flattened goto table
    emit_sub: jax.Array     # int32[E, U] emit rows of the emitting states only
    emit_ids: jax.Array     # int32[E] emitting-state indices
    dead: int               # dead-state index (S)
    num_unique: int

    @staticmethod
    def from_automaton(ac: AhoCorasick) -> "CompiledAC":
        ids = ac.emitting_states
        return CompiledAC(
            goto_flat=jnp.asarray(ac.goto.reshape(-1), dtype=jnp.int32),
            emit_sub=jnp.asarray(ac.emit[ids], dtype=jnp.int32),
            emit_ids=jnp.asarray(ids, dtype=jnp.int32),
            dead=ac.dead_state,
            num_unique=int(ac.emit.shape[1]),
        )


def _as_device_u8(payloads) -> jax.Array:
    return jnp.asarray(payloads, dtype=jnp.uint8)


# ---------------------------------------------------------------------------
# Aho-Corasick scan
# ---------------------------------------------------------------------------


def ac_scan_chunk_impl(
    goto_flat: jax.Array,
    emit_ids: jax.Array,
    payloads: jax.Array,      # uint8[N, L] (a chunk of columns of the payload tensor)
    lengths: jax.Array,       # int32[N] length remaining relative to this chunk's start
    states: jax.Array,        # int32[N] carried DFA states
    dead: int,
    init_hist: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Advance every packet lane across one chunk of payload bytes.

    Returns ``(new_states, hist)`` where ``hist: int32[N, E]`` counts, per
    lane, how many valid positions inside this chunk ended in each emitting
    state.  Lanes whose payload ends inside the chunk HOLD their state at
    the last valid byte (masked positions transition nowhere and emit
    nothing) — so the returned state is exactly the DFA state after the
    lane's real bytes, and a later chunk can append MORE bytes to the same
    logical stream (the flow-streaming revival case, parallel/flow_stream).
    Counts are unchanged vs the older park-in-dead semantics: emission was
    already impossible at masked positions either way.  ``lengths`` must
    already be expressed relative to the chunk (callers subtract the
    chunk's start offset).  ``dead`` is kept in the signature for the
    jit-cache key but no longer drives the masking.

    ``init_hist`` overrides the zero histogram carry — the sharded path
    (parallel/mesh.py) passes a pcast-varying zero so the scan's carry types
    match under shard_map VMA tracking; semantics are unchanged.
    """
    cols = payloads.T  # [L, N] — scan over the byte axis, lanes contiguous
    n = cols.shape[1]
    e = emit_ids.shape[0]
    lengths = lengths.astype(jnp.int32)

    def step(carry, xs):
        st, hist = carry
        byte, pos = xs
        nxt = jnp.take(goto_flat, st * 256 + byte.astype(jnp.int32), axis=0)
        valid = pos < lengths
        nxt = jnp.where(valid, nxt, st)
        # Per-lane emitting-state hits, accumulated IN the carry (an [L,N,E]
        # scan output would materialize terabytes on large captures).  The
        # valid mask keeps held states from re-emitting at masked positions.
        hist = hist + (
            valid[:, None] & (nxt[:, None] == emit_ids[None, :])
        ).astype(jnp.int32)
        return (nxt, hist), None

    positions = jnp.arange(cols.shape[0], dtype=jnp.int32)
    if init_hist is None:
        init_hist = jnp.zeros((n, e), dtype=jnp.int32)
    init = (states, init_hist)
    (new_states, hist), _ = jax.lax.scan(step, init, (cols, positions))
    return new_states, hist


ac_scan_chunk = jax.jit(ac_scan_chunk_impl, static_argnames=("dead",))


def count_matches_ac(
    cac: CompiledAC,
    payloads,
    lengths,
    *,
    initial_states: Optional[jax.Array] = None,
    per_packet: bool = False,
    dup_map: Optional[np.ndarray] = None,
    return_states: bool = False,
):
    """Count every overlapping occurrence of every pattern in every payload.

    Returns counts over *unique* patterns (``int32[U]`` or ``int32[N, U]``),
    or over the original duplicated pattern list when ``dup_map`` is given.
    With ``return_states=True`` also returns the final per-lane DFA states
    for carried-state streaming.
    """
    payloads = _as_device_u8(payloads)
    lengths = jnp.asarray(lengths, dtype=jnp.int32)
    n = payloads.shape[0]
    if initial_states is None:
        states = jnp.zeros((n,), dtype=jnp.int32)
    else:
        states = jnp.asarray(initial_states, dtype=jnp.int32)

    new_states, hist = ac_scan_chunk(
        cac.goto_flat, cac.emit_ids, payloads, lengths, states, dead=cac.dead
    )
    if per_packet:
        counts = hist @ cac.emit_sub  # [N, E] @ [E, U] -> [N, U]
    else:
        counts = hist.sum(axis=0) @ cac.emit_sub  # [E] @ [E, U] -> [U]
    if dup_map is not None:
        counts = jnp.take(counts, jnp.asarray(dup_map, dtype=jnp.int32), axis=-1)
    if return_states:
        return counts, new_states
    return counts


# ---------------------------------------------------------------------------
# Per-pattern KMP scan (conformance path)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("per_packet",))
def _kmp_scan(
    dfas_flat: jax.Array,    # int32[P * M * 256]
    accept: jax.Array,       # int32[P]
    payloads: jax.Array,     # uint8[N, L]
    lengths: jax.Array,      # int32[N]
    num_states: int | jax.Array,
    per_packet: bool = False,
):
    cols = payloads.T  # [L, N]
    n = cols.shape[1]
    p = accept.shape[0]
    lengths = lengths.astype(jnp.int32)
    base = (jnp.arange(p, dtype=jnp.int32) * (num_states * 256))[:, None]  # [P, 1]

    def step(carry, xs):
        st, cnt = carry               # st, cnt: int32[P, N]
        byte, pos = xs
        idx = base + st * 256 + byte[None, :].astype(jnp.int32)
        nxt = jnp.take(dfas_flat, idx, axis=0)
        valid = (pos < lengths)[None, :]
        nxt = jnp.where(valid, nxt, st)
        cnt = cnt + (jnp.equal(nxt, accept[:, None]) & valid).astype(jnp.int32)
        return (nxt, cnt), None

    init = (
        jnp.zeros((p, n), dtype=jnp.int32),
        jnp.zeros((p, n), dtype=jnp.int32),
    )
    positions = jnp.arange(cols.shape[0], dtype=jnp.int32)
    (st, cnt), _ = jax.lax.scan(step, init, (cols, positions))
    if per_packet:
        return cnt.T  # [N, P]
    return cnt.sum(axis=1)  # [P]


def count_matches_kmp(
    dfas: np.ndarray,        # int32[P, M, 256] stacked per-pattern DFAs
    accept: np.ndarray,      # int32[P]
    payloads,
    lengths,
    *,
    per_packet: bool = False,
):
    """Reference-shaped counting: one KMP DFA per pattern, vmapped over lanes.

    Bit-identical to summing serial.c's kmp_matcher over packets under the
    explicit-length reading (variant A) — the conformance oracle's kernel.
    """
    dfas = np.asarray(dfas, dtype=np.int32)
    p, m, _ = dfas.shape
    return _kmp_scan(
        jnp.asarray(dfas.reshape(-1)),
        jnp.asarray(accept, dtype=jnp.int32),
        _as_device_u8(payloads),
        jnp.asarray(lengths, dtype=jnp.int32),
        m,
        per_packet=per_packet,
    )
