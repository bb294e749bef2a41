"""Aho-Corasick multi-pattern counting automaton.

The reference runs KMP once per (packet, pattern) pair — 97 passes over every
payload (serial.c:153-155).  Redesign: compile ALL patterns into a
single Aho-Corasick automaton so each payload byte is consumed ONCE:

    state = goto[state, byte]            # one gather per byte

and per-pattern counts fall out of a *state-visit histogram*:

    counts[u] = sum_s visits[s] * emit[s, u]

because ``emit[s, u] == 1`` iff pattern u ends at state s (via suffix links).
That final contraction is a dense int32 ``[S] x [S, U]`` product, and
the per-byte loop carries no per-pattern state at all.  Counts are exactly
the overlapping-occurrence counts of the per-pattern KMP DFAs (both count,
for each pattern, the number of text positions where it ends).

Built entirely on the host in numpy; the device sees three dense tensors:

- ``goto``  int32[S+1, 256] — failure-closed transition table; row S is a
  DEAD self-loop state used to park padding lanes so they add no visits.
- ``emit``  float32/int32[S+1, U] — per-state pattern-end indicator matrix
  (row S is zero).
- ``dup_map`` int32[P] — original pattern index -> unique pattern index
  (strings.txt contains duplicate tokens; they share counts but are reported
  as independent entries, serial.c:163-166).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

ALPHABET = 256


@dataclass(frozen=True)
class AhoCorasick:
    goto: np.ndarray        # int32[S+1, 256], failure-closed; row S = dead self-loop
    emit: np.ndarray        # int32[S+1, U]   pattern-end indicators
    dup_map: np.ndarray     # int32[P]        original -> unique index
    patterns: Tuple[bytes, ...]         # original pattern list (duplicates kept)
    unique_patterns: Tuple[bytes, ...]  # deduplicated, first-occurrence order

    @property
    def num_states(self) -> int:
        return int(self.goto.shape[0]) - 1

    @property
    def dead_state(self) -> int:
        return int(self.goto.shape[0]) - 1

    @property
    def emitting_states(self) -> np.ndarray:
        """Indices of states with at least one pattern ending there."""
        return np.nonzero(self.emit.sum(axis=1) > 0)[0].astype(np.int32)

    def expand_counts(self, unique_counts: np.ndarray) -> np.ndarray:
        """Map per-unique-pattern counts back to the original (duplicated) list."""
        return np.asarray(unique_counts)[..., self.dup_map]

    @staticmethod
    def build(patterns: Sequence[bytes]) -> "AhoCorasick":
        pats = [bytes(p) for p in patterns]
        if not pats:
            raise ValueError("no patterns")
        if any(len(p) == 0 for p in pats):
            raise ValueError("empty pattern")

        uniq: List[bytes] = []
        index: Dict[bytes, int] = {}
        dup_map = np.zeros(len(pats), dtype=np.int32)
        for i, p in enumerate(pats):
            if p not in index:
                index[p] = len(uniq)
                uniq.append(p)
            dup_map[i] = index[p]

        # Trie construction.
        children: List[Dict[int, int]] = [{}]
        terminal: List[List[int]] = [[]]
        for u, p in enumerate(uniq):
            s = 0
            for c in p:
                nxt = children[s].get(c)
                if nxt is None:
                    nxt = len(children)
                    children[s][c] = nxt
                    children.append({})
                    terminal.append([])
                s = nxt
            terminal[s].append(u)

        S = len(children)
        goto = np.zeros((S + 1, ALPHABET), dtype=np.int32)
        emit = np.zeros((S + 1, len(uniq)), dtype=np.int32)
        fail = np.zeros(S, dtype=np.int32)

        for s, us in enumerate(terminal):
            for u in us:
                emit[s, u] = 1

        # BFS failure links + failure closure of goto (standard construction).
        q: deque = deque()
        for c in range(ALPHABET):
            nxt = children[0].get(c, 0)
            goto[0, c] = nxt
            if nxt:
                fail[nxt] = 0
                q.append(nxt)
        while q:
            s = q.popleft()
            emit[s] |= emit[fail[s]]   # suffix outputs accumulate down the BFS
            for c in range(ALPHABET):
                nxt = children[s].get(c)
                if nxt is None:
                    goto[s, c] = goto[fail[s], c]
                else:
                    fail[nxt] = goto[fail[s], c]
                    goto[s, c] = nxt
                    q.append(nxt)

        # Dead state: self-loop, zero emit — parks padding/finished lanes.
        goto[S, :] = S

        return AhoCorasick(
            goto=goto,
            emit=emit,
            dup_map=dup_map,
            patterns=tuple(pats),
            unique_patterns=tuple(uniq),
        )
