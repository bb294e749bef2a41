"""KMP failure function and per-pattern counting DFAs (components C6, C7).

The reference builds the classic LPS ("longest proper prefix that is also a
suffix") table per pattern (kmp_prefix, serial.c:217-238) and runs a branchy
per-byte matcher (kmp_matcher, serial.c:190-215) that counts OVERLAPPING
occurrences: on a full match it records one occurrence and falls back to
``prefix[m-1]`` (serial.c:203-206), i.e. every position at which the pattern
ends is counted.

A branchy while-loop is the wrong shape for a vector device, so the LPS table is
compiled here — once, on the host — into a dense goto table
``delta: int32[m+1, 256]`` with the failure closure folded in.  The device
inner loop is then branch-free::

    state  = delta[state, byte]
    count += (state == m)

which counts exactly the reference's overlapping occurrences: ``state`` after
consuming a byte is the length of the longest pattern prefix that is a suffix
of the text so far (capped via the match restart ``delta[m] = delta[lps[m-1]]``),
and it equals ``m`` precisely at positions where an occurrence ends.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

ALPHABET = 256


def lps_table(pattern: bytes) -> np.ndarray:
    """Longest-proper-prefix-suffix table, serial.c:217-238 semantics.

    lps[i] = length of the longest proper prefix of pattern[:i+1] that is
    also a suffix of it.
    """
    m = len(pattern)
    if m == 0:
        raise ValueError("empty pattern")
    lps = np.zeros(m, dtype=np.int32)
    j = 0
    for i in range(1, m):
        while j > 0 and pattern[i] != pattern[j]:
            j = int(lps[j - 1])
        if pattern[i] == pattern[j]:
            j += 1
        lps[i] = j
    return lps


def kmp_dfa(pattern: bytes) -> np.ndarray:
    """Dense counting DFA ``delta: int32[m+1, 256]`` for one pattern.

    States 0..m-1 are "matched a prefix of this length"; state m means "an
    occurrence just ended here".  Transitions out of state m first apply the
    reference's match restart j = lps[m-1] (serial.c:205), so overlapping
    occurrences chain exactly as kmp_matcher does.
    """
    p = np.frombuffer(bytes(pattern), dtype=np.uint8)
    m = len(p)
    lps = lps_table(pattern)
    delta = np.zeros((m + 1, ALPHABET), dtype=np.int32)
    # State 0: advance to 1 on the first byte, stay otherwise.
    delta[0, p[0]] = 1
    for s in range(1, m):
        # Mismatch transitions replicate the failure state's row...
        delta[s] = delta[lps[s - 1]]
        # ...and the matching byte advances.
        delta[s, p[s]] = s + 1
    # Accept state: restart from lps[m-1] (overlap-preserving).
    delta[m] = delta[lps[m - 1]]
    return delta


def stack_kmp_dfas(patterns: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-pattern DFAs into one ``int32[P, m_max+1, 256]`` tensor.

    Shorter patterns' pad rows (states beyond their accept) are zero-filled
    and UNREACHABLE — the scan restarts at ``lps`` on accept, never entering
    them — so the vmapped scan can run all patterns in lockstep;
    ``accept: int32[P]`` gives each pattern's accept-state index (its
    length).  Do not scan past a pattern's accept row without parking logic.
    """
    if not patterns:
        raise ValueError("no patterns")
    dfas = [kmp_dfa(p) for p in patterns]
    m_max = max(len(p) for p in patterns)
    out = np.zeros((len(patterns), m_max + 1, ALPHABET), dtype=np.int32)
    accept = np.zeros(len(patterns), dtype=np.int32)
    for i, (p, d) in enumerate(zip(patterns, dfas)):
        out[i, : d.shape[0]] = d
        # Pad rows (states beyond m) are unreachable; leave as zeros.
        accept[i] = len(p)
    return out, accept


def count_occurrences_host(text: bytes, pattern: bytes) -> int:
    """Host-side overlapping-occurrence counter (oracle helper).

    Counts positions where ``pattern`` ends inside ``text`` — exactly what
    kmp_matcher returns under the explicit-length reading (BASELINE.md
    variant A).
    """
    if len(text) < len(pattern):
        return 0
    count = 0
    start = 0
    while True:
        idx = text.find(pattern, start)
        if idx < 0:
            return count
        count += 1
        start = idx + 1
