"""Property test: all four engines == oracle on adversarial random inputs.

The fixtures exercise real traffic; this exercises the corners — binary
payloads with embedded NULs, zero-length rows, payloads shorter/equal/longer
than patterns, duplicate and overlapping patterns, single-byte patterns,
patterns containing NUL (which force the Pallas exact-fit kernel).
"""

import numpy as np
import pytest

import oracle
from multithreading_string_matching import Matcher

CASES = [
    # (seed, num_payloads, max_len, alphabet, patterns)
    (0, 17, 40, 4, [b"ab", b"aba", b"b", b"abab", b"ab", b"\x00a", b"ba"]),
    (1, 9, 200, 3, [b"aa", b"aaa", b"aaaa", b"a"]),          # heavy overlap
    (2, 33, 64, 256, [b"\x00", b"\xff\xfe", b"ab\x00cd"]),    # binary + NUL
    (3, 5, 13, 2, [b"abcdefghijkl", b"ab", b"ba", b"ab"]),    # pattern ~= payload len
    (4, 64, 128, 5, [bytes([a, b]) for a in range(3) for b in range(3)]),
    # 60-byte pattern -> K=15 packed words (the reference caps patterns at
    # 99 bytes via its fscanf buffer; long patterns must still be exact)
    (5, 12, 256, 7, [bytes(range(1, 61)), b"\x01\x02", bytes(range(1, 61))]),
]


@pytest.mark.parametrize("seed,n,lmax,alpha,pats", CASES)
def test_engines_match_oracle(seed, n, lmax, alpha, pats):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, alpha, size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    lengths[0] = 0          # always include an empty row
    lengths[-1] = lmax      # and a full-width row
    if len(pats[0]) <= lmax:  # plant a guaranteed hit of the first pattern
        payloads[-1, : len(pats[0])] = np.frombuffer(pats[0], np.uint8)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(n)]
    want = np.array(oracle.oracle_counts(texts, pats))

    m = Matcher(pats)
    for engine in ("window", "ac", "kmp"):
        got = m.count(payloads, lengths, engine=engine)
        assert (got == want).all(), engine
        got_pp = m.count(payloads, lengths, engine=engine, per_packet=True)
        assert (got_pp.sum(axis=0) == want).all(), f"{engine} per-packet"

    # The staged-tile path; prepare() sanitizes padding, so feed it
    # deliberately dirty buffers.
    dirty = payloads.copy()
    cols = np.arange(lmax)[None, :]
    dirty[cols >= lengths[:, None]] = 0xEE
    got = np.asarray(m.count_prepared(m.prepare(dirty, lengths)))
    assert (got == want).all(), "staged"


def _fold(b: bytes) -> bytes:
    return bytes(c + 32 if 65 <= c <= 90 else c for c in b)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_feature_combination_fuzz(seed):
    """nocase x binary(escaped-style) patterns x packed staging x engines,
    differential against the oracle with host-side folding."""
    rng = np.random.default_rng(seed)
    n, lmax = 24, 96
    # Mixed-case ASCII-ish payloads with some binary bytes.
    payloads = rng.integers(0, 256, size=(n, lmax)).astype(np.uint8)
    letters = rng.integers(65, 123, size=(n, lmax)).astype(np.uint8)
    use_letters = rng.random((n, lmax)) < 0.7
    payloads = np.where(use_letters, letters, payloads)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = lmax
    pats = [b"AbC", b"abc", b"XY\x00z", b"Q", b"abc"]  # dup + NUL + case
    payloads[-1, :3] = np.frombuffer(b"aBc", np.uint8)
    payloads[-2, 5:9] = np.frombuffer(b"xy\x00Z", np.uint8)
    lengths[-2] = max(lengths[-2], 9)

    texts = [_fold(payloads[i, : lengths[i]].tobytes()) for i in range(n)]
    want = np.array(oracle.oracle_counts(texts, [_fold(p) for p in pats]))

    m = Matcher(pats, case_insensitive=True)
    for engine in ("window", "ac", "kmp"):
        got = m.count(payloads, lengths, engine=engine)
        assert (got == want).all(), engine
    # Staged paths: 'auto' packing must refuse silently-inexact packing for
    # NUL patterns (falls back internally) and still match the oracle.
    for packed in ("auto", False):
        prep = m.prepare(payloads, lengths, packed=packed)
        got = np.asarray(m.count_prepared(prep, engine="window"))
        assert (got == want).all(), packed
    # Guaranteed hits so the test cannot pass vacuously.
    assert want[0] == want[1] == want[4] and want[0] >= 1
    assert want[2] >= 1
