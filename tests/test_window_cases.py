"""The XLA window engine on the edge cases of its word algebra, against
the oracle: every word-count class K, NUL patterns (exact fit masks), bytes
>= 0x80 in a word's top byte (words past int32's range), widths that are
not multiples of 4 or of the staging quantum, rows that end exactly at the
tensor edge, and halo-carried chunking with fabricated-zero halos."""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching import Matcher
from multithreading_string_matching.ops.window import (
    StreamHalo,
    WindowProgram,
    count_matches_window,
    find_matches,
    window_stream_chunk,
)

SETS = {
    "k1": [b"a", b"ab", b"bca", b"abcd", b"ab"],
    "k2": [b"ab", b"abcde", b"cabab", b"bbbbbbbb"],
    "k3": [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"],
    "k4": [b"abcabcabcabca", b"ab", b"cabcabcabcabcabc", b"c"],
    "nul_k1": [b"\x00a", b"a\x00\x00b", b"ab"],
    "nul_k2": [b"a\x00", b"\x00\x00\x00\x00\x00", b"ba\x00ab"],
    "high": [b"a\xff\xfe\xfd", b"\x80", b"ab\xffa\x80", b"\xfe\xfe"],
}


def _batch(seed, n, L, nul):
    """Rows over a 3-letter alphabet plus high bytes (and NUL when
    ``nul``), zero past each row's length; row 0 fills the full width."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(97, 100, size=(n, L)).astype(np.uint8)
    high = rng.random((n, L)) < 0.3
    payloads[high] = rng.choice(np.array([0x80, 0xFD, 0xFE, 0xFF], np.uint8),
                                size=int(high.sum()))
    if nul:
        payloads[rng.random((n, L)) < 0.2] = 0
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[0] = L
    cols = np.arange(L)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


def _texts(payloads, lengths):
    return [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]


@pytest.mark.parametrize("width", [37, 128, 200])
@pytest.mark.parametrize("name", sorted(SETS))
def test_window_engine_equals_oracle(name, width):
    """Totals, per-row counts and match positions equal the oracle."""
    pats = SETS[name]
    wp = WindowProgram.build(pats)
    payloads, lengths = _batch(width + len(name), 13, width,
                               nul=name.startswith("nul"))
    texts = _texts(payloads, lengths)
    want_rows = np.array([[count_overlapping(t, p) for p in pats]
                          for t in texts])
    got = np.asarray(count_matches_window(wp, payloads, lengths))
    assert (got == want_rows.sum(axis=0)).all()
    rows = np.asarray(count_matches_window(wp, payloads, lengths,
                                           per_packet=True))
    assert (rows == want_rows).all()
    found = find_matches(wp, payloads, lengths)
    for n, i, u in found:
        p = wp.unique_patterns[u]
        assert texts[n][i : i + len(p)] == p
    uniq = np.bincount(found[:, 2], minlength=len(wp.unique_patterns))
    assert (uniq[wp.dup_map] == got).all()


@pytest.mark.parametrize("name", sorted(SETS))
def test_halo_chunks_equal_oracle(name):
    """Halo-carried chunks with per-lane fabricated-zero halos count the
    matches that END in the chunk and start in real bytes — the flow-round
    rule — exactly like the oracle on [real halo | chunk]."""
    pats = SETS[name]
    wp = WindowProgram.build(pats)
    H = max(wp.max_len - 1, 1)
    rng = np.random.default_rng(len(name))
    F, C = 11, 45
    chunk, rel = _batch(7, F, C, nul=name.startswith("nul"))
    halo, _ = _batch(8, F, H, nul=name.startswith("nul"))
    fill = rng.integers(0, H + 1, size=F).astype(np.int32)
    for i in range(F):  # fabricated zeros in front of the real tail bytes
        halo[i, : H - fill[i]] = 0
    got, new = window_stream_chunk(wp, chunk, rel, StreamHalo(halo, fill))
    want = np.zeros(len(pats), np.int64)
    for i in range(F):
        real = halo[i, H - fill[i]:].tobytes()
        row = real + chunk[i, : rel[i]].tobytes()
        want += [count_overlapping(row, p) - count_overlapping(real, p)
                 for p in pats]
    assert (np.asarray(got) == want).all()
    assert (np.asarray(new.fill) == np.minimum(fill + C, H)).all()


@pytest.mark.parametrize("n", [1, 8, 17])
def test_matcher_counts_around_bucket_edges(n):
    """Matcher.count through bucketed tiles equals the oracle for row
    counts below, at and past a tile boundary."""
    pats = SETS["k3"]
    payloads, lengths = _batch(n, n, 96, nul=False)
    m = Matcher(pats)
    got = m.count(payloads, lengths, n_tile=8, l_quant=32)
    want = [sum(count_overlapping(t, p) for t in _texts(payloads, lengths))
            for p in pats]
    assert got.tolist() == want
