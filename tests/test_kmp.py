import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching.models.kmp import (
    lps_table,
    kmp_dfa,
    stack_kmp_dfas,
    count_occurrences_host,
)


def run_dfa(dfa: np.ndarray, accept: int, text: bytes) -> int:
    s, n = 0, 0
    for b in text:
        s = int(dfa[s, b])
        n += s == accept
    return n


def test_lps_known_values():
    assert lps_table(b"ababaca").tolist() == [0, 0, 1, 2, 3, 0, 1]
    assert lps_table(b"aaaa").tolist() == [0, 1, 2, 3]
    assert lps_table(b"abcd").tolist() == [0, 0, 0, 0]
    assert lps_table(b"a").tolist() == [0]


def test_lps_rejects_empty():
    with pytest.raises(ValueError):
        lps_table(b"")


@pytest.mark.parametrize(
    "pattern,text,want",
    [
        (b"aa", b"aaaa", 3),          # overlaps counted
        (b"aba", b"ababa", 2),        # overlap at shared 'a'
        (b"abc", b"abcabc", 2),
        (b"abc", b"ab", 0),           # text shorter than pattern
        (b"a", b"aaa", 3),
        (b"xyz", b"abc", 0),
        (b"ab", b"", 0),
    ],
)
def test_dfa_counts(pattern, text, want):
    dfa = kmp_dfa(pattern)
    assert run_dfa(dfa, len(pattern), text) == want
    assert count_occurrences_host(text, pattern) == want
    assert count_overlapping(text, pattern) == want


def test_dfa_random_property():
    """DFA counting == naive overlapping counting on random binary data."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        m = int(rng.integers(1, 6))
        pattern = bytes(rng.integers(0, 4, size=m).astype(np.uint8))  # small alphabet -> matches
        text = bytes(rng.integers(0, 4, size=int(rng.integers(0, 64))).astype(np.uint8))
        dfa = kmp_dfa(pattern)
        assert run_dfa(dfa, m, text) == count_overlapping(text, pattern), (pattern, text)


def test_dfa_binary_bytes():
    """Payloads are raw bytes incl. NUL — no strlen truncation (variant A)."""
    pattern = b"\x00ab"
    text = b"x\x00ab\x00\x00ab"
    assert run_dfa(kmp_dfa(pattern), 3, text) == 2


def test_stacked_dfas():
    pats = [b"ab", b"abcd", b"b"]
    stacked, accept = stack_kmp_dfas(pats)
    assert stacked.shape == (3, 5, 256)
    assert accept.tolist() == [2, 4, 1]
    text = b"ababcdb"
    for i, p in enumerate(pats):
        assert run_dfa(stacked[i], int(accept[i]), text) == count_overlapping(text, p)
