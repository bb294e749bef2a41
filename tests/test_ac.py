import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching.models.aho_corasick import AhoCorasick


def run_ac(ac: AhoCorasick, text: bytes) -> np.ndarray:
    """Host-side automaton walk: per-unique-pattern counts."""
    counts = np.zeros(len(ac.unique_patterns), dtype=np.int64)
    s = 0
    for b in text:
        s = int(ac.goto[s, b])
        counts += ac.emit[s]
    return counts


def naive(ac: AhoCorasick, text: bytes) -> np.ndarray:
    return np.array([count_overlapping(text, p) for p in ac.unique_patterns])


def test_basic_multi_pattern():
    ac = AhoCorasick.build([b"he", b"she", b"his", b"hers"])
    got = run_ac(ac, b"ushers")
    assert got.tolist() == [1, 1, 0, 1]  # he, she, hers


def test_suffix_pattern_emitted():
    """A pattern that is a suffix of another must fire on the longer one's path."""
    ac = AhoCorasick.build([b"abcd", b"bcd", b"cd", b"d"])
    got = run_ac(ac, b"abcd")
    assert got.tolist() == [1, 1, 1, 1]


def test_duplicates_share_counts():
    ac = AhoCorasick.build([b"ack", b"x", b"ack", b"ack"])
    assert len(ac.unique_patterns) == 2
    assert ac.dup_map.tolist() == [0, 1, 0, 0]
    u = run_ac(ac, b"ackack")
    full = ac.expand_counts(u)
    assert full.tolist() == [2, 0, 2, 2]


def test_overlapping_counts():
    ac = AhoCorasick.build([b"aa", b"aaa"])
    got = run_ac(ac, b"aaaa")
    assert got.tolist() == [3, 2]


def test_random_property_vs_naive():
    rng = np.random.default_rng(1)
    for _ in range(50):
        k = int(rng.integers(1, 8))
        pats = []
        for _ in range(k):
            m = int(rng.integers(1, 5))
            pats.append(bytes(rng.integers(0, 3, size=m).astype(np.uint8)))
        ac = AhoCorasick.build(pats)
        text = bytes(rng.integers(0, 3, size=int(rng.integers(0, 100))).astype(np.uint8))
        got = run_ac(ac, text)
        assert (got == naive(ac, text)).all(), (pats, text)


def test_dead_state_is_inert():
    ac = AhoCorasick.build([b"ab"])
    d = ac.dead_state
    assert (ac.goto[d] == d).all()
    assert (ac.emit[d] == 0).all()


def test_emitting_states():
    ac = AhoCorasick.build([b"ab", b"b"])
    ids = ac.emitting_states
    assert (ac.emit[ids].sum(axis=1) > 0).all()
    # state for "ab" emits both "ab" and the suffix "b"
    assert ac.emit[ids].sum() == 3  # "b" node, "ab" node (emits 2)
