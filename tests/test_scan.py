"""Device-scan kernels vs the host oracle, incl. chunked/carried-state scans."""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching.models.aho_corasick import AhoCorasick
from multithreading_string_matching.models.kmp import stack_kmp_dfas
from multithreading_string_matching.ops.scan import (
    CompiledAC,
    count_matches_ac,
    count_matches_kmp,
)

PATS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab"]  # incl. a duplicate


def _random_batch(rng, n, lmax, alphabet=3):
    payloads = rng.integers(0, alphabet, size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    return payloads, lengths


def _oracle(payloads, lengths, pats):
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    return np.array([[count_overlapping(t, p) for p in pats] for t in texts])


@pytest.fixture(scope="module")
def compiled():
    ac = AhoCorasick.build(PATS)
    return ac, CompiledAC.from_automaton(ac)


def test_ac_scan_global_and_per_packet(compiled):
    ac, cac = compiled
    rng = np.random.default_rng(2)
    payloads, lengths = _random_batch(rng, 32, 40)
    want = _oracle(payloads, lengths, PATS)

    got = np.asarray(count_matches_ac(cac, payloads, lengths, dup_map=ac.dup_map))
    assert (got == want.sum(axis=0)).all()

    got_pp = np.asarray(
        count_matches_ac(cac, payloads, lengths, per_packet=True, dup_map=ac.dup_map)
    )
    assert (got_pp == want).all()


def test_ac_scan_masks_padding(compiled):
    """Bytes at positions >= length must not create matches."""
    ac, cac = compiled
    payloads = np.tile(np.frombuffer(b"abab", np.uint8), (4, 1))
    lengths = np.array([0, 2, 3, 4], dtype=np.int32)
    got = np.asarray(
        count_matches_ac(cac, payloads, lengths, per_packet=True, dup_map=ac.dup_map)
    )
    want = _oracle(payloads, lengths, PATS)
    assert (got == want).all()


def test_kmp_scan_matches_oracle():
    rng = np.random.default_rng(3)
    payloads, lengths = _random_batch(rng, 16, 30)
    dfas, accept = stack_kmp_dfas(PATS)
    want = _oracle(payloads, lengths, PATS)
    got = np.asarray(count_matches_kmp(dfas, accept, payloads, lengths))
    assert (got == want.sum(axis=0)).all()
    got_pp = np.asarray(
        count_matches_kmp(dfas, accept, payloads, lengths, per_packet=True)
    )
    assert (got_pp == want).all()


def test_engines_agree(compiled):
    ac, cac = compiled
    rng = np.random.default_rng(4)
    payloads, lengths = _random_batch(rng, 24, 50)
    dfas, accept = stack_kmp_dfas(PATS)
    a = np.asarray(count_matches_ac(cac, payloads, lengths, dup_map=ac.dup_map))
    k = np.asarray(count_matches_kmp(dfas, accept, payloads, lengths))
    assert (a == k).all()


def test_chunked_scan_carries_state(compiled):
    """Splitting the byte axis into chunks with carried DFA states must count
    chunk-straddling matches exactly once (SURVEY §5 long-context analogue)."""
    ac, cac = compiled
    rng = np.random.default_rng(5)
    payloads, lengths = _random_batch(rng, 16, 48)
    want = np.asarray(count_matches_ac(cac, payloads, lengths, dup_map=ac.dup_map))

    for chunk in (1, 5, 16, 48):
        states = None
        total = np.zeros(len(PATS), dtype=np.int64)
        for start in range(0, 48, chunk):
            rel_len = np.clip(lengths - start, 0, None).astype(np.int32)
            counts, states = count_matches_ac(
                cac,
                payloads[:, start : start + chunk],
                rel_len,
                initial_states=states if start else None,
                dup_map=ac.dup_map,
                return_states=True,
            )
            total += np.asarray(counts)
        assert (total == want).all(), f"chunk={chunk}"


def test_straddling_match_counted_once(compiled):
    """A match crossing a chunk boundary is found via carried state."""
    ac, cac = compiled
    text = b"cacab"  # 'ca' x2 (overlapping at index 2), 'ab' and 'b' at end
    payloads = np.frombuffer(text, np.uint8)[None, :].copy()
    lengths = np.array([5], dtype=np.int32)
    want = np.asarray(count_matches_ac(cac, payloads, lengths, dup_map=ac.dup_map))

    c1, st = count_matches_ac(
        cac, payloads[:, :3], lengths, dup_map=ac.dup_map, return_states=True
    )
    c2, _ = count_matches_ac(
        cac,
        payloads[:, 3:],
        (lengths - 3).astype(np.int32),
        initial_states=st,
        dup_map=ac.dup_map,
        return_states=True,
    )
    assert (np.asarray(c1) + np.asarray(c2) == want).all()


def test_empty_and_binary_payloads(compiled):
    ac, cac = compiled
    payloads = np.zeros((3, 8), dtype=np.uint8)
    payloads[1, :4] = np.frombuffer(b"\x00ab\x00", np.uint8)
    lengths = np.array([0, 4, 8], dtype=np.int32)
    got = np.asarray(
        count_matches_ac(cac, payloads, lengths, per_packet=True, dup_map=ac.dup_map)
    )
    want = _oracle(payloads, lengths, PATS)
    assert (got == want).all()
