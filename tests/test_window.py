"""Shifted-window matcher vs oracle, incl. word packing and bucketing."""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching.ops.window import (
    WindowProgram,
    count_matches_window,
)
from multithreading_string_matching.ops.bucketing import bucket_plan, run_bucketed

PATS = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab", b"abcdefgh", b"abcde"]


def _oracle(payloads, lengths, pats):
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    return np.array([[count_overlapping(t, p) for p in pats] for t in texts])


def test_word_packing():
    wp = WindowProgram.build([b"abcde"])
    assert wp.pat_words.shape == (1, 2)
    assert wp.pat_masks[0].tolist() == [0xFFFFFFFF, 0xFF]
    assert wp.pat_words[0, 0] == int.from_bytes(b"abcd", "little")
    assert wp.pat_words[0, 1] == ord("e")
    wp3 = WindowProgram.build([b"abc"])
    assert wp3.pat_masks[0, 0] == 0xFFFFFF


def test_matches_oracle_random():
    rng = np.random.default_rng(7)
    wp = WindowProgram.build(PATS)
    payloads = rng.integers(0, 3, size=(32, 50)).astype(np.uint8)
    lengths = rng.integers(0, 51, size=32).astype(np.int32)
    want = _oracle(payloads, lengths, PATS)
    got = np.asarray(count_matches_window(wp, payloads, lengths))
    assert (got == want.sum(axis=0)).all()
    got_pp = np.asarray(count_matches_window(wp, payloads, lengths, per_packet=True))
    assert (got_pp == want).all()


def test_masks_padding_and_length():
    wp = WindowProgram.build(PATS)
    payloads = np.tile(np.frombuffer(b"abab", np.uint8), (4, 1))
    lengths = np.array([0, 2, 3, 4], dtype=np.int32)
    got = np.asarray(count_matches_window(wp, payloads, lengths, per_packet=True))
    want = _oracle(payloads, lengths, PATS)
    assert (got == want).all()


def test_binary_bytes_and_nul():
    wp = WindowProgram.build([b"\x00ab", b"\x00\x00"])
    text = b"x\x00ab\x00\x00ab"
    payloads = np.frombuffer(text, np.uint8)[None, :].copy()
    lengths = np.array([len(text)], np.int32)
    got = np.asarray(count_matches_window(wp, payloads, lengths, per_packet=True))
    assert got[0].tolist() == [2, 1]


def test_pattern_longer_than_payload():
    wp = WindowProgram.build([b"abcdefgh"])
    payloads = np.frombuffer(b"abc", np.uint8)[None, :].copy()
    got = np.asarray(count_matches_window(wp, payloads, np.array([3], np.int32)))
    assert got.tolist() == [0]


def test_nul_padding_cannot_false_match():
    """Padding bytes are zeros; a NUL-containing pattern must not match into
    the padding region beyond the payload length."""
    wp = WindowProgram.build([b"a\x00\x00"])
    payloads = np.zeros((1, 8), np.uint8)
    payloads[0, 0] = ord("a")
    got = np.asarray(count_matches_window(wp, payloads, np.array([1], np.int32)))
    assert got.tolist() == [0]  # payload is just "a"; match would need padding
    got3 = np.asarray(count_matches_window(wp, payloads, np.array([3], np.int32)))
    assert got3.tolist() == [1]


def test_bucket_plan_shapes():
    lengths = np.array([5, 300, 17, 0, 129, 64], np.int64)
    # min_rows=1: one tile per quantized width class, widest first.
    plan = bucket_plan(lengths, l_quant=128, min_rows=1)
    assert [(lengths[i].tolist(), lt) for i, lt in plan] == [
        ([300], 384),
        ([129], 256),
        ([64, 17, 5, 0], 128),
    ]
    # Default min_rows merges sparse wide classes into one tile at the
    # widest member's quantized width.
    (idx, lt), = bucket_plan(lengths, l_quant=128)
    assert lt == 384
    assert lengths[idx].tolist() == [300, 129, 64, 17, 5, 0]
    # A dense narrow class stays separate from a sparse wide tile (the
    # merge would waste more padded bytes than a launch costs).
    many = np.concatenate([lengths, np.full(600, 40)])
    plan = bucket_plan(many, l_quant=128, min_rows=4)
    assert [(len(i), lt) for i, lt in plan] == [(2, 384), (604, 128)]


def test_quantize_rows():
    from multithreading_string_matching.ops.bucketing import quantize_rows

    assert quantize_rows(1) == 8
    assert quantize_rows(8) == 8
    assert quantize_rows(9) == 16
    assert quantize_rows(1000) == 1024
    assert quantize_rows(1025) == 2048
    assert quantize_rows(13768) == 14336


def test_bucketed_equals_unbucketed():
    rng = np.random.default_rng(8)
    wp = WindowProgram.build(PATS)
    payloads = rng.integers(0, 3, size=(37, 200)).astype(np.uint8)
    lengths = rng.integers(0, 201, size=37).astype(np.int32)

    fn = lambda p, l, per_packet: count_matches_window(wp, p, l, per_packet=per_packet)
    flat = np.asarray(fn(payloads, lengths, per_packet=False))
    buck = np.asarray(
        run_bucketed(fn, payloads, lengths, n_tile=8, l_quant=64, per_packet=False)
    )
    assert (flat == buck).all()

    flat_pp = np.asarray(fn(payloads, lengths, per_packet=True))
    buck_pp = run_bucketed(
        fn, payloads, lengths, n_tile=8, l_quant=64, per_packet=True
    )
    assert (flat_pp == buck_pp).all()


def test_matcher_engines_agree(reference_dir):
    from multithreading_string_matching import (
        Matcher,
        extract_payloads,
        load_patterns,
        read_pcap,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats)
    batch = extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    w = m.count_batch(batch)                      # window, bucketed (default)
    a = m.count_batch(batch, engine="ac", bucketed=False)
    k = m.count_batch(batch, engine="kmp", bucketed=False)
    assert (w == a).all() and (a == k).all()
    assert int(w.sum()) == 39
