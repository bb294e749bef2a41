"""Sequence packing: packed rows give exact counts for NUL-free patterns.

The exactness argument (ops/bucketing.pack_rows): a window crossing the 0x00
separator contains a NUL and cannot equal a NUL-free pattern; every engine's
matcher state resets at the separator (AC/KMP fail to root on byte 0);
segments never split across rows.  These tests attack exactly those seams.
"""

import numpy as np
import pytest

import oracle
from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.ops.bucketing import pack_rows


def test_pack_rows_geometry():
    payloads = np.zeros((4, 10), np.uint8)
    payloads[0, :3] = 1
    payloads[1, :5] = 2
    payloads[2, :10] = 3
    lengths = np.array([3, 5, 10, 0], np.int64)
    packed, fill = pack_rows(payloads, lengths, width=16)
    # two-pointer: row0 = largest(10) + smallest that fits (3) = 14; row1 = 5
    assert packed.shape == (2, 16)
    assert fill.tolist() == [14, 5]
    assert packed[0, :10].tolist() == [3] * 10
    assert packed[0, 10] == 0                    # separator
    assert packed[0, 11:14].tolist() == [1] * 3
    assert packed[0, 14:].sum() == 0             # zero padding preserved
    assert packed[1, :5].tolist() == [2] * 5
    assert packed[1, 5:].sum() == 0


def test_prepare_auto_packs_short_payloads():
    m = Matcher([b"ab", b"cd"])
    rng = np.random.default_rng(3)
    payloads = rng.integers(1, 4, size=(4000, 100)).astype(np.uint8)
    lengths = rng.integers(20, 101, size=4000).astype(np.int32)  # short rows
    prep = m.prepare(payloads, lengths, packed="auto")
    assert prep.packed

    # payloads near the pack width fragment rows: bucketing wins
    wide = rng.integers(1, 4, size=(100, 1500)).astype(np.uint8)
    wlen = np.full(100, 1500, np.int32)
    prep = m.prepare(wide, wlen, packed="auto")
    assert not prep.packed

    # NUL-containing pattern set: auto never packs
    m2 = Matcher([b"ab", b"\x00x"])
    prep = m2.prepare(payloads, lengths, packed="auto")
    assert not prep.packed


def test_pack_rejects_oversized():
    with pytest.raises(ValueError):
        pack_rows(np.zeros((1, 300), np.uint8), np.array([300]), width=128)


def test_packed_rejects_nul_patterns():
    m = Matcher([b"ab", b"a\x00b"])
    with pytest.raises(ValueError):
        m.prepare(np.zeros((2, 8), np.uint8), np.array([8, 8]), packed=True)


def test_cross_segment_match_killed():
    """Payload A ends 'ab', payload B starts 'ab'; pattern 'abab' must not
    match across the packed boundary."""
    m = Matcher([b"abab", b"ab"])
    payloads = np.zeros((2, 8), np.uint8)
    payloads[0, :4] = np.frombuffer(b"xxab", np.uint8)
    payloads[1, :4] = np.frombuffer(b"abyy", np.uint8)
    lengths = np.array([4, 4], np.int32)
    prep = m.prepare(payloads, lengths, packed=True, pack_width=128)
    got = np.asarray(m.count_prepared(prep, engine="pallas"))
    assert got.tolist() == [0, 2]  # 'abab' would be 1 without the separator
    for engine in ("window", "ac", "kmp"):
        assert np.asarray(m.count_prepared(prep, engine=engine)).tolist() == [0, 2], engine


def test_packed_counts_random_all_engines():
    rng = np.random.default_rng(11)
    pats = [b"ab", b"aba", b"b", b"abab", b"ca", b"ab"]
    m = Matcher(pats)
    payloads = rng.integers(0, 4, size=(40, 100)).astype(np.uint8)
    lengths = rng.integers(0, 101, size=40).astype(np.int32)
    cols = np.arange(100)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(40)]
    want = np.array(oracle.oracle_counts(texts, pats))
    prep = m.prepare(payloads, lengths, packed=True, pack_width=256)
    for engine in ("window", "ac", "kmp"):
        got = np.asarray(m.count_prepared(prep, engine=engine))
        assert (got == want).all(), engine


def test_tile_counter_fuzz_feed_splits():
    """PackedTileCounter property fuzz: ANY split of a corpus into feeds of
    random sizes/widths — including oversized rows, empty feeds, nocase
    folding, and mid-stream totals() — equals the one-shot scan."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.pipeline import (
        PackedTileCounter,
    )

    rng = np.random.default_rng(11)
    pats = [b"http", b"AbC", b"zz", b"http"]  # duplicate kept
    for trial in range(4):
        nocase = bool(trial % 2)
        m = Matcher(pats, engine="window", case_insensitive=nocase)
        n = int(rng.integers(30, 120))
        lmax = int(rng.integers(40, 400))
        payloads = rng.integers(0, 256, size=(n, lmax)).astype(np.uint8)
        lengths = rng.integers(0, lmax + 1, size=n).astype(np.int64)
        for _ in range(n // 3):  # plant matches
            i = int(rng.integers(0, n))
            p = pats[int(rng.integers(0, len(pats)))]
            if lengths[i] > len(p):
                o = int(rng.integers(0, lengths[i] - len(p)))
                payloads[i, o : o + len(p)] = np.frombuffer(p, np.uint8)
        want = m.count(payloads, lengths)

        pack_width = int(rng.integers(64, 256))
        counter = PackedTileCounter(
            m, tile_rows=int(rng.integers(8, 64)), pack_width=pack_width
        )
        i = 0
        checked_mid = False
        while i < n:
            k = int(rng.integers(0, 12))  # 0 = empty feed
            counter.add(payloads[i : i + k], lengths[i : i + k])
            i += k
            if not checked_mid and i > n // 2:
                # totals() mid-stream must be non-destructive.
                mid = counter.totals()
                assert (mid <= want.astype(np.int64)).all()
                checked_mid = True
        got = counter.totals()
        assert got.tolist() == want.tolist(), (
            f"trial={trial} nocase={nocase} pack_width={pack_width}"
        )
        assert counter.totals().tolist() == want.tolist()  # idempotent


def test_packed_conformance_udp1000(reference_dir):
    from multithreading_string_matching import extract_payloads, read_pcap

    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    batch = extract_payloads(read_pcap(reference_dir / "udp_1000.pcap"), "udp")
    want = m.count_batch(batch)
    prep = m.prepare_batch(batch, packed=True)
    got = np.asarray(m.count_prepared(prep, engine="window"))
    assert (got == want).all()
    assert int(got.sum()) == 1006
    # packed efficiency: separator overhead is < 1 byte per payload, and
    # used bytes dominate the staged tensor (row padding is bounded by the
    # 64-row alignment + per-row next-fit tails).
    (pk, fill), = prep.tiles
    used = int(np.asarray(fill).sum())
    assert used - batch.total_payload_bytes < batch.num_payloads
    n_fill_rows = int((np.asarray(fill) > 0).sum())
    assert used > 0.85 * n_fill_rows * pk.shape[1]


def test_auto_declines_oversized_payload():
    """A payload wider than the pack row must make 'auto' fall back to
    bucketing, not raise — it sits on the default count() path."""
    m = Matcher([b"ab"])
    payloads = np.zeros((4, 3000), np.uint8)
    payloads[0, :2] = np.frombuffer(b"ab", np.uint8)
    lengths = np.full(4, 3000, np.int32)
    prep = m.prepare(payloads, lengths, packed="auto")
    assert not prep.packed
    got = m.count(payloads, lengths)  # default path; must not raise
    assert got[0] == 1
    assert np.asarray(m.count_prepared(prep))[0] == 1


def test_bucket_plan_caps_tile_rows():
    from multithreading_string_matching.ops.bucketing import bucket_plan

    plan = bucket_plan(np.full(10000, 96), n_tile=2048)
    assert all(len(i) <= 2048 for i, _ in plan)
    assert sum(len(i) for i, _ in plan) == 10000


def test_packed_forbids_per_packet(reference_dir):
    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    payloads = np.zeros((4, 16), np.uint8)
    prep = m.prepare(payloads, np.full(4, 16, np.int32), packed=True)
    with pytest.raises(ValueError):
        m.count_prepared(prep, per_packet=True)
