"""Match-offset extraction vs a naive position oracle."""

import numpy as np
import pytest

from multithreading_string_matching.ops.window import WindowProgram, find_matches

PATS = [b"ab", b"aba", b"b", b"ca", b"ab"]


def naive_positions(payloads, lengths, uniq):
    rows = []
    for n in range(payloads.shape[0]):
        text = payloads[n, : lengths[n]].tobytes()
        for u, p in enumerate(uniq):
            start = 0
            while True:
                i = text.find(p, start)
                if i < 0:
                    break
                rows.append((n, i, u))
                start = i + 1
    rows.sort()
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def test_offsets_match_naive():
    rng = np.random.default_rng(31)
    wp = WindowProgram.build(PATS)
    payloads = rng.integers(0, 3, size=(10, 40)).astype(np.uint8)
    lengths = rng.integers(0, 41, size=10).astype(np.int32)
    got = find_matches(wp, payloads, lengths)
    want = naive_positions(payloads, lengths, wp.unique_patterns)
    assert got.shape == want.shape
    assert (got == want).all()


def test_offsets_agree_with_counts(reference_dir):
    from multithreading_string_matching import (
        Matcher, extract_payloads, load_patterns, read_pcap,
    )

    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    batch = extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    rows = m.find_matches(batch.payloads, batch.lengths)
    counts_u = np.bincount(rows[:, 2], minlength=len(m.window.unique_patterns))
    want = m.count_batch(batch)
    assert (counts_u[m.window.dup_map] == want).all()
    # spot check: every row really is a match
    for n, i, u in rows[:50]:
        p = m.window.unique_patterns[u]
        assert batch.payloads[n, i : i + len(p)].tobytes() == p


@pytest.mark.parametrize("seed", [40, 41, 42, 43])
def test_offsets_random_differential(seed):
    """Generative offsets differential (the soak's attribution check, pinned
    deterministically): random binary payloads x adversarial pattern mixes
    (duplicates, embedded NULs, single bytes, near-payload-length) against
    the bytes.find position oracle, plus the rows->counts invariant."""
    from multithreading_string_matching import Matcher

    rng = np.random.default_rng(seed)
    pats = []
    for _ in range(int(rng.integers(2, 10))):
        m_len = int(rng.integers(1, 20))
        alpha = int(rng.choice([2, 3, 256]))
        p = rng.integers(0, alpha, size=m_len).astype(np.uint8)
        if rng.random() < 0.2:
            p[rng.integers(0, m_len)] = 0
        pats.append(p.tobytes())
    pats.append(pats[0])  # duplicate
    nocase = bool(rng.random() < 0.5)
    n, lmax = int(rng.integers(4, 40)), int(rng.integers(8, 160))
    payloads = rng.integers(0, int(rng.choice([2, 3, 256])),
                            size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    lengths[0] = 0

    m = Matcher(pats, case_insensitive=nocase)
    fold = bytes(range(65)) + bytes(range(97, 123)) + bytes(range(91, 256))
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(n)]
    if nocase:
        texts = [t.translate(fold) for t in texts]
    uniq = [bytes(p) for p in m.window.unique_patterns]

    got = sorted(map(tuple, np.asarray(
        m.find_matches(payloads, lengths)).tolist()))
    want = []
    for row, t in enumerate(texts):
        for u, p in enumerate(uniq):
            start = 0
            while (i := t.find(p, start)) >= 0:
                want.append((row, i, u))
                start = i + 1
    assert got == sorted(want), f"seed={seed} nocase={nocase}"
    derived = m.counts_from_match_rows(np.array(got).reshape(-1, 3))
    want_counts = np.array(
        [sum(1 for r in want if r[2] == int(du)) for du in m.window.dup_map]
    )
    assert (derived == want_counts).all()
