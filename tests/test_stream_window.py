"""Halo-chunked window streaming: chunk sums == unchunked counts exactly."""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching.ops.window import (
    WindowProgram,
    count_matches_window,
    window_stream_chunk,
)
from multithreading_string_matching.parallel.stream import StreamMatcher

PATS = [b"ab", b"aba", b"b", b"abab", b"ca", b"abcdefgh", b"\x00ab"]


def _stream(wp, payloads, lengths, chunk):
    n, L = payloads.shape
    halo = None
    total = None
    for start in range(0, L, chunk):
        c = payloads[:, start : start + chunk]
        if c.shape[1] < chunk:
            c = np.pad(c, ((0, 0), (0, chunk - c.shape[1])))
        counts, halo = window_stream_chunk(
            wp, c, (lengths - start).astype(np.int32), halo
        )
        total = np.asarray(counts) if total is None else total + np.asarray(counts)
    return total


@pytest.mark.parametrize("chunk", [8, 16, 64, 128])
def test_chunked_equals_unchunked(chunk):
    rng = np.random.default_rng(21)
    wp = WindowProgram.build(PATS)
    payloads = rng.integers(0, 3, size=(12, 128)).astype(np.uint8)
    lengths = rng.integers(0, 129, size=12).astype(np.int32)
    want = np.asarray(count_matches_window(wp, payloads, lengths))
    got = _stream(wp, payloads, lengths, chunk)
    assert (got == want).all(), chunk


def test_straddling_match_counted_once():
    wp = WindowProgram.build([b"abcdefgh"])
    payloads = np.zeros((1, 32), np.uint8)
    payloads[0, 12:20] = np.frombuffer(b"abcdefgh", np.uint8)  # straddles 16
    lengths = np.array([32], np.int32)
    got = _stream(wp, payloads, lengths, 16)
    assert got.tolist() == [1]


def test_nul_pattern_does_not_match_initial_halo():
    """The stream-start halo is fabricated zeros; \\x00-led patterns must not
    match into it (min_start guard)."""
    wp = WindowProgram.build([b"\x00\x00a"])
    payloads = np.zeros((1, 16), np.uint8)
    payloads[0, 0] = ord("a")  # stream starts "a..." — no match exists
    lengths = np.array([16], np.int32)
    got = _stream(wp, payloads, lengths, 8)
    # naive: text = "a" + 15 NULs -> pattern "\0\0a" occurs 0 times
    assert got.tolist() == [0]


def test_nul_pattern_chunk_narrower_than_halo():
    """Regression (round-2 review): with chunk width < halo width, the
    fabricated stream-start zeros used to persist into later chunks' halos
    where the min_start guard no longer applied — a \\x00-led pattern could
    'match' before position 0.  The carried fill count closes that for any
    chunk width."""
    wp = WindowProgram.build([b"\x00\x01\x01", b"\x00\x00\x01\x02"])  # H=3
    payloads = np.array([[1, 1, 9, 9]], np.uint8)
    lengths = np.array([4], np.int32)
    want = np.asarray(count_matches_window(wp, payloads, lengths))
    assert want.tolist() == [0, 0]  # nothing matches the real stream
    for chunk in (1, 2, 3, 4):
        got = _stream(wp, payloads, lengths, chunk)
        assert got.tolist() == want.tolist(), f"chunk={chunk}: {got}"
    # And a stream where the NUL pattern DOES occur mid-stream still counts
    # exactly once at every chunk width.
    text = bytes([1, 0, 1, 1, 7, 7])
    p2 = np.frombuffer(text, np.uint8)[None, :].copy()
    l2 = np.array([len(text)], np.int32)
    want2 = np.asarray(count_matches_window(wp, p2, l2))
    assert want2.tolist() == [1, 0]
    for chunk in (1, 2, 3, 6):
        got = _stream(wp, p2, l2, chunk)
        assert got.tolist() == want2.tolist(), f"chunk={chunk}: {got}"


def test_nul_pattern_across_chunks():
    wp = WindowProgram.build([b"\x00\x00a"])
    text = bytes([0, 0]) + b"a" + bytes([0, 0]) + b"a" + b"xx"
    payloads = np.frombuffer(text, np.uint8)[None, :].copy()
    lengths = np.array([len(text)], np.int32)
    want = count_overlapping(text, b"\x00\x00a")
    got = _stream(wp, payloads, lengths, 4)
    assert got.tolist() == [want] == [2]


def test_stream_matcher_window_engine_long_payload(strings_path):
    from multithreading_string_matching import Matcher, load_patterns

    m = Matcher(load_patterns(strings_path))
    rng = np.random.default_rng(22)
    payload = rng.integers(0, 256, size=(2, 300)).astype(np.uint8)
    payload[0, 62:66] = np.frombuffer(b"http", np.uint8)   # straddles 64
    payload[1, 126:130] = np.frombuffer(b"rpc!", np.uint8)[:4]
    lengths = np.array([300, 290], np.int32)
    want = m.count(payload, lengths)
    for engine in ("window", "ac"):
        s = StreamMatcher(m, fixed_len=64, engine=engine, packed=False)
        s.feed_batch(payload, lengths)
        assert (s.counts() == want).all(), engine


def test_bpf_filter_sniffed_semantics(reference_dir):
    """With bpf_filter=True (the live CLI's mode), packets_seen counts only
    protocol-matching packets — the reference's pcap_setfilter semantics
    (live_openmp_task.c:127) — while match counts stay identical."""
    from multithreading_string_matching import Matcher, load_patterns, read_pcap
    from multithreading_string_matching.io.decode import bpf_protocol_mask
    from multithreading_string_matching.parallel.stream import StreamMatcher

    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    pcap = read_pcap(reference_dir / "udp_1000.pcap")
    expected = int(bpf_protocol_mask(pcap, "udp").sum())
    assert 0 < expected < pcap.num_packets  # 330 of 1000 on this fixture

    filt = StreamMatcher(m)
    filt.feed_pcap_slice(pcap, "udp", bpf_filter=True)
    assert filt.packets_seen == expected

    plain = StreamMatcher(m)
    plain.feed_pcap_slice(pcap, "udp")
    assert plain.packets_seen == pcap.num_packets
    assert (filt.counts() == plain.counts()).all()
    assert int(filt.counts().sum()) == 1006


def test_bpf_filter_tcp_quirk_divergence(tmp_path):
    """tcp compat mode has NO protocol check, so an unfiltered stream counts
    matches inside a UDP packet with plausible TCP nibbles; the BPF filter
    excludes that packet — the same divergence the reference's BPF-filtered
    live program has from its own serial program."""
    import struct

    from multithreading_string_matching import Matcher, read_pcap

    payload = b"needle"
    # IPv4 packet with proto=17 (UDP) whose L4 bytes happen to form a
    # plausible TCP header: byte 12 of the pseudo-TCP header is 0x50
    # (data offset 5 -> 20-byte header), so the quirky TCP extractor
    # accepts it and scans bytes 54+ as "payload".
    ip = struct.pack(
        ">BBHHHBBH4s4s", 0x45, 0, 20 + 20 + len(payload), 0, 0,
        64, 17, 0, b"\x01\x02\x03\x04", b"\x05\x06\x07\x08",
    )
    l4 = b"\x00" * 12 + b"\x50" + b"\x00" * 7  # 20 bytes, th_off byte = 0x50
    frame = b"\xaa" * 6 + b"\xbb" * 6 + struct.pack(">H", 0x0800) + ip + l4 + payload
    raw = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    raw += struct.pack("<IIII", 0, 0, len(frame), len(frame)) + frame
    p = tmp_path / "quirk.pcap"
    p.write_bytes(raw)

    m = Matcher([b"needle"], engine="window")
    pcap = read_pcap(p)
    plain = StreamMatcher(m)
    plain.feed_pcap_slice(pcap, "tcp")
    filt = StreamMatcher(m)
    filt.feed_pcap_slice(pcap, "tcp", bpf_filter=True)
    assert int(plain.counts().sum()) == 1   # the quirky extractor scans it
    assert int(filt.counts().sum()) == 0    # BPF 'tcp' never delivers it
    assert plain.packets_seen == 1 and filt.packets_seen == 0


@pytest.mark.parametrize("seed", [30, 31, 32, 33])
def test_streaming_property_fuzz(seed):
    """Randomized deep fuzz of BOTH carried-state engines vs the oracle:
    random chunk widths, heavy-overlap alphabets, NUL patterns, nocase, and
    lengths that end exactly at / inside / beyond chunk boundaries."""
    import jax.numpy as jnp

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.ops.scan import count_matches_ac

    rng = np.random.default_rng(seed)
    n, L = 10, 160
    alpha = int(rng.integers(2, 6))
    pats = [b"Ab", b"aB" * 2, b"b", b"\x00a", b"a" * 7, b"ab"]
    payloads = rng.integers(0, alpha, size=(n, L)).astype(np.uint8)
    # Byte values land in 'a'..: map 0->a, 1->b(A?)... mix case for nocase.
    payloads = (payloads + 97).astype(np.uint8)
    flip = rng.random((n, L)) < 0.3
    payloads = np.where(flip & (payloads < 123), payloads - 32, payloads)
    payloads = payloads.astype(np.uint8)
    payloads[rng.random((n, L)) < 0.05] = 0  # sprinkle NULs
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    chunk = int(rng.choice([16, 24, 32, 80]))
    lengths[0] = chunk          # ends exactly at a chunk boundary
    lengths[1] = chunk + 1      # one byte into the next chunk

    m = Matcher(pats, case_insensitive=True)
    want = np.asarray(m.count(payloads, lengths, engine="window"))

    # window engine, halo-carried chunks
    folded = m._maybe_fold(payloads)
    wp = m.window
    got_w = _stream(wp, folded, lengths, chunk)
    assert (got_w == want).all(), ("window", chunk)

    # AC engine, carried DFA states
    states = jnp.zeros((n,), jnp.int32)
    total = None
    for start in range(0, L, chunk):
        c = folded[:, start : start + chunk]
        rel = np.clip(lengths - start, 0, None).astype(np.int32)
        counts, states = count_matches_ac(
            m.cac, jnp.asarray(c), jnp.asarray(rel),
            initial_states=states, dup_map=m.ac.dup_map, return_states=True,
        )
        total = np.asarray(counts) if total is None else total + np.asarray(counts)
    assert (total == want).all(), ("ac", chunk)

    # Cross-check against the pure-Python oracle on the folded texts.
    def fold(b):
        return bytes(c + 32 if 65 <= c <= 90 else c for c in b)

    for j, p in enumerate(pats):
        oracle_n = sum(
            count_overlapping(fold(payloads[i, : lengths[i]].tobytes()), fold(p))
            for i in range(n)
        )
        assert oracle_n == int(want[j]), (j, p)


# -- pattern hot-reload (the IDS rule-update shape) --------------------------


def _oracle_counts(payloads, lengths, pats):
    return np.array([
        sum(
            count_overlapping(payloads[i, : lengths[i]].tobytes(), p)
            for i in range(len(lengths))
        )
        for p in pats
    ])


@pytest.mark.parametrize("packed", [False, "auto"])
def test_stream_reload_swaps_pattern_sets(packed):
    from multithreading_string_matching import Matcher

    pats_a = [b"ab", b"ba", b"ab"]          # duplicate kept, reported twice
    pats_b = [b"cd", b"abab"]
    rng = np.random.default_rng(5)
    feed1 = rng.integers(0, 4, size=(23, 80)).astype(np.uint8) + ord("a")
    len1 = rng.integers(0, 81, size=23).astype(np.int32)
    feed2 = rng.integers(0, 4, size=(17, 80)).astype(np.uint8) + ord("a")
    len2 = rng.integers(0, 81, size=17).astype(np.int32)

    s = StreamMatcher(Matcher(pats_a), packed=packed)
    s.feed_batch(feed1, len1)
    final_a = s.reload(Matcher(pats_b))
    np.testing.assert_array_equal(final_a, _oracle_counts(feed1, len1, pats_a))

    s.feed_batch(feed2, len2)
    np.testing.assert_array_equal(
        s.counts(), _oracle_counts(feed2, len2, pats_b)
    )
    assert s.packets_seen == 40  # stream identity persists across the swap


def test_stream_reload_validates_before_mutating():
    from multithreading_string_matching import Matcher

    s = StreamMatcher(Matcher([b"ab"]), packed=True)
    feed = np.full((4, 16), ord("a"), dtype=np.uint8)
    feed[:, 1::2] = ord("b")
    lengths = np.full(4, 16, np.int32)
    s.feed_batch(feed, lengths)
    with pytest.raises(ValueError, match="NUL-free"):
        s.reload(Matcher([b"a\x00b"]))  # packed=True forbids NUL patterns
    # Failed reload left the stream untouched and usable.
    np.testing.assert_array_equal(s.counts(), _oracle_counts(feed, lengths, [b"ab"]))
    s.feed_batch(feed, lengths)
    assert int(s.counts()[0]) == 2 * int(_oracle_counts(feed, lengths, [b"ab"])[0])


def test_stream_reload_dump_writer_spans_sets(tmp_path, reference_dir):
    from multithreading_string_matching import Matcher, read_pcap
    from multithreading_string_matching.io.pcap import PcapWriter

    pcap = read_pcap(reference_dir / "udp.pcap")
    out = tmp_path / "hits.pcap"
    with PcapWriter(out) as w:
        s = StreamMatcher(Matcher([b"NOTIFY"]), dump_writer=w)
        s.feed_pcap_slice(pcap, "udp")
        s.reload(Matcher([b"rpc"]))
        s.feed_pcap_slice(pcap, "udp")
        s.flush()
    dumped = read_pcap(out)
    # First pass dumps NOTIFY packets, second pass rpc packets — in feed order.
    m_a, m_b = Matcher([b"NOTIFY"]), Matcher([b"rpc"])
    from multithreading_string_matching.io.decode import extract_payloads

    batch = extract_payloads(pcap, "udp")
    hits_a = np.asarray(m_a.count(batch.payloads, batch.lengths, per_packet=True)).sum(axis=1) > 0
    hits_b = np.asarray(m_b.count(batch.payloads, batch.lengths, per_packet=True)).sum(axis=1) > 0
    assert dumped.num_packets == int(hits_a.sum()) + int(hits_b.sum())
