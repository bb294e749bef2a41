"""Zero-recompile pattern swaps: tables-as-arguments contract.

The XLA window engine's pattern tables are jit ARGUMENTS; a same-geometry
pattern set must reuse every compiled executable (the rule-push latency
path) and produce the new set's exact counts.
"""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching import Matcher
from multithreading_string_matching.ops import window as window_ops


def _oracle(payloads, lengths, pats):
    texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    return [sum(count_overlapping(t, p) for t in texts) for p in pats]


def _zero_padded(seed, n=24, L=96):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(97, 100, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    cols = np.arange(L)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


@pytest.mark.parametrize("packed", [False, True])
def test_swap_same_geometry_reuses_executables(packed):
    pats_a = [b"ab", b"abc", b"abcdefgh", b"ca"]
    pats_b = [b"ba", b"cab", b"bacbacba", b"ac"]  # same [U, K] tables
    m = Matcher(pats_a)
    payloads, lengths = _zero_padded(60)
    assert m._resolve_engine(None) == "window"
    prep = m.prepare(payloads, lengths, packed=packed)
    got = np.asarray(m.count_prepared(prep))
    assert got.tolist() == _oracle(payloads, lengths, pats_a)
    size = window_ops._window_count_tiles._cache_size()

    assert m.swap_patterns(pats_b) is True
    got = np.asarray(m.count_prepared(prep))
    assert got.tolist() == _oracle(payloads, lengths, pats_b)
    # THE contract: no new executable was compiled for the swapped set.
    assert window_ops._window_count_tiles._cache_size() == size


def test_swap_rejects_different_geometry():
    """Another [U, K] geometry compiles anew (swap reports False) and still
    counts exactly."""
    payloads, lengths = _zero_padded(63)
    m = Matcher([b"ab", b"abcd"])
    m.count(payloads, lengths)
    for pats in ([b"ab", b"abcdefgh"], [b"ab"]):
        assert m.swap_patterns(pats) is False
        assert m.count(payloads, lengths).tolist() == _oracle(
            payloads, lengths, pats
        )


def test_swap_rejects_fit_mode_change():
    """A swap that brings in a NUL pattern keeps counts exact: NUL bytes
    never match the zero padding past a row's length."""
    payloads, lengths = _zero_padded(64)
    payloads[0, :3] = (ord("a"), 0, 0)
    lengths[0] = max(lengths[0], 4)
    m = Matcher([b"ab", b"cdef"])
    m.count(payloads, lengths)
    assert m.swap_patterns([b"a\x00", b"cdef"]) is True  # same [U, K]
    want = _oracle(payloads, lengths, [b"a\x00", b"cdef"])
    assert want[0] >= 1
    assert m.count(payloads, lengths).tolist() == want


def test_matcher_swap_patterns():
    """Matcher.swap_patterns reports executable reuse for same-geometry
    sets on the window engine (not on AC, whose automaton is baked in),
    and every engine sees the new set (automata rebuild lazily)."""
    payloads, lengths = _zero_padded(61)
    m = Matcher([b"ab", b"caca"], engine="ac")
    _ = m.count(payloads, lengths)
    assert m.swap_patterns([b"ba", b"acbc"]) is False  # ac: recompiles
    for engine in (None, "window", "kmp"):
        assert m.count(payloads, lengths, engine=engine).tolist() == _oracle(
            payloads, lengths, [b"ba", b"acbc"]
        )
    w = Matcher([b"ba", b"acbc"])
    w.count(payloads, lengths)
    assert w.swap_patterns([b"bb", b"acca"]) is True
    assert w.swap_patterns([b"ba", b"acbcacbc", b"q"]) is False
    assert w.count(payloads, lengths).tolist() == _oracle(
        payloads, lengths, [b"ba", b"acbcacbc", b"q"]
    )
    with pytest.raises(ValueError):
        m.swap_patterns([])


def test_stream_reload_transplants_kernel(tmp_path):
    """StreamMatcher.reload swaps the rule set mid-stream on the packed
    tile path: the old set's counts come back at the swap point, and
    counts after it are exact under the new set, for same and different
    table geometry."""
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.synth import synth_udp_pcap
    from multithreading_string_matching.parallel.stream import (
        StreamMatcher,
    )

    path = tmp_path / "u.pcap"
    synth_udp_pcap(path, 60, payload_len=96, payload_len_jitter=32,
                   patterns=[b"http", b"xml!", b"rpc!", b"id"],
                   plant_rate=0.5, seed=3)
    pcap = read_pcap(path)
    batch = extract_payloads(pcap, "udp")
    m1 = Matcher([b"http", b"xml!"])
    s = StreamMatcher(m1, packed=True, tile_rows=64, pack_width=512)
    s.feed_pcap_slice(pcap, "udp")
    for pats in ([b"rpc!", b"xml!"], [b"NOTIFY *", b"id"]):
        prev = s.reload(Matcher(pats))
        assert prev.tolist() == m1.count_batch(batch, engine="window").tolist()
        s.feed_pcap_slice(pcap, "udp")
        s.flush()
        m1 = Matcher(pats)
        want = m1.count_batch(batch, engine="window")
        assert want.sum() > 0
        assert s.counts().tolist() == want.tolist()


def test_swap_invalidates_sharded_caches():
    """The sharded wrappers stage the window tables on the matcher once —
    a swap must drop them or every sharded path keeps counting with the
    OLD set."""
    import jax

    from multithreading_string_matching.parallel.mesh import (
        count_rows_summary,
        make_mesh,
    )

    mesh = make_mesh(jax.devices("cpu")[:4])
    m = Matcher([b"aaaa", b"bbbb"])
    payloads = np.zeros((8, 64), np.uint8)
    payloads[0, 4:8] = np.frombuffer(b"cccc", np.uint8)
    lengths = np.full(8, 64, np.int32)
    got1, _ = count_rows_summary(m, payloads, lengths, mesh)
    assert np.asarray(got1).tolist() == [0, 0]
    assert m.swap_patterns([b"cccc", b"dddd"]) is True
    got2, hits = count_rows_summary(m, payloads, lengths, mesh)
    assert np.asarray(got2).tolist() == [1, 0], "sharded path served stale tables"
    assert np.asarray(hits).tolist() == [True] + [False] * 7


def test_count_prepared_rejects_stale_packed_prep():
    """A batch packed under a NUL-free set must be refused after a swap
    introduces a NUL pattern (matches across pack separators otherwise)."""
    m = Matcher([b"ab"])
    payloads = np.array([[ord("a"), 0], [ord("b"), 0]], np.uint8)
    lengths = np.array([1, 1], np.int32)
    prep = m.prepare(payloads, lengths, packed=True, pack_width=128)
    m.swap_patterns([b"b\x00a"])
    with pytest.raises(ValueError, match="packed batch is inexact"):
        m.count_prepared(prep)


def test_sharded_flow_lanes_divide_odd_mesh():
    """Lane quantization must cover non-pow2 device counts (review
    finding: 128 lanes over 6 devices split unevenly and crashed)."""
    import jax

    from multithreading_string_matching import Matcher
    from multithreading_string_matching.parallel.flow_stream import (
        FlowStreamMatcher,
    )
    from multithreading_string_matching.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices("cpu")[:6])
    fs = FlowStreamMatcher(
        Matcher([b"sig"], engine="ac"), "tcp",
        scan_bytes=1, width=8, min_lanes=7, sharded=True, mesh=mesh,
    )
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.synth import (
        synth_tcp_flows_pcap,
    )
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = d + "/f.pcap"
        synth_tcp_flows_pcap(
            p, [(("1.1.1.1", "2.2.2.2", 5, 6), b"xsigy", [3, 2])]
        )
        fs.feed_pcap_slice(read_pcap(p))
        fs.flush()
    assert fs.counts().tolist() == [1]


def test_swap_duplicates_and_dupmap():
    """Duplicate patterns expand through the swapped dup_map."""
    payloads, lengths = _zero_padded(62, n=8, L=64)
    m = Matcher([b"ab", b"ab", b"cd"])
    m.count(payloads, lengths)
    assert m.swap_patterns([b"cd", b"cd", b"ab"]) is True
    want = _oracle(payloads, lengths, [b"cd", b"cd", b"ab"])
    assert m.count(payloads, lengths).tolist() == want
