"""FlowStreamMatcher checkpoint/resume + eviction policy (round 5,
VERDICT item 5): a killed flow monitor resumes to counts identical to the
uninterrupted run, and built-in eviction bounds state growth."""

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

KEY_A = ("10.0.0.1", "10.0.0.2", 1111, 80)
KEY_B = ("10.0.0.3", "10.0.0.2", 2222, 80)
PATS = [b"SIGNATURE", b"SIG", b"xx"]


def _mk_capture(tmp_path, **knobs):
    path = tmp_path / "c.pcap"
    synth_tcp_flows_pcap(
        path,
        [(KEY_A, b"xxSIGNATUREyy" * 3, [4] * 10),
         (KEY_B, b"zzSIGpp" * 2, [3, 4, 3, 4])],
        interleave_seed=5, **knobs,
    )
    return path


@pytest.mark.parametrize("engine", ["ac", "window"])
@pytest.mark.parametrize("reorder", [False, True])
def test_kill_resume_identical(tmp_path, engine, reorder):
    """Save mid-stream (with pending bytes and carried state), resume on a
    FRESH instance, finish: counts equal the uninterrupted run — across
    feed, round, AND checkpoint boundaries."""
    knobs = dict(reorder_seed=3, retransmit_rate=0.4) if reorder else {}
    path = _mk_capture(tmp_path, **knobs)
    pcap = read_pcap(path)
    mk = lambda: FlowStreamMatcher(
        Matcher(PATS, engine="ac"), "tcp", engine=engine,
        scan_bytes=9, width=8, min_lanes=8, reorder=reorder,
    )
    want = mk()
    for s in range(0, pcap.num_packets, 3):
        want.feed_pcap_slice(slice_pcap(pcap, s, s + 3, copy=False))
    want.flush()

    first = mk()
    half = pcap.num_packets // 2
    for s in range(0, half, 3):
        first.feed_pcap_slice(slice_pcap(pcap, s, min(s + 3, half), copy=False))
    ckpt = first.save(tmp_path / "ckpt")
    resumed = mk()
    resumed.load(ckpt)
    for s in range(half, pcap.num_packets, 3):
        resumed.feed_pcap_slice(slice_pcap(pcap, s, s + 3, copy=False))
    resumed.flush()
    assert resumed.counts().tolist() == want.counts().tolist()
    assert resumed.packets_seen == want.packets_seen
    assert resumed.bytes_seen == want.bytes_seen


def test_load_replaces_state(tmp_path):
    """load() is full rollback: resuming onto a USED instance must not
    double-count its prior activity."""
    path = _mk_capture(tmp_path)
    pcap = read_pcap(path)
    fs = FlowStreamMatcher(Matcher(PATS, engine="ac"), "tcp",
                           scan_bytes=9, width=8, min_lanes=8)
    fs.feed_pcap_slice(pcap)
    fs.flush()
    clean = fs.counts().copy()
    ckpt = fs.save(tmp_path / "full")
    # Pollute, then roll back.
    fs.feed_pcap_slice(pcap)
    fs.flush()
    assert fs.counts().sum() > clean.sum()
    fs.load(ckpt)
    assert fs.counts().tolist() == clean.tolist()
    # And continuing after rollback works.
    fs.feed_pcap_slice(pcap)
    fs.flush()
    assert fs.counts().tolist() == (2 * clean).tolist()


def test_checkpoint_config_mismatch_raises(tmp_path):
    path = _mk_capture(tmp_path)
    fs = FlowStreamMatcher(Matcher(PATS), "tcp", scan_bytes=9, min_lanes=8)
    fs.feed_pcap_slice(read_pcap(path))
    ckpt = fs.save(tmp_path / "k")
    with pytest.raises(ValueError, match="pattern"):
        FlowStreamMatcher(Matcher([b"other"]), "tcp").load(ckpt)
    with pytest.raises(ValueError, match="engine/mode"):
        FlowStreamMatcher(Matcher(PATS), "tcp", engine="window").load(ckpt)
    with pytest.raises(ValueError, match="reorder"):
        FlowStreamMatcher(Matcher(PATS), "tcp", reorder=True).load(ckpt)


def test_idle_eviction_bounds_state(tmp_path):
    """Churning flows: idle_rounds eviction keeps tracked state bounded."""
    m = Matcher(PATS, engine="ac")
    fs = FlowStreamMatcher(
        m, "tcp", scan_bytes=1, width=8, min_lanes=8, idle_rounds=2,
    )
    for burst in range(30):
        path = tmp_path / f"b{burst}.pcap"
        key = ("10.9.0.%d" % (burst % 250), "10.0.0.2", 30000 + burst, 80)
        synth_tcp_flows_pcap(path, [(key, b"xxSIGzz", [7])])
        fs.feed_pcap_slice(read_pcap(path))
        fs.flush()
        assert len(fs._states) <= 3  # idle flows dropped after 2 rounds
    assert fs.flows_evicted >= 27
    assert fs.counts()[1] == 30  # every SIG still counted before eviction


def test_max_flows_cap(tmp_path):
    m = Matcher(PATS, engine="ac")
    fs = FlowStreamMatcher(
        m, "tcp", scan_bytes=1, width=8, min_lanes=8, max_flows=4,
    )
    for i in range(12):
        path = tmp_path / f"f{i}.pcap"
        key = ("10.8.0.%d" % i, "10.0.0.2", 20000 + i, 80)
        synth_tcp_flows_pcap(path, [(key, b"ppSIGqq", [7])])
        fs.feed_pcap_slice(read_pcap(path))
        fs.flush()
        assert len(fs._states) <= 4
    assert fs.counts()[1] == 12
    with pytest.raises(ValueError, match="max_flows"):
        FlowStreamMatcher(m, "tcp", max_flows=0)


def test_fin_evict_drops_after_scan(tmp_path):
    """A FIN-carrying segment closes its flow AFTER its bytes are scanned;
    the half-signature state is forgotten, so a post-FIN continuation does
    not complete it (state was dropped, by policy)."""
    from multithreading_string_matching.io.synth import _eth_ipv4_tcp
    from multithreading_string_matching.io.pcap import (
        classic_global_header,
    )
    import struct

    def write(path, frames):
        with open(path, "wb") as f:
            f.write(classic_global_header())
            for i, pkt in enumerate(frames):
                f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
                f.write(pkt)

    def with_flags(pkt, flags):
        b = bytearray(pkt)
        b[14 + 20 + 13] = flags
        return bytes(b)

    p1, p2 = tmp_path / "f1.pcap", tmp_path / "f2.pcap"
    write(p1, [with_flags(_eth_ipv4_tcp(b"xxSIGNA", KEY_A, 1000), 0x11)])
    write(p2, [_eth_ipv4_tcp(b"TURE", KEY_A, 1007)])
    m = Matcher(PATS, engine="ac")
    fs = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8,
                           fin_evict=True)
    fs.feed_pcap_slice(read_pcap(p1))
    fs.flush()
    assert len(fs._states) == 0 and fs.flows_evicted == 1
    assert fs.counts()[2] == 1  # "xx" in the pre-FIN bytes WAS counted
    fs.feed_pcap_slice(read_pcap(p2))
    fs.flush()
    assert fs.counts()[0] == 0  # join forgotten by policy
    # Without fin_evict the same sequence completes the signature.
    fs2 = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8)
    fs2.feed_pcap_slice(read_pcap(p1))
    fs2.flush()
    fs2.feed_pcap_slice(read_pcap(p2))
    fs2.flush()
    assert fs2.counts()[0] == 1


def test_checkpoint_window_tails_survive(tmp_path):
    """Window-engine tails (carried halo bytes) round-trip through the
    checkpoint: a signature split across the checkpoint boundary counts."""
    p1, p2 = tmp_path / "w1.pcap", tmp_path / "w2.pcap"
    synth_tcp_flows_pcap(p1, [(KEY_A, b"ppSIGNA", [7])])
    synth_tcp_flows_pcap(p2, [(KEY_A, b"TUREqq", [6])])
    m = Matcher(PATS, engine="window")
    fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=1,
                           width=8, min_lanes=8)
    fs.feed_pcap_slice(read_pcap(p1))
    fs.flush()
    ckpt = fs.save(tmp_path / "wc")
    fs2 = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=1,
                            width=8, min_lanes=8)
    fs2.load(ckpt)
    fs2.feed_pcap_slice(read_pcap(p2))
    fs2.flush()
    assert fs2.counts()[0] == 1


def test_idle_eviction_keeps_active_flows(tmp_path):
    """Off-by-one regression: a flow that feeds bytes EVERY round has age
    exactly 1 after the post-scan increment — idle_rounds=1 must keep it
    (evict only strictly-more-than-1-round-idle flows)."""
    m = Matcher(PATS, engine="ac")
    fs = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8,
                           idle_rounds=1)
    p1, p2 = tmp_path / "i1.pcap", tmp_path / "i2.pcap"
    synth_tcp_flows_pcap(p1, [(KEY_A, b"xxSIGNA", [7])])
    synth_tcp_flows_pcap(p2, [(KEY_A, b"TUREyy", [6])])
    fs.feed_pcap_slice(read_pcap(p1))
    fs.flush()
    assert len(fs._states) == 1  # active flow survives its own round
    fs.feed_pcap_slice(read_pcap(p2))
    fs.flush()
    assert fs.counts()[0] == 1  # signature completed across rounds


def test_fin_evict_requires_tcp():
    import pytest

    with pytest.raises(ValueError, match="fin_evict"):
        FlowStreamMatcher(Matcher(PATS), "udp", fin_evict=True)


def test_evicted_counter_ignores_stateless_keys(tmp_path):
    """A bare FIN on a never-payload flow must not inflate flows_evicted."""
    from multithreading_string_matching.io.synth import _eth_ipv4_tcp
    from multithreading_string_matching.io.pcap import (
        classic_global_header,
    )
    import struct

    path = tmp_path / "bare.pcap"
    pkt = bytearray(_eth_ipv4_tcp(b"", KEY_A, 1000))
    pkt[14 + 20 + 13] = 0x11  # FIN|ACK, no payload
    data_pkt = _eth_ipv4_tcp(b"ppSIGqq", KEY_B, 2000)
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i, p in enumerate([bytes(pkt), data_pkt]):
            f.write(struct.pack("<IIII", i, 0, len(p), len(p)))
            f.write(p)
    m = Matcher(PATS, engine="ac")
    fs = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8,
                           fin_evict=True)
    fs.feed_pcap_slice(read_pcap(path))
    fs.flush()
    assert fs.flows_evicted == 0  # the FIN'd flow never had tracked state


def test_reorder_window_rebase_across_rounds(tmp_path):
    """The streaming reassembler re-bases its seq window each round, so a
    long-lived flow is not limited to 2 GiB total: simulate by injecting
    segments whose seqs advance ~1.5 GiB per round (coverage re-based to
    the edge keeps rel values small)."""
    m = Matcher([b"SIGNATURE"], engine="ac")
    fs = FlowStreamMatcher(m, "tcp", reorder=True, scan_bytes=1, width=16,
                           min_lanes=8)
    k = b"\x01" * 12
    big = 1_500_000_000
    seq = 1000
    total_sigs = 0
    for round_i in range(4):  # ~6 GiB of virtual stream positions
        # one real segment at the current edge, then a virtual jump
        fs._pending = {k: [(seq % 2**32, b"xxSIGNATUREyy")]}
        fs._pending_bytes = 13
        fs._scan()
        total_sigs += 1
        # account the jump as already-covered bytes: advance the carried
        # base as a long in-order stream would
        base, covered = fs._flow_reorder[k]
        seq = seq + 13 + big
        fs._flow_reorder[k] = ((base + covered + big) % 2**32, 0)
    assert fs.counts()[0] == total_sigs


def test_oneshot_reorder_span_guard():
    """reorder_plan raises on a >2 GiB per-flow extent instead of silently
    scrambling."""
    import pytest

    from multithreading_string_matching.io.flows import reorder_plan

    f = np.zeros(2, np.int64)
    seq = np.array([0, 2**31 - 10], np.int64)
    lens = np.array([100, 100], np.int64)
    with pytest.raises(ValueError, match="2 GiB"):
        reorder_plan(f, seq, lens)


def test_pattern_shard_double_swap_serves_current_tables():
    """Staged pattern-shard tables must follow swap_patterns: after two
    same-geometry swaps the sharded counts reflect the CURRENT set (an
    id()-keyed staging cache could alias a freed plan's address and serve
    stale tables)."""
    import gc

    import jax

    from multithreading_string_matching.parallel.pattern_shard import (
        count_matches_pattern_sharded,
        make_pattern_mesh,
    )

    mesh = make_pattern_mesh(jax.devices()[:4])
    payloads = np.zeros((8, 64), np.uint8)
    payloads[0, :4] = np.frombuffer(b"ccdd", np.uint8)
    lengths = np.array([4] + [0] * 7, np.int32)
    m = Matcher([b"aabb", b"eeff"])
    got = count_matches_pattern_sharded(m, payloads, lengths, mesh)
    assert got.tolist() == [0, 0]
    m.swap_patterns([b"xxyy", b"gghh"])
    count_matches_pattern_sharded(m, payloads, lengths, mesh)
    gc.collect()
    m.swap_patterns([b"ccdd", b"iijj"])  # same geometry again
    gc.collect()
    got = count_matches_pattern_sharded(m, payloads, lengths, mesh)
    assert got.tolist() == [1, 0]
