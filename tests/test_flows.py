"""Flow reassembly + flow-aware streaming vs the concatenated-flow oracle.

The capability under test is the one the per-packet reference model
fundamentally misses (packet_dumping.h scans each packet in isolation): a
signature split across TCP segments of one connection must count exactly
once, wherever the split lands — segment boundary, feed boundary, or scan
round — and exactly as many times as it appears in the reassembled stream.
"""

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching import Matcher
from multithreading_string_matching.io.decode import extract_payloads
from multithreading_string_matching.io.flows import (
    count_flows_chunked,
    extract_flows,
    flow_keys,
)
from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

KEY_A = ("10.0.0.1", "10.0.0.2", 1111, 80)
KEY_B = ("10.0.0.3", "10.0.0.2", 2222, 80)
KEY_B_REV = ("10.0.0.2", "10.0.0.3", 80, 2222)
PAY_A = b"xxxxSIGNATUREyyySIGNATUREzz"
PAY_B = b"ppppSIGNATUREqq"
PATS = [b"SIGNATURE", b"zz", b"pp"]


def _want(streams):
    return [sum(count_overlapping(s, p) for s in streams) for p in PATS]


@pytest.fixture()
def split_capture(tmp_path):
    p = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(
        p,
        [(KEY_A, PAY_A, [8, 8, 7, 4]), (KEY_B, PAY_B, [5, 5, 5])],
        interleave_seed=9, noise_packets=3,
    )
    return p


def test_reassembly_exact(split_capture):
    fb = extract_flows(read_pcap(split_capture), "tcp")
    assert fb.num_flows == 2
    streams = {fb.key_tuple(f): fb.stream(f) for f in range(fb.num_flows)}
    assert streams[KEY_A] == PAY_A
    assert streams[KEY_B] == PAY_B
    # padding rows are inert
    assert (fb.lengths[fb.num_flows:] == 0).all()
    # noise (UDP) packets are non-flow
    assert (fb.flow_of_packet == -1).sum() == 3
    assert int(fb.segments[:2].sum()) == 7


def test_split_signature_counts_once(split_capture):
    """Per-packet scanning misses every split signature; the flow scan
    equals the concatenated-flow oracle — THE flow-aware guarantee."""
    pcap = read_pcap(split_capture)
    m = Matcher(PATS, engine="window")
    per_packet = m.count_batch(extract_payloads(pcap, "tcp", strict=True))
    assert per_packet[0] == 0  # every SIGNATURE is split
    fb = extract_flows(pcap, "tcp")
    got = m.count(fb.payloads, fb.lengths)
    assert got.tolist() == _want([PAY_A, PAY_B])


@pytest.mark.parametrize("engine", ["window", "ac", "kmp"])
def test_flow_rows_engine_agnostic(split_capture, engine):
    fb = extract_flows(read_pcap(split_capture), "tcp")
    m = Matcher(PATS, engine=engine)
    assert m.count(fb.payloads, fb.lengths).tolist() == _want([PAY_A, PAY_B])


@pytest.mark.parametrize("chunk", [4, 7, 64])
def test_chunked_equals_oneshot(split_capture, chunk):
    """Carried-DFA chunked scan of the reassembled rows == one-shot (the
    long-flow path; chunk widths deliberately misaligned with segments)."""
    fb = extract_flows(read_pcap(split_capture), "tcp")
    m = Matcher(PATS)
    want = m.count(fb.payloads, fb.lengths, engine="window")
    got = count_flows_chunked(m, fb, chunk_width=chunk)
    assert got.tolist() == list(want)


def test_directionality_and_keys(tmp_path):
    """A->B and B->A are distinct streams (TCP data flows are one-way);
    keys report real addresses/ports."""
    p = tmp_path / "dir.pcap"
    synth_tcp_flows_pcap(
        p, [(KEY_B, b"abcd", [2, 2]), (KEY_B_REV, b"efgh", [4])],
    )
    fb = extract_flows(read_pcap(p), "tcp")
    assert fb.num_flows == 2
    streams = {fb.key_tuple(f): fb.stream(f) for f in range(2)}
    assert streams[KEY_B] == b"abcd"
    assert streams[KEY_B_REV] == b"efgh"


def test_flow_keys_truncated_capture(tmp_path):
    """Packets whose captured bytes stop before the ports have no
    recoverable key and drop off the flow path (no wild reads)."""
    p = tmp_path / "trunc.pcap"
    synth_tcp_flows_pcap(p, [(KEY_A, b"hello", [5])])
    raw = bytearray(p.read_bytes())
    # shrink caplen (record header at 24) to 30 bytes: eth+16
    import struct

    caplen = struct.unpack("<I", raw[32:36])[0]
    raw[32:36] = struct.pack("<I", 30)
    p.write_bytes(raw[: 24 + 16 + 30] + raw[24 + 16 + caplen :])
    pcap = read_pcap(p)
    valid, keys, off, ln = flow_keys(pcap, "tcp")
    assert not valid.any()
    fb = extract_flows(pcap, "tcp")
    assert fb.num_flows == 0


def test_empty_and_udp_mode(tmp_path):
    from multithreading_string_matching.io.pcap import classic_global_header
    from multithreading_string_matching.io.synth import synth_udp_pcap

    p = tmp_path / "empty.pcap"
    p.write_bytes(classic_global_header())
    fb = extract_flows(read_pcap(p), "tcp")
    assert fb.num_flows == 0 and fb.num_packets == 0

    # UDP "flows" (5-tuple conversations) reassemble too
    p2 = tmp_path / "u.pcap"
    synth_udp_pcap(p2, 10, payload_len=32, seed=1)
    fb2 = extract_flows(read_pcap(p2), "udp")
    assert fb2.num_flows >= 1  # synth uses one fixed 5-tuple
    assert fb2.total_payload_bytes == 10 * 32


def test_randomized_differential_vs_python_oracle(tmp_path):
    """60 random cases: random flows/keys/segmentation/interleave/noise —
    reassembly must byte-equal a pure-Python per-key concatenation, counts
    must equal the oracle, and every offset's packet attribution must point
    at the segment really holding the match's first byte."""
    rng = np.random.default_rng(55)
    m = Matcher([b"SIG", b"ab"], engine="window")
    for case in range(60):
        nflows = int(rng.integers(1, 6))
        flows, expect = [], {}
        used = set()
        for fi in range(nflows):
            while True:
                key = (f"10.0.{rng.integers(0, 4)}.{rng.integers(1, 5)}",
                       "192.168.0.1",
                       int(rng.integers(1024, 1030)), 80)
                if key not in used:
                    used.add(key)
                    break
            nbytes = int(rng.integers(0, 40))
            pay = bytes(rng.choice(
                [ord("a"), ord("b"), ord("S"), ord("I"), ord("G")],
                size=nbytes).astype(np.uint8).tolist())
            segs = []
            left = nbytes
            while left > 0:
                s = int(rng.integers(1, left + 1))
                segs.append(s)
                left -= s
            if not segs:
                segs = [0]
            flows.append((key, pay, segs))
            expect[key] = pay
        p = tmp_path / f"r{case}.pcap"
        synth_tcp_flows_pcap(
            p, flows, interleave_seed=int(rng.integers(0, 1000)),
            noise_packets=int(rng.integers(0, 4)), seed=case,
        )
        pcap = read_pcap(p)
        fb = extract_flows(pcap, "tcp")
        got = {fb.key_tuple(f): fb.stream(f) for f in range(fb.num_flows)}
        assert got == expect, (case, got, expect)
        counts = m.count(fb.payloads, fb.lengths) if fb.num_flows else (
            np.zeros(2, np.int32))
        want = [sum(count_overlapping(v, pt) for v in expect.values())
                for pt in m.patterns]
        assert counts.tolist() == want, case
        if fb.num_flows:
            rows = m.find_matches(fb.payloads, fb.lengths)
            for f, i, u in np.asarray(rows):
                pkt = fb.packet_of_offset(int(f), int(i))
                # the attributed packet's segment really contains byte i
                lo, hi = int(fb.seg_bounds[f]), int(fb.seg_bounds[f + 1])
                js = [j for j in range(lo, hi)
                      if int(fb.seg_packets[j]) == pkt]
                assert any(
                    int(fb.seg_starts[j]) <= i
                    and (j + 1 == hi or i < int(fb.seg_starts[j + 1]))
                    for j in js
                ), (case, f, i, pkt)


def test_packet_of_offset_split(split_capture):
    """The match that STARTS in segment 1 attributes to segment 1's packet
    even though it finishes in segment 2."""
    pcap = read_pcap(split_capture)
    fb = extract_flows(pcap, "tcp")
    m = Matcher(PATS, engine="window")
    rows = np.asarray(m.find_matches(fb.payloads, fb.lengths))
    for f, i, u in rows:
        pkt = fb.packet_of_offset(int(f), int(i))
        assert 0 <= pkt < fb.num_packets
        assert fb.flow_of_packet[pkt] == f  # the packet belongs to the flow


def test_cli_match_flows(split_capture, tmp_path, capsys):
    import json

    from multithreading_string_matching.cli import main

    pats = tmp_path / "p.txt"
    pats.write_text("SIGNATURE zz pp")
    code = main([
        "match", "--pcap", str(split_capture), "--patterns", str(pats),
        "--mode", "tcp", "--flows", "--json",
    ])
    out = capsys.readouterr().out
    assert code == 0
    blob = json.loads(out)
    assert blob["counts"] == _want([PAY_A, PAY_B])
    assert blob["flows"] == 2 and blob["flow_packets"] == 7
    # incompatible combos error out loudly
    with pytest.raises(SystemExit, match="--flows"):
        main(["match", "--pcap", str(split_capture), "--patterns", str(pats),
              "--mode", "tcp", "--flows", "--per-packet", "--json"])


def test_config_file_drives_flows(split_capture, tmp_path, capsys):
    """The 'config files fully drive match' invariant extends to flows."""
    import json

    from multithreading_string_matching.cli import main

    pats = tmp_path / "p.txt"
    pats.write_text("SIGNATURE zz pp")
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps({
        "pcap": str(split_capture), "patterns": str(pats),
        "mode": "tcp", "flows": True,
    }))
    code = main(["match", "--config", str(cfgp), "--json"])
    out = capsys.readouterr().out
    assert code == 0
    assert json.loads(out)["counts"] == _want([PAY_A, PAY_B])


def test_cli_match_flows_stream(split_capture, tmp_path, capsys):
    """--flows --stream: the bounded-memory per-flow carried-state path
    counts identically to one-shot reassembly."""
    import json

    from multithreading_string_matching.cli import main

    pats = tmp_path / "p.txt"
    pats.write_text("SIGNATURE zz pp")
    code = main([
        "match", "--pcap", str(split_capture), "--patterns", str(pats),
        "--mode", "tcp", "--flows", "--stream", "--json",
    ])
    out = capsys.readouterr().out
    assert code == 0
    blob = json.loads(out)
    assert blob["counts"] == _want([PAY_A, PAY_B])
    assert blob["flows"] == 2


def test_cli_match_flows_offsets(split_capture, tmp_path, capsys):
    """--flows --offsets: positions are byte offsets into the reassembled
    stream with the flow 5-tuple alongside; counts == the offsets rows."""
    import json

    from multithreading_string_matching.cli import main

    pats = tmp_path / "p.txt"
    pats.write_text("SIGNATURE zz pp")
    code = main([
        "match", "--pcap", str(split_capture), "--patterns", str(pats),
        "--mode", "tcp", "--flows", "--offsets", "--json",
    ])
    out = capsys.readouterr().out
    assert code == 0
    blob = json.loads(out)
    assert blob["counts"] == _want([PAY_A, PAY_B])
    uniq = blob["unique_patterns"]
    keys = {tuple(k): i for i, k in enumerate(blob["flow_keys"])}
    # every SIGNATURE offset points at a real occurrence in the stream,
    # and carries the capture packet holding the match's first byte
    sig_hits = [(f, i, pkt) for f, i, u, pkt in blob["offsets"]
                if uniq[u] == "SIGNATURE"]
    assert len(sig_hits) == 3
    streams = {keys[("10.0.0.1", "10.0.0.2", 1111, 80)]: PAY_A,
               keys[("10.0.0.3", "10.0.0.2", 2222, 80)]: PAY_B}
    for f, i, pkt in sig_hits:
        assert streams[f][i : i + 9] == b"SIGNATURE"
        assert 0 <= pkt < blob["packets"]


class TestFlowStream:
    def _feed(self, fs, pcap, step):
        for s in range(0, pcap.num_packets, step):
            fs.feed_pcap_slice(slice_pcap(pcap, s, s + step, copy=False))
        fs.flush()

    @pytest.mark.parametrize("engine", ["ac", "window"])
    @pytest.mark.parametrize("step,scan_bytes,width", [
        (1, 1, 8),        # scan round per packet, multi-chunk widths
        (3, 10, 8),       # splits land across feeds AND rounds
        (100, 1 << 20, 2048),  # everything in one round
    ])
    def test_stream_equals_oracle(self, split_capture, step, scan_bytes,
                                  width, engine):
        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="ac")
        fs = FlowStreamMatcher(
            m, "tcp", engine=engine, scan_bytes=scan_bytes, width=width,
            min_lanes=8,
        )
        self._feed(fs, pcap, step)
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])
        assert fs.flows_seen == 2

    def test_window_engine_nul_pattern_revival(self, tmp_path):
        """Window halo path: a NUL-containing pattern split across feeds
        counts once (per-lane fill keeps fabricated zeros unmatched) and
        revival restores the real tail bytes, not chunk padding."""
        p1, p2 = tmp_path / "n1.pcap", tmp_path / "n2.pcap"
        synth_tcp_flows_pcap(p1, [(KEY_A, b"xxE\x00", [4])])
        synth_tcp_flows_pcap(p2, [(KEY_A, b"Fyy", [3]), (KEY_B, b"qq", [2])])
        m = Matcher([b"E\x00F", b"qq"], engine="window")
        fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=1,
                               width=4, min_lanes=8)
        fs.feed_pcap_slice(read_pcap(p1))
        fs.flush()
        fs.feed_pcap_slice(read_pcap(p2))
        fs.flush()
        assert fs.counts().tolist() == [1, 1]

    def test_window_engine_nocase_across_rounds(self, tmp_path):
        """Stored halos are raw capture bytes; the restore must fold them
        for case-insensitive matchers or a match spanning a scan-round
        boundary silently misses (review finding — AC counted it, window
        did not: an engine-equivalence violation)."""
        p1, p2 = tmp_path / "c1.pcap", tmp_path / "c2.pcap"
        synth_tcp_flows_pcap(p1, [(KEY_A, b"xA", [2])])
        synth_tcp_flows_pcap(p2, [(KEY_A, b"b", [1])])
        for engine in ("ac", "window"):
            m = Matcher([b"ab"], engine="window", case_insensitive=True)
            fs = FlowStreamMatcher(m, "tcp", engine=engine, scan_bytes=1,
                                   width=4, min_lanes=8)
            fs.feed_pcap_slice(read_pcap(p1))
            fs.flush()
            fs.feed_pcap_slice(read_pcap(p2))
            fs.flush()
            assert fs.counts().tolist() == [1], engine

    def test_unknown_engine_rejected(self):
        with pytest.raises(ValueError, match="engine"):
            FlowStreamMatcher(Matcher(PATS), "tcp", engine="pallas")

    def test_state_survives_across_rounds(self, tmp_path):
        """The half-fed signature's DFA state must survive a scan round in
        which the flow is idle, then complete when the rest arrives."""
        p1 = tmp_path / "h1.pcap"
        p2 = tmp_path / "h2.pcap"
        synth_tcp_flows_pcap(p1, [(KEY_A, b"SIGNA", [5])])
        synth_tcp_flows_pcap(p2, [(KEY_A, b"TURE", [4]), (KEY_B, b"noise", [5])])
        m = Matcher(PATS, engine="ac")
        fs = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8)
        fs.feed_pcap_slice(read_pcap(p1))
        fs.flush()           # round ends mid-signature
        assert fs.counts()[0] == 0
        fs.feed_pcap_slice(read_pcap(p2))
        fs.flush()
        assert fs.counts()[0] == 1

    def test_sharded_equals_unsharded(self, split_capture):
        """Flow lanes sharded over the 8-device mesh: identical counts to
        the single-device stream, states surviving rounds per shard."""
        import jax

        from multithreading_string_matching.parallel.mesh import make_mesh

        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="ac")
        mesh = make_mesh(jax.devices("cpu")[:8])
        fs = FlowStreamMatcher(
            m, "tcp", scan_bytes=10, width=8, min_lanes=8,
            sharded=True, mesh=mesh,
        )
        self._feed(fs, pcap, 3)
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])

    def test_sharded_requires_flag(self):
        m = Matcher(PATS, engine="ac")
        with pytest.raises(ValueError, match="mesh"):
            FlowStreamMatcher(m, "tcp", mesh=object())

    def test_evict_drops_state(self, tmp_path):
        p1 = tmp_path / "e1.pcap"
        p2 = tmp_path / "e2.pcap"
        synth_tcp_flows_pcap(p1, [(KEY_A, b"SIGNA", [5])])
        synth_tcp_flows_pcap(p2, [(KEY_A, b"TURE", [4])])
        m = Matcher(PATS, engine="ac")
        fs = FlowStreamMatcher(m, "tcp", scan_bytes=1, width=8, min_lanes=8)
        fs.feed_pcap_slice(read_pcap(p1))
        fs.flush()
        fs.evict(list(fs._states))
        fs.feed_pcap_slice(read_pcap(p2))
        fs.flush()
        assert fs.counts()[0] == 0  # the join was forgotten, by request


class TestFlowRound5:
    """Round-5 flow serving: single-dispatch window rounds (Pallas halo
    kernel / XLA), sharded window streaming, skew fallback."""

    def _feed(self, fs, pcap, step):
        for s in range(0, pcap.num_packets, step):
            fs.feed_pcap_slice(slice_pcap(pcap, s, s + step, copy=False))
        fs.flush()

    def test_sharded_window_equals_unsharded(self, split_capture):
        import jax

        from multithreading_string_matching.parallel.mesh import make_mesh

        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="window")
        mesh = make_mesh(jax.devices("cpu")[:8])
        fs = FlowStreamMatcher(
            m, "tcp", engine="window", scan_bytes=10, width=8, min_lanes=8,
            sharded=True, mesh=mesh,
        )
        self._feed(fs, pcap, 3)
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])

    def test_sharded_window_nul_and_nocase(self, tmp_path):
        """The sharded window round keeps the fabricated-zeros boundary and
        the fold-idempotence contract."""
        import jax

        from multithreading_string_matching.parallel.mesh import make_mesh

        mesh = make_mesh(jax.devices("cpu")[:4])
        p1, p2 = tmp_path / "s1.pcap", tmp_path / "s2.pcap"
        synth_tcp_flows_pcap(p1, [(KEY_A, b"xxE\x00", [4])])
        synth_tcp_flows_pcap(p2, [(KEY_A, b"Fyy", [3]), (KEY_B, b"qAb", [3])])
        m = Matcher([b"E\x00F", b"ab"], engine="window",
                    case_insensitive=True)
        for sharded in (False, True):
            fs = FlowStreamMatcher(
                m, "tcp", engine="window", scan_bytes=1, width=4,
                min_lanes=4, sharded=sharded,
                mesh=mesh if sharded else None,
            )
            fs.feed_pcap_slice(read_pcap(p1))
            fs.flush()
            fs.feed_pcap_slice(read_pcap(p2))
            fs.flush()
            assert fs.counts().tolist() == [1, 1], f"sharded={sharded}"

    def test_skew_fallback_equals_oracle(self, split_capture, monkeypatch):
        """A round buffer past ROUND_BUDGET_BYTES falls back to the bounded
        per-chunk loop; counts unchanged."""
        monkeypatch.setattr(FlowStreamMatcher, "ROUND_BUDGET_BYTES", 1)
        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="window")
        fs = FlowStreamMatcher(
            m, "tcp", engine="window", scan_bytes=10, width=8, min_lanes=8
        )
        self._feed(fs, pcap, 3)
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])

    def test_device_accumulator_drains(self, split_capture, monkeypatch):
        """Counts survive a forced mid-stream drain (int32 wrap guard)."""
        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="window")
        fs = FlowStreamMatcher(
            m, "tcp", engine="window", scan_bytes=10, width=8, min_lanes=8
        )
        orig = fs._acc_device

        def acc(counts, *, expanded, positions):
            orig(counts, expanded=expanded, positions=positions)
            fs._drain_device()  # force per-round drain

        monkeypatch.setattr(fs, "_acc_device", acc)
        self._feed(fs, pcap, 3)
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])


class TestSubLaneRounds:
    """Round-5 wide-round handling: _expand_round_lanes re-lays a round as
    fixed-width sub-lanes; totals must equal the flat round for any
    geometry."""

    def test_expand_round_lanes_differential(self):
        import jax.numpy as jnp

        from multithreading_string_matching.ops.window import (
            StreamHalo,
            window_stream_chunk,
        )

        rng = np.random.default_rng(91)
        m = Matcher(PATS, engine="window")
        wp = m.window
        H = max(int(wp.max_len) - 1, 1)
        fs = FlowStreamMatcher(m, "tcp", engine="window", width=16,
                               min_lanes=8)
        for trial in range(6):
            F = 8
            W = int(rng.integers(1, 200))
            rel = rng.integers(0, W + 1, size=F).astype(np.int32)
            fill = rng.integers(0, H + 1, size=F).astype(np.int32)
            buf = rng.integers(0x41, 0x46, size=(F, W)).astype(np.uint8)
            cols = np.arange(W)[None, :]
            buf = np.where(cols < rel[:, None], buf, 0).astype(np.uint8)
            # plant a signature straddling a sub-lane boundary
            if W > 20:
                buf[0, 10:19] = np.frombuffer(b"SIGNATURE", np.uint8)
                rel[0] = max(rel[0], 19)
            halo = np.zeros((F, H), np.uint8)
            for i in range(F):
                if fill[i]:
                    halo[i, H - fill[i]:] = rng.integers(
                        0x41, 0x46, size=fill[i]
                    )
            want, _ = window_stream_chunk(
                wp, buf, rel,
                StreamHalo(jnp.asarray(halo), jnp.asarray(fill)),
                expand_duplicates=False,
            )
            x2, eff2, ms2 = fs._expand_round_lanes(buf, rel, halo, fill, 16)
            # Evaluate the sub-lane tile with the same masked-window
            # algebra (min_end=H per sub-lane).
            from multithreading_string_matching.ops.window import (
                _window_one,
            )

            got = _window_one(
                jnp.asarray(wp.pat_words), jnp.asarray(wp.pat_masks),
                jnp.asarray(wp.pat_lens), jnp.asarray(x2),
                jnp.asarray(eff2),
                per_packet=False, min_end=H,
                min_start=jnp.asarray(ms2).reshape(1, -1, 1),
            )
            assert (np.asarray(got) == np.asarray(want)).all(), trial

    def test_interpret_pallas_sublane_stream(self, split_capture):
        """Window flow rounds of a default ('pallas') matcher: counts
        equal the concatenated-flow oracle."""
        pcap = read_pcap(split_capture)
        m = Matcher(PATS, engine="pallas")
        assert m._resolve_engine(None) == "window"
        fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=10,
                               width=8, min_lanes=8)
        for s in range(0, pcap.num_packets, 3):
            fs.feed_pcap_slice(slice_pcap(pcap, s, s + 3, copy=False))
        fs.flush()
        assert fs.counts().tolist() == _want([PAY_A, PAY_B])
