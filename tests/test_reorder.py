"""Sequence-aware TCP reassembly (round 5, VERDICT item 3).

The capture-order default silently produces wrong stream bytes on captures
that reorder or retransmit; ``reorder=True`` orders each flow's segments by
TCP sequence number with first-bytes-win trimming.  These tests pin the
plan against a deliberately independent Python oracle, the synth knobs that
produce pathological wires, and the streaming form's one-round window.
"""

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.io.flows import (
    extract_flows,
    flow_keys,
    tcp_seqs,
)
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

KEY_A = ("10.0.0.1", "10.0.0.2", 1111, 80)
KEY_B = ("10.0.0.3", "10.0.0.2", 2222, 80)


def _oracle_reassemble(segments):
    """Independent restatement of the reassembly rule: seq order (capture
    order breaking ties), first bytes win, holes concatenated."""
    if not segments:
        return b""
    s0 = segments[0][0]
    rel = [((sq - s0 + 2**31) % 2**32) - 2**31 for sq, _ in segments]
    m = min(rel)
    rel = [r - m for r in rel]
    order = sorted(range(len(segments)), key=lambda i: (rel[i], i))
    covered = 0
    out = bytearray()
    for i in order:
        r, b = rel[i], segments[i][1]
        end = r + len(b)  # true end, before trimming shortens b
        if end <= covered:
            continue
        if r < covered:
            b = b[covered - r :]
        out += b
        covered = max(covered, end)
    return bytes(out)


def _capture_segments(pcap, mode="tcp"):
    """flow key -> [(seq, payload bytes)] in capture order."""
    valid, keys, off, ln = flow_keys(pcap, mode)
    seqs = tcp_seqs(pcap, valid)
    segs = {}
    for pkt in np.flatnonzero(valid):
        n = int(ln[pkt])
        if not n:
            continue
        s = int(pcap.offsets[pkt] + off[pkt])
        segs.setdefault(keys[pkt].tobytes(), []).append(
            (int(seqs[pkt]), bytes(pcap.buf[s : s + n]))
        )
    return segs


def test_reordered_capture_recovers_stream(tmp_path):
    path = tmp_path / "r.pcap"
    pay = b"HELLO-SIGNATURE-WORLD" * 3
    synth_tcp_flows_pcap(
        path, [(KEY_A, pay, [5] * 13)], reorder_seed=7,
    )
    pcap = read_pcap(path)
    fb = extract_flows(pcap, "tcp", reorder=True)
    assert fb.stream(0) == pay
    # Capture order is genuinely scrambled (the knob did something).
    fb_cap = extract_flows(pcap, "tcp")
    assert fb_cap.stream(0) != pay


def test_retransmissions_dropped(tmp_path):
    path = tmp_path / "rt.pcap"
    pay = b"abcdefghij" * 4
    synth_tcp_flows_pcap(
        path, [(KEY_A, pay, [4] * 10)], retransmit_rate=0.9, seed=3,
    )
    pcap = read_pcap(path)
    segs = _capture_segments(pcap)
    assert len(next(iter(segs.values()))) > 10  # retransmissions present
    fb = extract_flows(pcap, "tcp", reorder=True)
    assert fb.stream(0) == pay


def test_overlapping_retransmits_trimmed(tmp_path):
    path = tmp_path / "ov.pcap"
    pay = b"0123456789" * 5
    synth_tcp_flows_pcap(
        path, [(KEY_A, pay, [7] * 8)], overlap_rate=0.9, seed=4,
    )
    pcap = read_pcap(path)
    fb = extract_flows(pcap, "tcp", reorder=True)
    assert fb.stream(0) == pay
    # The capture-order concatenation DOES contain duplicate bytes.
    assert extract_flows(pcap, "tcp").lengths[0] > len(pay)


def test_randomized_differential_vs_oracle(tmp_path):
    """All knobs at once, many flows: extract_flows(reorder=True) ==
    per-flow oracle streams, and match counts equal counting the TRUE
    payload strings."""
    rng = np.random.default_rng(31)
    pats = [b"SIG", b"ab", b"aba"]
    m = Matcher(pats, engine="window")
    for trial in range(6):
        flows = []
        for i in range(int(rng.integers(1, 6))):
            n = int(rng.integers(1, 120))
            pay = bytes(
                rng.choice(
                    list(b"abSIGx"), size=n
                ).astype(np.uint8).tolist()
            )
            lens = []
            left = n
            while left > 0:
                s = int(rng.integers(1, 12))
                lens.append(min(s, left))
                left -= lens[-1]
            flows.append(
                ((f"10.1.{trial}.{i}", "10.2.0.1", 1000 + i, 80), pay, lens)
            )
        path = tmp_path / f"d{trial}.pcap"
        synth_tcp_flows_pcap(
            path, flows,
            interleave_seed=trial, reorder_seed=trial * 3 + 1,
            retransmit_rate=0.3, overlap_rate=0.3, seed=trial,
        )
        pcap = read_pcap(path)
        fb = extract_flows(pcap, "tcp", reorder=True)
        segs = _capture_segments(pcap)
        # Every flow's reassembled stream equals the oracle's.
        want_by_key = {k: _oracle_reassemble(v) for k, v in segs.items()}
        for f in range(fb.num_flows):
            assert fb.stream(f) == want_by_key[fb.keys[f].tobytes()], trial
        # And equals the TRUE payloads (synth knobs preserve stream bytes).
        true_pay = {tuple(spec[0]): bytes(spec[1]) for spec in flows}
        for f in range(fb.num_flows):
            src, dst, sp, dp = fb.key_tuple(f)
            assert fb.stream(f) == true_pay[(src, dst, sp, dp)]
        got = m.count(fb.payloads, fb.lengths)
        want = m.count(
            *_pad([true_pay[tuple(s[0])] for s in flows])
        )
        assert (np.sort(got) == np.sort(want)).all()


def _pad(streams):
    L = max(128, max((len(s) for s in streams), default=0))
    payloads = np.zeros((max(8, len(streams)), L), np.uint8)
    lengths = np.zeros(payloads.shape[0], np.int64)
    for i, s in enumerate(streams):
        payloads[i, : len(s)] = np.frombuffer(s, np.uint8)
        lengths[i] = len(s)
    return payloads, lengths


def test_streaming_reorder_one_round(tmp_path):
    """FlowStreamMatcher(reorder=True): everything fed then flushed once —
    counts equal the one-shot reordered reassembly."""
    path = tmp_path / "sr.pcap"
    pay_a = b"xxSIGNATUREyy" * 2
    pay_b = b"SIGzzz"
    synth_tcp_flows_pcap(
        path, [(KEY_A, pay_a, [4] * 7), (KEY_B, pay_b, [2] * 3)],
        reorder_seed=5, retransmit_rate=0.5, overlap_rate=0.5, seed=6,
        interleave_seed=2,
    )
    pcap = read_pcap(path)
    m = Matcher([b"SIGNATURE", b"SIG"], engine="ac")
    for engine in ("ac", "window"):
        fs = FlowStreamMatcher(
            m, "tcp", engine=engine, reorder=True,
            scan_bytes=1 << 20, width=16, min_lanes=8,
        )
        fs.feed_pcap_slice(pcap)
        fs.flush()
        fb = extract_flows(pcap, "tcp", reorder=True)
        want = np.asarray(m.count(fb.payloads, fb.lengths)).astype(np.int64)
        assert fs.counts().tolist() == want.tolist(), engine


def test_streaming_reorder_across_rounds_in_order_flow(tmp_path):
    """Carried coverage across rounds: an in-order flow split over rounds
    counts like the unstreamed scan; a stale retransmission arriving in a
    LATER round is dropped, not double-counted."""
    p1, p2 = tmp_path / "a.pcap", tmp_path / "b.pcap"
    synth_tcp_flows_pcap(p1, [(KEY_A, b"xxSIGNA", [7])])
    # Second capture: continuation + a retransmission of the first bytes.
    from multithreading_string_matching.io.synth import _eth_ipv4_tcp
    from multithreading_string_matching.io.pcap import (
        classic_global_header,
    )
    import struct

    frames = [
        _eth_ipv4_tcp(b"TUREyy", KEY_A, 1000 + 7),   # continuation
        _eth_ipv4_tcp(b"xxSIGNA", KEY_A, 1000),      # stale retransmission
    ]
    with open(p2, "wb") as f:
        f.write(classic_global_header())
        for i, pkt in enumerate(frames):
            f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
            f.write(pkt)
    m = Matcher([b"SIGNATURE", b"xx"], engine="ac")
    fs = FlowStreamMatcher(m, "tcp", reorder=True, scan_bytes=1, width=8,
                           min_lanes=8)
    fs.feed_pcap_slice(read_pcap(p1))
    fs.flush()
    fs.feed_pcap_slice(read_pcap(p2))
    fs.flush()
    assert fs.counts().tolist() == [1, 1]


def test_reorder_guards():
    with pytest.raises(ValueError, match="TCP"):
        FlowStreamMatcher(Matcher([b"x"]), "udp", reorder=True)


def test_truncated_seq_raises(tmp_path):
    """A valid segment whose caplen cuts inside the TCP header must raise,
    not silently misorder."""
    from multithreading_string_matching.io.synth import _eth_ipv4_tcp
    from multithreading_string_matching.io.pcap import (
        classic_global_header,
    )
    import struct

    path = tmp_path / "t.pcap"
    pkt = _eth_ipv4_tcp(b"payload", KEY_A, 1000)
    with open(path, "wb") as f:
        f.write(classic_global_header())
        # caplen cuts at l2+iplen+6: ports captured, seq bytes cut.  Not a
        # valid flow segment (flow_keys needs iplen+4 and payload), so
        # craft caplen to keep ports + 1 payload byte readable via a LIE in
        # caplen vs a replicated buffer: simpler — write full packet but
        # truncate caplen to 14+20+6.
        f.write(struct.pack("<IIII", 0, 0, 14 + 20 + 6, len(pkt)))
        f.write(pkt[: 14 + 20 + 6])
    pcap = read_pcap(path)
    valid, *_ = flow_keys(pcap, "tcp")
    if valid.any():  # only meaningful if the segment passed key validation
        with pytest.raises(ValueError, match="sequence"):
            tcp_seqs(pcap, valid)


def test_reorder_udp_mode_raises(tmp_path):
    path = tmp_path / "u.pcap"
    synth_tcp_flows_pcap(path, [(KEY_A, b"abc", [3])])
    with pytest.raises(ValueError, match="TCP"):
        extract_flows(read_pcap(path), "udp", reorder=True)


def test_cli_flows_reorder(tmp_path):
    """match --flows --reorder recovers the true stream on a scrambled
    capture; without --reorder the split signature is lost; --reorder
    without --flows errors."""
    import json
    import os
    import subprocess
    import sys

    path = tmp_path / "cli.pcap"
    synth_tcp_flows_pcap(
        path, [(KEY_A, b"xxSIGNATUREyy", [3] * 5)], reorder_seed=9,
    )
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\n")
    env = dict(os.environ)
    env["MSM_PLATFORM"] = "cpu"

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "multithreading_string_matching",
             "match", "--pcap", str(path), "--patterns", str(strings),
             "--mode", "tcp", "--flows", "--json", *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )

    got = run("--reorder")
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout)["counts"] == [1]
    plain = run()
    assert json.loads(plain.stdout)["counts"] == [0]
    bad = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching",
         "match", "--pcap", str(path), "--patterns", str(strings),
         "--mode", "tcp", "--reorder"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert bad.returncode != 0 and "--reorder requires --flows" in bad.stderr


def test_cli_flows_stream_reorder(tmp_path):
    """--flows --stream --reorder: the streaming form with the one-round
    window."""
    import json
    import os
    import subprocess
    import sys

    path = tmp_path / "clis.pcap"
    synth_tcp_flows_pcap(
        path, [(KEY_A, b"xxSIGNATUREyy", [3] * 5)],
        reorder_seed=9, retransmit_rate=0.5, seed=2,
    )
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\n")
    env = dict(os.environ)
    env["MSM_PLATFORM"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching",
         "match", "--pcap", str(path), "--patterns", str(strings),
         "--mode", "tcp", "--flows", "--stream", "--reorder", "--json"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["counts"] == [1]
