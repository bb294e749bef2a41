"""IPv6 flow keys (round 5, VERDICT item 4): 37-byte version-tagged keys
cover v4 and v6 conversations in one key space; `--flows --ipv6` composes
instead of erroring."""

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.io.flows import extract_flows, flow_keys
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

K6A = ("2001:db8::1", "2001:db8::2", 40001, 80)
K6B = ("2001:db8::3", "2001:db8::2", 40002, 443)
K4 = ("10.0.0.1", "10.0.0.9", 1234, 80)


def test_v6_flows_reassemble(tmp_path):
    path = tmp_path / "v6.pcap"
    pay_a = b"xxSIGNATUREyy"
    pay_b = b"SIGzz"
    synth_tcp_flows_pcap(
        path, [(K6A, pay_a, [4, 5, 4]), (K6B, pay_b, [2, 3])],
        interleave_seed=1,
    )
    fb = extract_flows(read_pcap(path), "tcp", ipv6=True)
    assert fb.num_flows == 2
    streams = {fb.key_tuple(f)[3]: fb.stream(f) for f in range(2)}
    assert streams[80] == pay_a and streams[443] == pay_b
    m = Matcher([b"SIGNATURE", b"SIG"])
    got = np.asarray(m.count(fb.payloads, fb.lengths))
    assert got.tolist() == [1, 2]


def test_mixed_v4_v6_capture(tmp_path):
    """v4 and v6 conversations in ONE capture key into distinct flows; the
    v4 stream reassembles identically to the 12-byte-key path."""
    path = tmp_path / "mix.pcap"
    synth_tcp_flows_pcap(
        path,
        [(K6A, b"SIX-STREAM", [5, 5]), (K4, b"FOUR-STREAM", [6, 5])],
        interleave_seed=3,
    )
    pcap = read_pcap(path)
    fb = extract_flows(pcap, "tcp", ipv6=True)
    assert fb.num_flows == 2
    by_src = {fb.key_tuple(f)[0]: fb.stream(f) for f in range(2)}
    assert by_src["2001:db8:0:0:0:0:0:1"] == b"SIX-STREAM"
    assert by_src["10.0.0.1"] == b"FOUR-STREAM"
    # Keys carry the version tag: a v4 flow can never collide with a v6
    # flow whose address bytes embed it.
    vers = sorted(int(fb.keys[f][0]) for f in range(2))
    assert vers == [4, 6]
    # Without ipv6= the v6 packets are simply not flow-valid (no silent
    # wrong-offset keys) and the v4 flow still extracts.
    fb4 = extract_flows(pcap, "tcp")
    assert fb4.num_flows == 1
    assert fb4.stream(0) == b"FOUR-STREAM"


def test_v6_reorder_composes(tmp_path):
    path = tmp_path / "v6r.pcap"
    pay = b"aaSIGNATUREbb" * 2
    synth_tcp_flows_pcap(
        path, [(K6A, pay, [3] * 9)],
        reorder_seed=4, retransmit_rate=0.5, overlap_rate=0.5, seed=5,
    )
    fb = extract_flows(read_pcap(path), "tcp", reorder=True, ipv6=True)
    assert fb.stream(0) == pay


def test_v6_flow_stream_equals_oneshot(tmp_path):
    path = tmp_path / "v6s.pcap"
    pay_a = b"xxSIGNATUREyy"
    synth_tcp_flows_pcap(
        path, [(K6A, pay_a, [4, 5, 4]), (K4, b"SIGxx", [2, 3])],
        interleave_seed=2,
    )
    pcap = read_pcap(path)
    m = Matcher([b"SIGNATURE", b"SIG"], engine="ac")
    for engine in ("ac", "window"):
        fs = FlowStreamMatcher(
            m, "tcp", engine=engine, ipv6=True,
            scan_bytes=4, width=8, min_lanes=8,
        )
        fs.feed_pcap_slice(pcap)
        fs.flush()
        fb = extract_flows(pcap, "tcp", ipv6=True)
        want = np.asarray(m.count(fb.payloads, fb.lengths))
        assert fs.counts().tolist() == want.astype(np.int64).tolist(), engine
        assert fs.flows_seen == 2


def test_flow_keys_width_contract(tmp_path):
    path = tmp_path / "w.pcap"
    synth_tcp_flows_pcap(path, [(K4, b"abc", [3])])
    pcap = read_pcap(path)
    _, k12, _, _ = flow_keys(pcap, "tcp")
    _, k37, _, _ = flow_keys(pcap, "tcp", ipv6=True)
    assert k12.shape[1] == 12 and k37.shape[1] == 37
    v = np.flatnonzero(k37[:, 0] == 4)
    assert v.size  # the v4 packet keyed with version tag 4
    # v4 address bytes appear left-aligned in the 16-byte fields.
    assert k37[v[0], 1:5].tolist() == [10, 0, 0, 1]
    assert k37[v[0], 5:17].sum() == 0


def test_cli_flows_ipv6(tmp_path):
    import json
    import os
    import subprocess
    import sys

    path = tmp_path / "cli6.pcap"
    synth_tcp_flows_pcap(
        path, [(K6A, b"xxSIGNATUREyy", [4, 5, 4]), (K4, b"SIGpp", [2, 3])],
        interleave_seed=7,
    )
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    env = dict(os.environ)
    env["MSM_PLATFORM"] = "cpu"

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "multithreading_string_matching",
             "match", "--pcap", str(path), "--patterns", str(strings),
             "--mode", "tcp", "--flows", "--json", *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )

    got = run("--ipv6")
    assert got.returncode == 0, got.stderr
    blob = json.loads(got.stdout)
    assert blob["counts"] == [1, 2] and blob["flows"] == 2
    # Without --ipv6 only the v4 flow is seen (documented compat default).
    plain = run()
    assert json.loads(plain.stdout)["flows"] == 1
    # --stream composes too.
    streamed = run("--ipv6", "--stream")
    assert json.loads(streamed.stdout)["counts"] == [1, 2]
    # --vlan composes (per-packet l2 shifts; untagged capture = no-op).
    tagged = run("--ipv6", "--vlan")
    assert json.loads(tagged.stdout)["counts"] == [1, 2]
