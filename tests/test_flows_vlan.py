"""VLAN-tagged flow matching (round 5 follow-up): `--flows --vlan`
composes instead of erroring.  Per-packet L2 shifts come from io.decode's
own tag walk (`l2_sizes`), so a capture where every/some segments ride
802.1Q or QinQ tags reassembles to EXACTLY the streams of its untagged
twin — same keys, same counts, same reorder behavior."""

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.io.decode import l2_sizes
from multithreading_string_matching.io.flows import extract_flows, flow_keys
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

KEY_A = ("10.0.0.1", "10.0.0.2", 1111, 80)
KEY_B = ("10.0.0.3", "10.0.0.2", 2222, 80)
K6 = ("2001:db8::1", "2001:db8::2", 40001, 443)

FLOWS = [
    (KEY_A, b"xxSIGNATUREyy", [4, 5, 4]),
    (KEY_B, b"SIGpqSIGr", [3, 3, 3]),
]


def _twin_captures(tmp_path, flows=FLOWS, **kw):
    """(tagged_path, untagged_path) for the same flow specs — bit-equal
    payload streams, different wire encapsulation."""
    tagged = tmp_path / "tagged.pcap"
    plain = tmp_path / "plain.pcap"
    synth_tcp_flows_pcap(tagged, flows, vlan_rate=1.0, **kw)
    synth_tcp_flows_pcap(plain, flows, **kw)
    return tagged, plain


def test_l2_sizes_per_packet(tmp_path):
    tagged, plain = _twin_captures(tmp_path)
    lt = l2_sizes(read_pcap(tagged), vlan=True)
    lp = l2_sizes(read_pcap(plain), vlan=True)
    assert (lp == 14).all()
    # Every frame got >=1 tag (vlan_rate=1.0); QinQ frames get two.
    assert set(np.unique(lt)) <= {18, 22} and (lt >= 18).all()
    # Without vlan= the walk is off — fixed Ethernet size (compat).
    assert (l2_sizes(read_pcap(tagged)) == 14).all()


def test_tagged_equals_untagged_extract(tmp_path):
    tagged, plain = _twin_captures(tmp_path, interleave_seed=5)
    fb_t = extract_flows(read_pcap(tagged), "tcp", vlan=True)
    fb_p = extract_flows(read_pcap(plain), "tcp", vlan=True)
    assert fb_t.num_flows == fb_p.num_flows == 2
    for f in range(2):
        assert fb_t.key_tuple(f) == fb_p.key_tuple(f)
        assert fb_t.stream(f) == fb_p.stream(f)
    m = Matcher([b"SIGNATURE", b"SIG"])
    assert np.asarray(m.count(fb_t.payloads, fb_t.lengths)).tolist() == [1, 3]


def test_without_vlan_tagged_frames_invalid(tmp_path):
    """No silent wrong-offset keys: without vlan= a tagged frame simply
    fails the strict decode (ethertype 0x8100 is not IPv4)."""
    tagged, _ = _twin_captures(tmp_path)
    valid, _, _, _ = flow_keys(read_pcap(tagged), "tcp")
    assert not valid.any()
    assert extract_flows(read_pcap(tagged), "tcp").num_flows == 0


def test_mixed_tagged_untagged_one_flow(tmp_path):
    """A flow whose segments are a MIX of tagged and untagged frames (the
    synth rng with vlan_rate=0.5) still reassembles as one flow — the key
    ignores the encapsulation."""
    path = tmp_path / "mix.pcap"
    pay = b"aaSIGNATUREbbSIGcc"
    synth_tcp_flows_pcap(path, [(KEY_A, pay, [3] * 6)], vlan_rate=0.5,
                         seed=9)
    fb = extract_flows(read_pcap(path), "tcp", vlan=True)
    assert fb.num_flows == 1 and fb.stream(0) == pay


def test_vlan_composes_with_ipv6_and_reorder(tmp_path):
    flows = [(K6, b"v6SIGNATUREv6", [5, 4, 4]), (KEY_A, b"SIGx", [2, 2])]
    path = tmp_path / "v6vlan.pcap"
    synth_tcp_flows_pcap(path, flows, vlan_rate=1.0, reorder_seed=3,
                         retransmit_rate=0.5, overlap_rate=0.5, seed=4)
    fb = extract_flows(read_pcap(path), "tcp", reorder=True, ipv6=True,
                       vlan=True)
    assert fb.num_flows == 2
    by_port = {fb.key_tuple(f)[3]: fb.stream(f) for f in range(2)}
    assert by_port[443] == b"v6SIGNATUREv6" and by_port[80] == b"SIGx"


@pytest.mark.parametrize("engine", ["ac", "window"])
def test_stream_vlan_equals_oneshot(tmp_path, engine):
    tagged, _ = _twin_captures(tmp_path, interleave_seed=2)
    pcap = read_pcap(tagged)
    m = Matcher([b"SIGNATURE", b"SIG"])
    fs = FlowStreamMatcher(m, "tcp", engine=engine, vlan=True,
                           scan_bytes=8)
    fs.feed_pcap_slice(pcap)
    fs.flush()
    assert fs.counts().tolist() == [1, 3]
    assert fs.flows_seen == 2


def test_checkpoint_carries_vlan_config(tmp_path):
    tagged, _ = _twin_captures(tmp_path)
    pcap = read_pcap(tagged)
    m = Matcher([b"SIGNATURE", b"SIG"])
    fs = FlowStreamMatcher(m, "tcp", engine="ac", vlan=True, scan_bytes=8)
    fs.feed_pcap_slice(pcap)
    ckpt = fs.save(tmp_path / "flow.ckpt")
    # Mismatched vlan config refuses to load.
    other = FlowStreamMatcher(m, "tcp", engine="ac")
    with pytest.raises(ValueError, match="vlan"):
        other.load(ckpt)
    # Same-config resume completes to the uninterrupted counts.
    resumed = FlowStreamMatcher(m, "tcp", engine="ac", vlan=True,
                                scan_bytes=8)
    resumed.load(ckpt)
    resumed.flush()
    assert resumed.counts().tolist() == [1, 3]


def test_cli_flows_vlan(tmp_path):
    import json
    import os
    import subprocess
    import sys

    tagged, _ = _twin_captures(tmp_path, interleave_seed=1)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    env = dict(os.environ)
    env["MSM_PLATFORM"] = "cpu"

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "multithreading_string_matching",
             "match", "--pcap", str(tagged), "--patterns", str(strings),
             "--mode", "tcp", "--flows", "--json", *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )

    got = run("--vlan")
    assert got.returncode == 0, got.stderr
    blob = json.loads(got.stdout)
    assert blob["counts"] == [1, 3] and blob["flows"] == 2
    # Streamed form composes too.
    streamed = run("--vlan", "--stream")
    assert json.loads(streamed.stdout)["counts"] == [1, 3]
    # Without --vlan the tagged capture holds zero decodable flows.
    plain = run()
    assert json.loads(plain.stdout)["flows"] == 0
