"""Streamed flow attribution (`--flows --stream --offsets`, round-5
continuation): each scan round runs one find pass over [tail | new bytes]
rows and keeps matches whose END falls in the new bytes — the count
kernels' own (min_start, min_end) algebra — so streamed (key, stream
offset, pattern) triples equal the one-shot reassembly's find_matches
at every round granularity, and bincount to exactly the counts."""

import json

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.cli import main
from multithreading_string_matching.io.flows import (
    extract_flows,
    key_tuple_bytes,
)
from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

FLOWS = [
    (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyySIGz", [4, 5, 4, 4]),
    (("10.0.0.3", "10.0.0.2", 2222, 80), b"SIGpqSIGr", [3, 3, 3]),
    (("10.0.0.4", "10.0.0.2", 3333, 80), b"quiet flow", [5, 5]),
]
PATS = [b"SIGNATURE", b"SIG"]


def _capture(tmp_path, name="off.pcap", flows=FLOWS, **kw):
    cap = tmp_path / name
    synth_tcp_flows_pcap(cap, flows, interleave_seed=2, **kw)
    return read_pcap(cap)


def _oneshot(pcap, m, **kw):
    fb = extract_flows(pcap, "tcp", **kw)
    rows = np.asarray(m.find_matches(fb.payloads, fb.lengths))
    return sorted(
        (fb.key_tuple(int(f)), int(i), int(u)) for f, i, u in rows
    )


def _streamed(pcap, m, step=2, **kw):
    fs = FlowStreamMatcher(m, "tcp", engine="window",
                           collect_offsets=True, **kw)
    for s0 in range(0, pcap.num_packets, step):
        fs.feed_pcap_slice(slice_pcap(pcap, s0, s0 + step, copy=False))
    fs.flush()
    hits = fs.drain_offsets()
    return fs, sorted(
        (key_tuple_bytes(k), int(o), int(u)) for k, o, u in hits
    ), hits


@pytest.mark.parametrize("scan_bytes", [3, 16, 1 << 20])
@pytest.mark.parametrize("step", [1, 3])
def test_streamed_offsets_equal_oneshot(tmp_path, scan_bytes, step):
    pcap = _capture(tmp_path)
    m = Matcher(PATS)
    want = _oneshot(pcap, m)
    fs, got, hits = _streamed(pcap, m, step=step, scan_bytes=scan_bytes)
    assert got == want
    # The kept triples bincount to exactly the counts (the one-scan
    # invariant, streamed).
    bc = np.bincount(
        [u for _, _, u in hits],
        minlength=len(m.window.unique_patterns),
    )[m.window.dup_map]
    assert fs.counts().tolist() == bc.tolist()


def test_offsets_compose_with_reorder_vlan_ipv6(tmp_path):
    flows = [
        (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyy", [4, 5, 4]),
        (("2001:db8::1", "2001:db8::2", 40001, 443), b"SIGaSIGb", [3, 3, 2]),
    ]
    cap = tmp_path / "prv.pcap"
    synth_tcp_flows_pcap(cap, flows, vlan_rate=1.0, reorder_seed=7,
                         retransmit_rate=0.4, overlap_rate=0.4, seed=3)
    pcap = read_pcap(cap)
    m = Matcher(PATS)
    want = _oneshot(pcap, m, reorder=True, ipv6=True, vlan=True)
    _, got, _ = _streamed(pcap, m, reorder=True, ipv6=True, vlan=True,
                          scan_bytes=1 << 20)
    assert got == want and len(got) >= 3


def test_nul_pattern_revival_offsets(tmp_path):
    """A NUL-adjacent pattern must not match inside the fabricated zero
    columns of a revived flow's halo (the min_start rule, find-pass
    form)."""
    pcap = _capture(
        tmp_path, flows=[
            (("10.0.0.1", "10.0.0.2", 1111, 80), b"A\x00B" * 3, [3, 3, 3]),
        ],
    )
    m = Matcher([b"\x00B", b"B"])
    want = _oneshot(pcap, m)
    fs, got, _ = _streamed(pcap, m, step=1, scan_bytes=2)
    assert got == want
    assert fs.counts().tolist() == [3, 3]


def test_checkpoint_resume_offsets(tmp_path):
    pcap = _capture(tmp_path)
    m = Matcher(PATS)
    want_fs, want, _ = _streamed(pcap, m, step=2, scan_bytes=8)

    fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=8,
                           collect_offsets=True)
    for s0 in range(0, 4, 2):
        fs.feed_pcap_slice(slice_pcap(pcap, s0, s0 + 2, copy=False))
    ck = fs.save(tmp_path / "ck")
    resumed = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=8,
                                collect_offsets=True)
    resumed.load(ck)
    for s0 in range(4, pcap.num_packets, 2):
        resumed.feed_pcap_slice(slice_pcap(pcap, s0, s0 + 2, copy=False))
    resumed.flush()
    got = sorted(
        (key_tuple_bytes(k), int(o), int(u))
        for k, o, u in resumed.drain_offsets()
    )
    assert got == want
    assert resumed.counts().tolist() == want_fs.counts().tolist()
    # Config mismatch refuses to load.
    plain = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=8)
    with pytest.raises(ValueError, match="offsets"):
        plain.load(ck)


def test_eviction_restarts_stream_offsets(tmp_path):
    """An evicted flow that reappears restarts at stream offset 0 —
    the same revival semantics the scan state has."""
    pcap = _capture(
        tmp_path, flows=[
            (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIG", [5]),
        ],
    )
    m = Matcher([b"SIG"])
    fs = FlowStreamMatcher(m, "tcp", engine="window", scan_bytes=1,
                           collect_offsets=True)
    fs.feed_pcap_slice(pcap)
    fs.flush()
    k = fs.drain_offsets()[0][0]
    fs.evict([k])
    fs.feed_pcap_slice(pcap)  # same wire bytes again, post-eviction
    fs.flush()
    (k2, off, u), = fs.drain_offsets()
    assert k2 == k and off == 2 and fs.counts().tolist() == [2]


def test_engine_guard():
    m = Matcher(PATS)
    with pytest.raises(ValueError, match="window"):
        FlowStreamMatcher(m, "tcp", engine="ac", collect_offsets=True)


def test_offsets_compose_with_sharded(tmp_path):
    """collect_offsets + sharded lanes: the find pass is host-driven and
    independent of how the count rounds shard — triples AND counts both
    equal the unsharded/one-shot answers on the 8-device mesh."""
    pcap = _capture(tmp_path)
    m = Matcher(PATS)
    want = _oneshot(pcap, m)
    fs, got, hits = _streamed(pcap, m, step=2, scan_bytes=8, sharded=True)
    assert got == want
    bc = np.bincount(
        [u for _, _, u in hits],
        minlength=len(m.window.unique_patterns),
    )[m.window.dup_map]
    assert fs.counts().tolist() == bc.tolist()


def test_cli_stream_offsets_equal_oneshot(tmp_path, capsys):
    cap = tmp_path / "cli.pcap"
    synth_tcp_flows_pcap(cap, FLOWS, interleave_seed=2)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")

    def run(*extra):
        code = main([
            "match", "--pcap", str(cap), "--patterns", str(strings),
            "--mode", "tcp", "--flows", "--offsets", "--json", *extra,
        ])
        return code, json.loads(capsys.readouterr().out)

    code, want = run()
    assert code == 0
    code, got = run("--stream")
    assert code == 0
    assert got["counts"] == want["counts"]
    # One-shot rows are [flow, off, u, packet] + a flow_keys table;
    # streamed rows carry the key inline: [src, dst, sport, dport, off, u].
    want_set = sorted(
        (tuple(want["flow_keys"][f]), o, u)
        for f, o, u, _pkt in want["offsets"]
    )
    got_set = sorted(
        ((src, dst, sp, dp), o, u)
        for src, dst, sp, dp, o, u in got["offsets"]
    )
    assert got_set == want_set
    assert got["unique_patterns"] == want["unique_patterns"]


def test_offsets_chunked_find(tmp_path, monkeypatch):
    """Pending larger than OFFSET_CHUNK: the find pass slices columns with
    H-overlap; triples stay identical to one-shot (each match reported in
    exactly one slice)."""
    rng = np.random.default_rng(7)
    pay = bytes(rng.integers(97, 105, size=4096, dtype=np.uint8))
    pay = pay[:100] + b"NEEDLE" + pay[100:2000] + b"NEEDLE" + pay[2000:]
    pcap = _capture(tmp_path, flows=[
        (("10.0.0.1", "10.0.0.2", 1111, 80), pay, [512] * 9),
    ])
    m = Matcher([b"NEEDLE"])
    monkeypatch.setattr(FlowStreamMatcher, "OFFSET_CHUNK", 256)
    want = _oneshot(pcap, m)
    _, got, _ = _streamed(pcap, m, step=3, scan_bytes=1 << 20)
    assert got == want and len(got) == 2


def test_offsets_chunk_smaller_than_halo_clamped(tmp_path, monkeypatch):
    """OFFSET_CHUNK below the halo width: the stride clamps to H so the
    c>0 real-context assumption holds (regression for the clamp)."""
    sig = bytes(range(32, 132))  # a 100-byte pattern, H=99
    pay = b"z" * 40 + sig + b"z" * 300 + sig + b"z" * 20
    pcap = _capture(tmp_path, flows=[
        (("10.0.0.1", "10.0.0.2", 1111, 80), pay, [64] * 9),
    ])
    m = Matcher([sig])
    monkeypatch.setattr(FlowStreamMatcher, "OFFSET_CHUNK", 16)
    want = _oneshot(pcap, m)
    _, got, _ = _streamed(pcap, m, step=2, scan_bytes=128)
    assert got == want and len(got) == 2


def test_cli_stream_guards_and_host_workers(tmp_path, capsys):
    cap = tmp_path / "g.pcap"
    synth_tcp_flows_pcap(cap, FLOWS, interleave_seed=2)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    base = ["match", "--pcap", str(cap), "--patterns", str(strings),
            "--mode", "tcp", "--flows", "--stream", "--json"]
    # --distributed must error loudly, not silently run single-host.
    with pytest.raises(SystemExit, match="--distributed"):
        main(base + ["--distributed"])
    # --host-workers threads the ingest stage; counts identical.
    code = main(base + ["--host-workers", "2"])
    got = json.loads(capsys.readouterr().out)
    assert code == 0 and got["counts"] == [1, 4]


def test_cli_stream_offsets_text_incremental(tmp_path, capsys):
    """Text mode emits each triple as its round drains — before the final
    report — so the daemon shape stays bounded-memory."""
    cap = tmp_path / "t.pcap"
    synth_tcp_flows_pcap(cap, FLOWS, interleave_seed=2)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    code = main([
        "match", "--pcap", str(cap), "--patterns", str(strings),
        "--mode", "tcp", "--flows", "--stream", "--offsets",
    ])
    out = capsys.readouterr().out
    assert code == 0
    flow_lines = [ln for ln in out.splitlines() if ln.startswith("flow ")]
    assert len(flow_lines) == 5  # SIGNATURE x1 + SIG x4
    # Incremental: every triple precedes the final report banner.
    assert out.index("flow ") < out.index("Printing the number")
