"""Regressions for the full-package review findings: config-file precedence,
empty captures, zero-row batches, per-packet report shape, checkpoint paths.
"""

import json
import struct
import subprocess
import sys

import numpy as np
import pytest

from multithreading_string_matching import Matcher, load_patterns, read_pcap
from multithreading_string_matching.io.decode import extract_payloads

CLI_ENV = {"MSM_PLATFORM": "cpu", "PATH": "/usr/bin:/bin", "HOME": "/root"}


def _run_match(*args, check=True):
    return subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match", *args],
        capture_output=True, text=True, check=check, env=CLI_ENV,
    )


def test_config_file_values_respected(tmp_path, reference_dir):
    """Regression: unset flags used to clobber --config values with argparse
    defaults (mode back to udp, engine back to pallas, strict off)."""
    from multithreading_string_matching.utils.config import MatchConfig

    cfg = MatchConfig(mode="tcp", engine="ac", strict=True)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    out = _run_match(
        "--pcap", str(reference_dir / "tcp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--config", str(path), "--json",
    )
    assert sum(json.loads(out.stdout)["counts"]) == 4  # tcp-mode totals
    # An explicit flag still wins over the config.
    out2 = _run_match(
        "--pcap", str(reference_dir / "tcp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--config", str(path), "--mode", "udp", "--json",
    )
    assert sum(json.loads(out2.stdout)["counts"]) == 0


def test_per_packet_text_mode_rejected(reference_dir):
    out = _run_match(
        "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--per-packet", check=False,
    )
    assert out.returncode != 0 and "--json" in (out.stdout + out.stderr)


def test_sharded_per_packet_matrix(reference_dir):
    """--sharded --per-packet: the row-sharded per-row kernel keeps packet
    identity, so the [N, P] matrix equals the unsharded one exactly."""
    out = _run_match(
        "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--per-packet", "--sharded", "--json",
    )
    sharded = json.loads(out.stdout)["counts"]
    out_u = _run_match(
        "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--per-packet", "--json",
    )
    unsharded = json.loads(out_u.stdout)["counts"]
    assert np.asarray(sharded).shape == np.asarray(unsharded).shape
    assert sharded == unsharded


def test_format_report_rejects_matrix():
    from multithreading_string_matching.utils.report import format_report

    with pytest.raises(ValueError, match="per-pattern"):
        format_report([b"a", b"b"], np.ones((3, 2), np.int32), 0.1)


def test_zero_caplen_capture_decodes_as_invalid(tmp_path):
    """pcapng packet blocks captured with 0 bytes parse to packets with NO
    captured bytes; decode must mark them invalid, not crash indexing
    buf[-1].  (buf itself may retain block-header bytes — the native span
    layout — so the pin is on caplens/packet(), not buf.size.)"""
    out = bytearray()

    def block(btype, body):
        blen = 12 + len(body) + ((-len(body)) % 4)
        out.extend(struct.pack("<II", btype, blen))
        out.extend(body + b"\x00" * ((-len(body)) % 4))
        out.extend(struct.pack("<I", blen))

    block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    block(0x00000001, struct.pack("<HHI", 1, 0, 65535))
    for _ in range(3):
        block(0x00000006, struct.pack("<IIIII", 0, 0, 0, 0, 60))  # incl 0
    p = tmp_path / "zerocap.pcapng"
    p.write_bytes(bytes(out))
    pcap = read_pcap(p)
    assert pcap.num_packets == 3
    assert (pcap.caplens == 0).all()
    assert all(pcap.packet(i).size == 0 for i in range(3))
    # The pure-Python walk still produces the fully-empty buffer.
    assert read_pcap(p, use_native=False).buf.size == 0
    for mode in ("udp", "tcp"):
        for kw in ({}, {"strict": True}, {"vlan": True, "ipv6": True}):
            batch = extract_payloads(pcap, mode, keep_invalid=True, **kw)
            assert int(batch.valid.sum()) == 0


def test_unknown_engine_raises():
    """A typo'd per-call engine override raises instead of silently running
    the window engine (the constructor already validated eagerly)."""
    from multithreading_string_matching import Matcher

    m = Matcher([b"http"])
    p = np.zeros((2, 16), np.uint8)
    l = np.full(2, 16, np.int32)
    with pytest.raises(ValueError, match="unknown engine"):
        m.count(p, l, engine="acc")  # typo of 'ac'


def test_pallas_interpret_env_zero_means_off():
    """'pallas' never runs a kernel in interpret mode: it resolves to the
    window engine (explicitly requested or as the default)."""
    from multithreading_string_matching import Matcher

    assert Matcher([b"http"])._resolve_engine("pallas") == "window"
    assert Matcher([b"http"])._resolve_engine(None) == "window"
    assert Matcher([b"http"], engine="ac")._resolve_engine("pallas") == "window"


def test_count_folds_once_on_pallas_path(monkeypatch):
    """count() folds the payloads once on the default ('pallas' ->
    window) path — a second full-corpus fold pass would double the host
    work."""
    from multithreading_string_matching import Matcher

    m = Matcher([b"http"], case_insensitive=True)
    calls = []
    orig = Matcher._maybe_fold

    def spy(self, payloads):
        calls.append(1)
        return orig(self, payloads)

    monkeypatch.setattr(Matcher, "_maybe_fold", spy)
    p = np.zeros((4, 128), np.uint8)
    p[0, :4] = np.frombuffer(b"HTTP", np.uint8)
    l = np.full(4, 128, np.int32)
    counts = m.count(p, l, engine="pallas")
    assert int(np.asarray(counts).sum()) == 1  # folded: HTTP matches http
    assert sum(calls) == 1, f"{sum(calls)} fold passes on one count()"


def test_pallas_zero_width_tile_counts_zero():
    """A zero-WIDTH payload tensor returns zero counts on every path
    (one-shot, per-packet, staged tiles)."""
    from multithreading_string_matching import Matcher

    m = Matcher([b"http", b"xml"])
    p = np.zeros((4, 0), np.uint8)
    l = np.zeros(4, np.int32)
    out = np.asarray(m.count(p, l))
    assert out.shape == (2,) and out.sum() == 0
    assert not np.asarray(m.count(p, l, per_packet=True)).any()
    assert int(np.asarray(m.count_prepared(m.prepare(p, l))).sum()) == 0

def test_zero_row_batches_count_to_zeros(reference_dir):
    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    empty_p = np.zeros((0, 16), np.uint8)
    empty_l = np.zeros((0,), np.int32)
    for engine in ("window", "ac", "kmp", None):
        counts = m.count(empty_p, empty_l, engine=engine)
        assert counts.shape == (len(m.patterns),) and not counts.any()
    per = m.count(empty_p, empty_l, per_packet=True)
    assert per.shape == (0, len(m.patterns))
    prep = m.prepare(empty_p, empty_l)
    counts = m.count_prepared(prep)
    assert counts.shape == (len(m.patterns),) and not counts.any()


def test_stream_checkpoint_roundtrip_extensionless(tmp_path, reference_dir):
    """Regression: save() wrote path.npz but load(path) looked for the bare
    path and raised FileNotFoundError."""
    from multithreading_string_matching.parallel.stream import StreamMatcher

    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    s = StreamMatcher(m)
    pcap = read_pcap(reference_dir / "udp.pcap")
    s.feed_pcap_slice(pcap, mode="udp")
    before = s.counts().copy()
    saved_to = s.save(tmp_path / "ckpt")  # no extension
    assert str(saved_to).endswith(".npz")
    s2 = StreamMatcher(m)
    s2.load(tmp_path / "ckpt")
    assert (s2.counts() == before).all()
    assert s2.packets_seen == s.packets_seen


def test_prepare_auto_plan_reuse_matches_explicit(reference_dir, monkeypatch):
    """packed='auto' reuses the decision plan on the Python path; tiles must
    equal an explicit packed=True prepare."""
    monkeypatch.setenv("MSM_NO_NATIVE", "1")
    import multithreading_string_matching.io.native as native

    native._lib, native._tried = None, False
    try:
        m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
        pcap = read_pcap(reference_dir / "udp_1000.pcap")
        batch = extract_payloads(pcap, "udp")
        auto = m.prepare_batch(batch, packed="auto")
        explicit = m.prepare_batch(batch, packed=True)
        assert auto.packed and explicit.packed
        for (pa, la), (pe, le) in zip(auto.tiles, explicit.tiles):
            assert (np.asarray(pa) == np.asarray(pe)).all()
            assert (np.asarray(la) == np.asarray(le)).all()
    finally:
        # A failed assert must not leave the module caching "no native lib"
        # for the rest of the session (test_native.py would silently skip).
        native._lib, native._tried = None, False


def test_ids_demo_example(reference_dir):
    """The worked example in examples/ must run end-to-end and find the
    fixture's 39 matches."""
    out = subprocess.run(
        [sys.executable, "examples/ids_demo.py",
         str(reference_dir / "udp.pcap"), str(reference_dir / "strings.txt"), "udp"],
        capture_output=True, text=True, check=True,
        env=CLI_ENV, cwd="/root/repo",
    )
    assert "# 39 matches in 20 packets" in out.stdout
    assert out.stdout.count("ALERT ") == 39
