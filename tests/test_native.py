"""Native C++ ingest path must be bit-identical to the numpy spec path."""

import numpy as np
import pytest

from multithreading_string_matching.io import native
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.decode import decode_headers, extract_payloads

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native fast path"
)

FIXTURES = [
    ("udp.pcap", "udp"),
    ("tcp.pcap", "tcp"),
    ("udp_1000.pcap", "udp"),
    ("big_udp.pcap", "udp"),
    ("very_big_udp.pcap", "udp"),
    ("udp.pcap", "tcp"),  # cross-mode: exercises the no-protocol-check quirk
]


@pytest.mark.parametrize("name,mode", FIXTURES)
def test_native_equals_numpy(reference_dir, name, mode):
    py = read_pcap(reference_dir / name, use_native=False)
    nat = read_pcap(reference_dir / name, use_native=True)
    for f in ("offsets", "caplens", "origlens", "ts_sec", "ts_frac"):
        assert (getattr(py, f) == getattr(nat, f)).all(), f

    for strict in (False, True):
        v1, o1, l1 = decode_headers(py, mode, strict=strict, use_native=False)
        v2, o2, l2 = decode_headers(nat, mode, strict=strict, use_native=True)
        assert (v1 == v2).all()
        # geometry is only defined for valid packets
        assert (o1[v1] == o2[v2]).all() and (l1[v1] == l2[v2]).all()

    b1 = extract_payloads(py, mode)
    b2 = extract_payloads(nat, mode)
    assert b1.payloads.shape == b2.payloads.shape
    assert (b1.payloads == b2.payloads).all()
    assert (b1.lengths == b2.lengths).all()


def test_native_truncated_record(tmp_path):
    import struct

    raw = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    raw += struct.pack("<IIII", 0, 0, 10, 10) + b"x" * 6  # record cut short
    f = tmp_path / "t.pcap"
    f.write_bytes(raw)
    with pytest.raises(ValueError):
        read_pcap(f, use_native=True)
    pc = read_pcap(f, strict=False, use_native=True)
    assert pc.num_packets == 0


def test_native_pack_equals_python(monkeypatch):
    """msm_pack_plan/msm_pack_fill must reproduce ops/bucketing.pack_rows'
    Python plan+materialize exactly (row order, separators, fills) on
    adversarial length mixes."""
    from multithreading_string_matching.ops import bucketing

    rng = np.random.default_rng(7)
    cases = [
        rng.integers(0, 120, 500),               # many zeros
        rng.integers(1, 2048, 300),              # up to full width
        np.full(64, 2048),                       # exactly one row each
        np.array([2048, 1, 1, 1, 2047, 0, 5]),   # boundary fits
        np.zeros(10, dtype=np.int64),            # nothing to pack
        np.array([], dtype=np.int64),            # no segments at all
    ]
    try:
        for lens in cases:
            lens = np.asarray(lens, dtype=np.int64)
            pl = rng.integers(
                1, 256, (max(len(lens), 1), 2048), dtype=np.uint8
            )[: len(lens)]
            got = bucketing.pack_rows(pl, lens, 2048)
            monkeypatch.setenv("MSM_NO_NATIVE", "1")
            native._lib, native._tried = None, False
            want = bucketing.pack_rows(pl, lens, 2048)
            monkeypatch.delenv("MSM_NO_NATIVE")
            native._lib, native._tried = None, False
            assert got[0].shape == want[0].shape
            assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    finally:
        # Never leave the no-native state cached for later tests.
        native._lib, native._tried = None, False


def test_native_pack_rejects_oversize():
    from multithreading_string_matching.ops.bucketing import pack_rows

    with pytest.raises(ValueError, match="exceeds pack width"):
        pack_rows(np.zeros((1, 4096), np.uint8), np.array([3000]), 2048)


def test_native_plan_rows_rejects_oversize():
    """plan_rows mirrors the Python spec's oversized-segment ValueError — a
    plan with fill > width would send msm_pack_fill's memcpy past the row."""
    from multithreading_string_matching.io import native

    if not native.available():
        pytest.skip("native library unavailable")
    with pytest.raises(ValueError, match="exceeds pack width"):
        native.plan_rows(np.array([5000], dtype=np.int64), 2048)
    assert native.plan_rows(np.array([100, 200], dtype=np.int64), 2048) == 1


def test_pack_rejects_length_beyond_payload_width():
    """Regression: the native memcpy would read heap bytes past the payload
    row where the Python path raised; both must raise the same ValueError."""
    from multithreading_string_matching.ops.bucketing import pack_rows

    pl = np.full((4, 100), 0x41, np.uint8)
    lens = np.array([150, 10, 10, 10], dtype=np.int64)
    with pytest.raises(ValueError, match="exceeds payload tensor width"):
        pack_rows(pl, lens, 2048)


def test_matcher_validates_patterns_eagerly():
    from multithreading_string_matching import Matcher

    with pytest.raises(ValueError, match="non-empty"):
        Matcher([])
    with pytest.raises(ValueError, match="empty pattern"):
        Matcher([b"ok", b""])


@pytest.mark.parametrize("mode", ["udp", "tcp"])
@pytest.mark.parametrize("strict", [False, True])
def test_native_decode_fuzz_vs_numpy(tmp_path, mode, strict):
    """Random adversarial frames (truncations, garbage, both protocols):
    the C++ compat decode must agree with the numpy spec path bit-for-bit,
    not just on the bundled fixtures."""
    import struct

    from multithreading_string_matching.io.pcap import read_pcap

    rng = np.random.default_rng(97 + (mode == "tcp") + 2 * strict)
    out = bytearray(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
    for _ in range(400):
        kind = rng.integers(0, 3)
        if kind == 0:
            frame = bytes(rng.integers(0, 256, rng.integers(0, 90), dtype=np.uint8))
        else:
            proto = 17 if kind == 1 else 6
            ihl = int(rng.choice([0, 4, 5, 6, 15]))
            payload = bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
            ip = struct.pack(
                ">BBHHHBBH4s4s", (4 << 4) | ihl, 0, 0, 0, 0, 64, proto, 0,
                b"\x01" * 4, b"\x02" * 4,
            ) + b"\x00" * max(0, ihl * 4 - 20)
            l4 = bytes(rng.integers(0, 256, 20, dtype=np.uint8))
            frame = b"\xaa" * 12 + struct.pack(">H", 0x0800) + ip + l4 + payload
            if rng.integers(0, 3) == 0:
                frame = frame[: rng.integers(0, len(frame) + 1)]
        out += struct.pack("<IIII", 0, 0, len(frame), len(frame)) + frame
    p = tmp_path / f"fuzz_native_{mode}_{strict}.pcap"
    p.write_bytes(bytes(out))
    pcap = read_pcap(p)
    nat = decode_headers(pcap, mode, strict=strict, use_native=True)
    py = decode_headers(pcap, mode, strict=strict, use_native=False)
    for a, b in zip(nat, py):
        assert (np.asarray(a) == np.asarray(b)).all()
