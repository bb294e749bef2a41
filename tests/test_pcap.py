import struct

import numpy as np
import pytest

from multithreading_string_matching.io.pcap import (
    read_pcap,
    read_pcap_range,
    LINKTYPE_ETHERNET,
)

FIXTURE_COUNTS = {
    "udp.pcap": 20,
    "tcp.pcap": 13,
    "udp_1000.pcap": 1000,
    "big_udp.pcap": 3580,
    "very_big_udp.pcap": 13768,
}


@pytest.mark.parametrize("name,count", sorted(FIXTURE_COUNTS.items()))
def test_fixture_packet_counts(reference_dir, name, count):
    pc = read_pcap(reference_dir / name)
    assert pc.num_packets == count
    assert pc.linktype == LINKTYPE_ETHERNET
    assert (pc.caplens == pc.origlens).all()  # no truncated captures in fixtures
    # offsets+caplens must tile the buffer without overlap
    assert (pc.offsets[1:] >= pc.offsets[:-1] + pc.caplens[:-1]).all()


def _synth_pcap(packets, magic=0xA1B2C3D4, endian="<"):
    out = struct.pack(endian + "IHHiIII", magic, 2, 4, 0, 0, 65535, 1)
    for data, orig in packets:
        out += struct.pack(endian + "IIII", 1, 2, len(data), orig) + data
    return out


def test_synthetic_roundtrip(tmp_path):
    pkts = [(b"\x01\x02\x03", 3), (b"", 0), (b"x" * 100, 200)]
    f = tmp_path / "s.pcap"
    f.write_bytes(_synth_pcap(pkts))
    pc = read_pcap(f)
    assert pc.num_packets == 3
    assert [pc.packet(i).tobytes() for i in range(3)] == [d for d, _ in pkts]
    assert pc.origlens.tolist() == [3, 0, 200]


def test_big_endian(tmp_path):
    f = tmp_path / "be.pcap"
    f.write_bytes(_synth_pcap([(b"abc", 3)], magic=0xA1B2C3D4, endian=">"))
    pc = read_pcap(f)
    assert pc.num_packets == 1
    assert pc.packet(0).tobytes() == b"abc"


def test_truncated_record(tmp_path):
    f = tmp_path / "t.pcap"
    raw = _synth_pcap([(b"abcd", 4)])
    f.write_bytes(raw[:-2])  # cut the last record's bytes short
    with pytest.raises(ValueError):
        read_pcap(f)
    pc = read_pcap(f, strict=False)
    assert pc.num_packets == 0


def test_bad_magic(tmp_path):
    f = tmp_path / "b.pcap"
    f.write_bytes(b"\x00" * 40)
    with pytest.raises(ValueError):
        read_pcap(f)


def test_pcapng_detected(tmp_path):
    f = tmp_path / "n.pcapng"
    f.write_bytes(b"\x0a\x0d\x0d\x0a" + b"\x00" * 40)
    with pytest.raises(ValueError, match="pcapng"):
        read_pcap(f)


def test_read_range(reference_dir):
    full = read_pcap(reference_dir / "udp.pcap")
    part = read_pcap_range(reference_dir / "udp.pcap", 5, 12)
    assert part.num_packets == 7
    for i in range(7):
        assert part.packet(i).tobytes() == full.packet(5 + i).tobytes()
    empty = read_pcap_range(reference_dir / "udp.pcap", 30, 40)
    assert empty.num_packets == 0
