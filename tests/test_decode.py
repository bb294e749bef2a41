import numpy as np
import pytest

import oracle
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.decode import extract_payloads, decode_headers

# BASELINE.md corpus facts: (fixture, mode, valid_count, payload_bytes)
CORPUS = [
    ("udp.pcap", "udp", 20, 3347),
    ("tcp.pcap", "tcp", 13, 496),
    ("udp_1000.pcap", "udp", 321, 84519),
    ("big_udp.pcap", "udp", 3358, 599424),
    ("very_big_udp.pcap", "udp", 13768, 1321746),
]


@pytest.mark.parametrize("name,mode,nvalid,nbytes", CORPUS)
def test_corpus_facts(reference_dir, name, mode, nvalid, nbytes):
    batch = extract_payloads(read_pcap(reference_dir / name), mode)
    assert int(batch.valid.sum()) == nvalid
    assert batch.total_payload_bytes == nbytes


@pytest.mark.parametrize("name,mode", [(n, m) for n, m, _, _ in CORPUS])
def test_payloads_match_oracle_bytes(reference_dir, name, mode):
    """Vectorized decode must produce byte-identical payloads to the
    per-packet oracle that replicates packet_dumping.h pointer arithmetic."""
    batch = extract_payloads(read_pcap(reference_dir / name), mode)
    want = oracle.extract_payloads(reference_dir / name, mode)
    assert batch.num_payloads >= len(want)
    got = [batch.payload(i) for i in range(len(want))]
    assert got == want


def test_udp_mode_on_tcp_file_filters(reference_dir):
    """UDP mode checks ip_p == 17 (packet_dumping.h:116); a pure-TCP capture
    yields zero valid payloads."""
    batch = extract_payloads(read_pcap(reference_dir / "tcp.pcap"), "udp")
    assert int(batch.valid.sum()) == 0


def test_tcp_mode_has_no_protocol_check(tmp_path):
    """dump_TCP_packet never checks ip_p (packet_dumping.h:150-188): a UDP
    packet whose byte at the th_off position has a plausible high nibble
    passes the TCP extractor."""
    # ihl=5 (20B IP), proto=17 (UDP).  The byte the TCP extractor reads as
    # th_offx2 sits at 14+20+12=46; make its high nibble 5 (20-byte "TCP hdr").
    pkt = bytearray(64)
    pkt[12:14] = b"\x08\x00"
    pkt[14] = 0x45
    pkt[14 + 9] = 17
    pkt[46] = 0x50
    f = tmp_path / "udp_as_tcp.pcap"
    f.write_bytes(_pcap_of([bytes(pkt)]))
    pcap = read_pcap(f)
    valid, poff, plen = decode_headers(pcap, "tcp")
    assert valid.tolist() == [True]      # leaks through, as in the reference
    assert poff.tolist() == [54] and plen.tolist() == [10]
    # strict mode adds the missing ip_p == IPPROTO_TCP check
    strict_valid, _, _ = decode_headers(pcap, "tcp", strict=True)
    assert strict_valid.tolist() == [False]


def _eth_ipv4_udp(payload: bytes, ihl: int = 5, proto: int = 17) -> bytes:
    ip = bytearray(ihl * 4)
    ip[0] = (4 << 4) | ihl
    ip[9] = proto
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + b"\x00" * 8 + payload


def _pcap_of(packets) -> bytes:
    import struct

    out = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for p in packets:
        out += struct.pack("<IIII", 0, 0, len(p), len(p)) + p
    return out


def test_udp_predicate_edges(tmp_path):
    pkts = [
        _eth_ipv4_udp(b"hello"),                 # valid, payload "hello"
        _eth_ipv4_udp(b""),                      # valid, zero-length payload
        _eth_ipv4_udp(b"x", proto=6),            # TCP proto -> invalid in udp mode
        b"\x00" * 13,                            # shorter than ethernet header
        b"\x00" * 20,                            # too short for IP header
        _eth_ipv4_udp(b"opts", ihl=6),           # IP options: 24-byte IP header
    ]
    f = tmp_path / "x.pcap"
    f.write_bytes(_pcap_of(pkts))
    pcap = read_pcap(f)
    valid, poff, plen = decode_headers(pcap, "udp")
    assert valid.tolist() == [True, True, False, False, False, True]
    assert plen[valid].tolist() == [5, 0, 4]
    batch = extract_payloads(pcap, "udp")
    assert batch.payload(0) == b"hello"
    assert batch.payload(2) == b"opts"


def test_udp_ihl_below_5_slips_through(tmp_path):
    """The reference never validates ihl >= 5 for UDP (SURVEY Q-list): a
    packet with ihl=0 passes if the protocol byte at offset 23 is 17."""
    pkt = bytearray(b"\x00" * 14 + b"\x00" * 34)
    pkt[14] = 0x40          # version 4, ihl 0
    pkt[14 + 9] = 17        # proto byte read at IP offset 9 regardless
    f = tmp_path / "ihl.pcap"
    f.write_bytes(_pcap_of([bytes(pkt)]))
    valid, poff, plen = decode_headers(read_pcap(f), "udp")
    assert valid.tolist() == [True]
    assert poff.tolist() == [22]       # 14 + 0 + 8
    # strict mode rejects it
    svalid, _, _ = decode_headers(read_pcap(f), "udp", strict=True)
    assert svalid.tolist() == [False]


def test_keep_invalid_rows(tmp_path):
    pkts = [_eth_ipv4_udp(b"abc"), b"\x00" * 10, _eth_ipv4_udp(b"de")]
    f = tmp_path / "k.pcap"
    f.write_bytes(_pcap_of(pkts))
    batch = extract_payloads(read_pcap(f), "udp", keep_invalid=True)
    assert batch.num_payloads == 3
    assert batch.lengths.tolist() == [3, 0, 2]
    dropped = extract_payloads(read_pcap(f), "udp")
    assert dropped.lengths[:2].tolist() == [3, 2]


def test_padding_shapes(reference_dir):
    batch = extract_payloads(
        read_pcap(reference_dir / "udp.pcap"), "udp", pad_n_to=128, pad_len_to=8
    )
    assert batch.payloads.shape[0] % 128 == 0
    assert batch.payloads.shape[1] % 8 == 0
    assert batch.lengths[20:].sum() == 0  # padding rows are zero-length
