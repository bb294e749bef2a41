"""pcapng container support == classic pcap results (libpcap reads both).

Converts a bundled classic capture into a synthesized pcapng (SHB + IDB +
EPBs) in both endiannesses and asserts the full pipeline produces identical
counts.  Also covers Simple Packet Blocks and skipped unknown blocks.
"""

import struct

import numpy as np
import pytest

from multithreading_string_matching import (
    Matcher,
    extract_payloads,
    iter_pcap,
    load_patterns,
    read_pcap,
)


def _pcapng_from(pcap, end="<", use_spb=False, junk_block=False):
    """Re-encode a PcapFile's packets as a pcapng byte blob."""
    out = bytearray()

    def block(btype, body):
        blen = 12 + len(body)
        pad = (-len(body)) % 4
        blen += pad
        out.extend(struct.pack(end + "II", btype, blen))
        out.extend(body + b"\x00" * pad)
        out.extend(struct.pack(end + "I", blen))

    # SHB: BOM, version 1.0, section length -1
    block(0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
    # IDB: linktype, reserved, snaplen (no options)
    block(0x00000001, struct.pack(end + "HHI", pcap.linktype, 0, pcap.snaplen))
    if junk_block:
        block(0x0BADF00D, b"\x00" * 16)  # unknown block type must be skipped
    for i in range(pcap.num_packets):
        data = pcap.packet(i).tobytes()
        if use_spb:
            block(0x00000003, struct.pack(end + "I", int(pcap.origlens[i])) + data)
        else:
            ticks = int(pcap.ts_sec[i]) * 1_000_000 + int(pcap.ts_frac[i])
            body = struct.pack(
                end + "IIIII",
                0, (ticks >> 32) & 0xFFFFFFFF, ticks & 0xFFFFFFFF,
                len(data), int(pcap.origlens[i]),
            ) + data
            block(0x00000006, body)
    return bytes(out)


@pytest.mark.parametrize("end", ["<", ">"])
@pytest.mark.parametrize("use_spb", [False, True])
def test_pcapng_counts_equal_classic(reference_dir, tmp_path, end, use_spb):
    classic = read_pcap(reference_dir / "udp.pcap")
    ng_path = tmp_path / "udp.pcapng"
    ng_path.write_bytes(
        _pcapng_from(classic, end=end, use_spb=use_spb, junk_block=True)
    )
    ng = read_pcap(ng_path)
    assert ng.num_packets == classic.num_packets
    assert (ng.caplens == classic.caplens).all()
    for i in range(classic.num_packets):
        assert np.array_equal(ng.packet(i), classic.packet(i)), i

    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    want = m.count_batch(extract_payloads(classic, "udp"))
    got = m.count_batch(extract_payloads(ng, "udp"))
    assert (got == want).all()
    assert int(got.sum()) == 39


def test_pcapng_timestamps_roundtrip(reference_dir, tmp_path):
    classic = read_pcap(reference_dir / "udp.pcap")
    ng_path = tmp_path / "ts.pcapng"
    ng_path.write_bytes(_pcapng_from(classic))
    ng = read_pcap(ng_path)
    assert (ng.ts_sec == classic.ts_sec).all()
    assert (ng.ts_frac == classic.ts_frac).all()  # both in microseconds


def _raw_block(end, btype, body):
    blen = 12 + len(body) + ((-len(body)) % 4)
    return (
        struct.pack(end + "II", btype, blen)
        + body + b"\x00" * ((-len(body)) % 4)
        + struct.pack(end + "I", blen)
    )


def test_pcapng_malformed_block_raises_valueerror(tmp_path):
    """An EPB with an empty body (blen=12) must raise ValueError, not leak
    struct.error — CLI error handling and the distributed all-host abort
    both dispatch on ValueError."""
    end = "<"
    blob = (
        _raw_block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
        + _raw_block(end, 0x00000001, struct.pack(end + "HHI", 1, 0, 65535))
        + _raw_block(end, 0x00000006, b"")  # EPB with no fixed header at all
    )
    p = tmp_path / "bad.pcapng"
    p.write_bytes(blob)
    with pytest.raises(ValueError):
        read_pcap(p)
    ok = read_pcap(p, strict=False)  # non-strict: stop at the bad block
    assert ok.num_packets == 0


def test_pcapng_obsolete_packet_block_timestamps(tmp_path):
    """PB (type 2) carries the same 64-bit tick timestamp as EPB and must
    decode through if_tsresol, not store ts_hi/ts_lo raw."""
    end = "<"
    sec, usec = 1_700_000_000, 123456
    ticks = sec * 1_000_000 + usec
    pkt = b"\xaa" * 20
    body = struct.pack(
        end + "HHIIII", 0, 0, (ticks >> 32) & 0xFFFFFFFF, ticks & 0xFFFFFFFF,
        len(pkt), len(pkt),
    ) + pkt
    blob = (
        _raw_block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
        + _raw_block(end, 0x00000001, struct.pack(end + "HHI", 1, 0, 65535))
        + _raw_block(end, 0x00000002, body)
    )
    p = tmp_path / "pb.pcapng"
    p.write_bytes(blob)
    pc = read_pcap(p)
    assert pc.num_packets == 1
    assert int(pc.ts_sec[0]) == sec
    assert int(pc.ts_frac[0]) == usec
    assert pc.packet(0).tobytes() == pkt


def test_pcapng_truncated_strict(reference_dir, tmp_path):
    classic = read_pcap(reference_dir / "udp.pcap")
    blob = _pcapng_from(classic)
    p = tmp_path / "trunc.pcapng"
    p.write_bytes(blob[: len(blob) - 7])
    with pytest.raises(ValueError):
        read_pcap(p)
    ok = read_pcap(p, strict=False)  # keeps the complete prefix
    assert 0 < ok.num_packets < classic.num_packets


def test_multi_section_interface_scoping(tmp_path):
    """Interface IDs are section-scoped: section 2's EPBs must resolve
    against section 2's IDB (nanosecond tsresol here), not section 1's."""
    def block(out, btype, body, end="<"):
        blen = 12 + len(body) + ((-len(body)) % 4)
        out += struct.pack(end + "II", btype, blen)
        out += body + b"\x00" * ((-len(body)) % 4)
        out += struct.pack(end + "I", blen)
        return out

    data = b"payload-one!"
    out = b""
    # Section 1: default usec IDB + one EPB at t=5s, 250000us.
    out = block(out, 0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    out = block(out, 0x00000001, struct.pack("<HHI", 1, 0, 65535))
    ticks1 = 5 * 1_000_000 + 250_000
    out = block(out, 0x00000006, struct.pack(
        "<IIIII", 0, ticks1 >> 32, ticks1 & 0xFFFFFFFF, len(data), len(data)
    ) + data)
    # Section 2: IDB with if_tsresol=9 (nanoseconds) + EPB at t=7s, 123456us.
    out = block(out, 0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    idb2 = struct.pack("<HHI", 1, 0, 65535) + struct.pack("<HH", 9, 1) + b"\x09\x00\x00\x00"
    idb2 += struct.pack("<HH", 0, 0)
    out = block(out, 0x00000001, idb2)
    ticks2 = (7 * 1_000_000 + 123_456) * 1000  # nanosecond ticks
    out = block(out, 0x00000006, struct.pack(
        "<IIIII", 0, ticks2 >> 32, ticks2 & 0xFFFFFFFF, len(data), len(data)
    ) + data)

    p = tmp_path / "two_sections.pcapng"
    p.write_bytes(out)
    pf = read_pcap(p)
    assert pf.num_packets == 2
    assert (int(pf.ts_sec[0]), int(pf.ts_frac[0])) == (5, 250_000)
    # Before the section-scoping fix this read 7*1e9/1e6-style garbage
    # (divisor from section 1): sec=7_123_456.
    assert (int(pf.ts_sec[1]), int(pf.ts_frac[1])) == (7, 123_456)

    # Streaming reader agrees.
    from multithreading_string_matching.io.pcap import iter_pcap

    chunks = list(iter_pcap(p, batch_packets=1))
    assert len(chunks) == 2
    assert (int(chunks[1].ts_sec[0]), int(chunks[1].ts_frac[0])) == (7, 123_456)


def _block(end, btype, body):
    pad = (-len(body)) % 4
    blen = 12 + len(body) + pad
    return (
        struct.pack(end + "II", btype, blen)
        + body + b"\x00" * pad
        + struct.pack(end + "I", blen)
    )


def test_pcapng_truncated_idb_option(tmp_path):
    """Regression (round-2 review): an IDB whose body ends at a 4-byte
    option header (if_tsresol with no value byte) used to escape both
    strictness modes as a raw IndexError."""
    end = "<"
    shb = _block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
    # IDB body: linktype/reserved/snaplen + option header (code=9, olen=1)
    # with NO value byte — body ends exactly at the header.
    idb_body = struct.pack(end + "HHI", 1, 0, 65535) + struct.pack(end + "HH", 9, 1)
    bad = tmp_path / "bad_idb.pcapng"
    bad.write_bytes(shb + _block(end, 0x00000001, idb_body))
    with pytest.raises(ValueError):
        read_pcap(bad, strict=True)
    # Tolerant: the complete prefix (zero packets), not a crash.
    got = read_pcap(bad, strict=False)
    assert got.num_packets == 0
    with pytest.raises(ValueError):
        list(iter_pcap(bad, batch_packets=4))  # strict default raises too
    chunks = list(iter_pcap(bad, batch_packets=4, strict=False))
    assert sum(c.num_packets for c in chunks) == 0


def test_pcapng_epb_before_idb_lenient(reference_dir, tmp_path):
    """An EPB citing a not-yet-seen interface keeps its packet BYTES (the
    late-IDB leniency pinned by test_stream_pcapng_idb_after_epb) with the
    documented microsecond timestamp fallback — a known tradeoff, not a
    crash or a dropped packet."""
    end = "<"
    classic = read_pcap(reference_dir / "udp.pcap")
    data = classic.packet(0).tobytes()
    shb = _block(end, 0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
    epb = _block(end, 0x00000006, struct.pack(
        end + "IIIII", 0, 0, 7_000_000, len(data), len(data)) + data)
    idb = _block(end, 0x00000001, struct.pack(end + "HHI", 1, 0, 65535))
    late = tmp_path / "epb_first.pcapng"
    late.write_bytes(shb + epb + idb)
    got = read_pcap(late, strict=True)
    assert got.num_packets == 1
    assert got.packet(0).tobytes() == data
    assert int(got.ts_sec[0]) == 7  # microsecond default scaling
