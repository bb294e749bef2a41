"""Opt-in decoder extensions: 802.1Q/802.1ad VLAN tags and IPv6.

The reference decodes only untagged IPv4 (the IP header is hard-coded at
byte 14, packet_dumping.h:94,153).  These are beyond-parity extensions and
must be strictly opt-in: with ``vlan=False, ipv6=False`` the predicate is
bit-identical to the reference's on every fixture (pinned here).
"""

import struct
import subprocess
import sys

import numpy as np
import pytest

from multithreading_string_matching import (
    Matcher,
    extract_payloads,
    load_patterns,
    read_pcap,
)
from multithreading_string_matching.io.decode import decode_headers


def _write_pcap(path, frames):
    out = bytearray(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
    for fb in frames:
        out += struct.pack("<IIII", 0, 0, len(fb), len(fb))
        out += fb
    path.write_bytes(out)
    return path


def _eth(inner, ethertype, vlan_tags=()):
    """dst(6) src(6) [TPID TCI]* ethertype inner."""
    hdr = b"\xaa" * 6 + b"\xbb" * 6
    for tpid, tci in vlan_tags:
        hdr += struct.pack(">HH", tpid, tci)
    hdr += struct.pack(">H", ethertype)
    return hdr + inner


def _ipv4_udp(payload):
    ip = struct.pack(
        ">BBHHHBBH4s4s", (4 << 4) | 5, 0, 20 + 8 + len(payload), 0, 0,
        64, 17, 0, b"\x01\x02\x03\x04", b"\x05\x06\x07\x08",
    )
    udp = struct.pack(">HHHH", 1111, 2222, 8 + len(payload), 0)
    return ip + udp + payload


def _ipv6(next_hdr, l4_and_payload):
    return struct.pack(
        ">IHBB16s16s", 6 << 28, len(l4_and_payload), next_hdr, 64,
        b"\x20" + b"\x00" * 15, b"\x20" + b"\x01" * 15,
    ) + l4_and_payload


def _ipv6_udp(payload):
    return _ipv6(17, struct.pack(">HHHH", 1111, 2222, 8 + len(payload), 0) + payload)


def _ipv6_tcp(payload, data_off=5):
    tcp = struct.pack(">HHIIBBHHH", 1111, 2222, 0, 0, data_off << 4, 0, 0, 0, 0)
    tcp += b"\x00" * (data_off * 4 - 20)
    return _ipv6(6, tcp + payload)


PAYLOAD = b"GET http://x HTTP/1.1"


def test_vlan_single_tag_udp(tmp_path):
    frame = _eth(_ipv4_udp(PAYLOAD), 0x0800, vlan_tags=[(0x8100, 0x0064)])
    pcap = read_pcap(_write_pcap(tmp_path / "v.pcap", [frame]))
    on = extract_payloads(pcap, "udp", vlan=True)
    assert int(on.valid.sum()) == 1 and on.payload(0) == PAYLOAD
    off = extract_payloads(pcap, "udp", vlan=False)
    # Compat mode mis-reads the TCI as the IP header; whatever it decides,
    # it must NOT recover the true payload.
    assert int(off.valid.sum()) == 0 or off.payload(0) != PAYLOAD


def test_vlan_qinq_double_tag(tmp_path):
    frame = _eth(
        _ipv4_udp(PAYLOAD), 0x0800,
        vlan_tags=[(0x88A8, 0x0001), (0x8100, 0x0064)],
    )
    pcap = read_pcap(_write_pcap(tmp_path / "q.pcap", [frame]))
    on = extract_payloads(pcap, "udp", vlan=True)
    assert int(on.valid.sum()) == 1 and on.payload(0) == PAYLOAD


def test_vlan_strict_checks_inner_ethertype(tmp_path):
    good = _eth(_ipv4_udp(PAYLOAD), 0x0800, vlan_tags=[(0x8100, 7)])
    bad = _eth(_ipv4_udp(PAYLOAD), 0x1234, vlan_tags=[(0x8100, 7)])
    pcap = read_pcap(_write_pcap(tmp_path / "s.pcap", [good, bad]))
    valid, _, _ = decode_headers(pcap, "udp", strict=True, vlan=True)
    assert valid.tolist() == [True, False]


def test_ipv6_udp_and_tcp(tmp_path):
    frames = [
        _eth(_ipv6_udp(PAYLOAD), 0x86DD),
        _eth(_ipv6_tcp(PAYLOAD), 0x86DD),
        _eth(_ipv6_tcp(PAYLOAD, data_off=8), 0x86DD),  # TCP options
    ]
    pcap = read_pcap(_write_pcap(tmp_path / "6.pcap", frames))
    udp_on = extract_payloads(pcap, "udp", ipv6=True)
    assert udp_on.valid.tolist() == [True, False, False]
    assert udp_on.payload(0) == PAYLOAD
    tcp_on = extract_payloads(pcap, "tcp", ipv6=True, keep_invalid=True)
    assert tcp_on.valid.tolist() == [False, True, True]
    assert tcp_on.payload(1) == PAYLOAD and tcp_on.payload(2) == PAYLOAD
    # Off by default: the v6 frames must not decode as v4 payload hits.
    udp_off = extract_payloads(pcap, "udp", keep_invalid=True)
    assert all(udp_off.payload(i) != PAYLOAD for i in range(3))


def test_ipv6_extension_header_is_invalid(tmp_path):
    # Hop-by-hop (0) before UDP: chains are not followed -> invalid.
    hbh = struct.pack(">BB6s", 17, 0, b"\x00" * 6)
    inner = hbh + struct.pack(">HHHH", 1, 2, 8 + len(PAYLOAD), 0) + PAYLOAD
    frame = _eth(_ipv6(0, inner), 0x86DD)
    pcap = read_pcap(_write_pcap(tmp_path / "x.pcap", [frame]))
    valid, _, _ = decode_headers(pcap, "udp", ipv6=True)
    assert valid.tolist() == [False]


def test_vlan_ipv6_combined(tmp_path):
    frame = _eth(_ipv6_udp(PAYLOAD), 0x86DD, vlan_tags=[(0x8100, 5)])
    pcap = read_pcap(_write_pcap(tmp_path / "v6.pcap", [frame]))
    batch = extract_payloads(pcap, "udp", vlan=True, ipv6=True)
    assert int(batch.valid.sum()) == 1 and batch.payload(0) == PAYLOAD


def test_mixed_corpus_counts_additive(tmp_path, reference_dir):
    frames = [
        _eth(_ipv4_udp(b"plain http here"), 0x0800),
        _eth(_ipv4_udp(b"tagged http here"), 0x0800, vlan_tags=[(0x8100, 9)]),
        _eth(_ipv6_udp(b"v6 http here"), 0x86DD),
    ]
    path = _write_pcap(tmp_path / "m.pcap", frames)
    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    assert int(matcher.count_pcap(path, "udp").sum()) == 1
    assert int(matcher.count_pcap(path, "udp", vlan=True).sum()) == 2
    assert int(matcher.count_pcap(path, "udp", vlan=True, ipv6=True).sum()) == 3


@pytest.mark.parametrize("name,mode,total", [("udp.pcap", "udp", 39), ("tcp.pcap", "tcp", 4)])
@pytest.mark.parametrize("strict", [False, True])
def test_extensions_do_not_change_fixture_counts(
    reference_dir, name, mode, total, strict
):
    """Fixtures are untagged IPv4: flags on must be a no-op there (this also
    cross-checks the numpy extended path against the native compat path,
    which is skipped whenever vlan/ipv6 is set)."""
    pcap = read_pcap(reference_dir / name)
    base = decode_headers(pcap, mode, strict=strict)
    ext = decode_headers(pcap, mode, strict=strict, vlan=True, ipv6=True)
    for a, b in zip(base, ext):
        assert (np.asarray(a) == np.asarray(b)).all()
    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    counts = matcher.count_pcap(reference_dir / name, mode, vlan=True, ipv6=True)
    assert int(np.asarray(counts).sum()) == total


def test_cli_vlan_ipv6_flags(tmp_path, reference_dir):
    frames = [
        _eth(_ipv4_udp(b"xml one"), 0x0800, vlan_tags=[(0x8100, 3)]),
        _eth(_ipv6_udp(b"xml two"), 0x86DD),
    ]
    path = _write_pcap(tmp_path / "cli.pcap", frames)
    out = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match",
         "--pcap", str(path), "--patterns", str(reference_dir / "strings.txt"),
         "--vlan", "--ipv6", "--engine", "window", "--json"],
        capture_output=True, text=True, check=True,
        env={"MSM_PLATFORM": "cpu", "PATH": "/usr/bin:/bin", "HOME": "/root"},
    )
    import json

    blob = json.loads(out.stdout)
    assert sum(blob["counts"]) == 2


def test_cli_engine_auto_accepted(reference_dir):
    """Regression: MatchConfig.validate once rejected the --engine auto the
    CLI advertises."""
    import json as json_

    out = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match",
         "--pcap", str(reference_dir / "udp.pcap"),
         "--patterns", str(reference_dir / "strings.txt"),
         "--engine", "auto", "--json"],
        capture_output=True, text=True, check=True,
        env={"MSM_PLATFORM": "cpu", "PATH": "/usr/bin:/bin", "HOME": "/root"},
    )
    assert sum(json_.loads(out.stdout)["counts"]) == 39


# -- link-layer awareness (SLL / raw IP / NULL loopback) ---------------------


def _write_pcap_lt(path, frames, linktype):
    out = bytearray(
        struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, linktype)
    )
    for fb in frames:
        out += struct.pack("<IIII", 0, 0, len(fb), len(fb))
        out += fb
    path.write_bytes(out)
    return path


def _sll(inner, protocol):
    # pkttype(2) arphrd(2) lladdrlen(2) addr(8) protocol(2)
    return struct.pack(">HHH8sH", 0, 1, 6, b"\xaa" * 8, protocol) + inner


def test_linktype_sll_udp(tmp_path):
    frames = [_sll(_ipv4_udp(PAYLOAD), 0x0800)]
    pcap = read_pcap(_write_pcap_lt(tmp_path / "sll.pcap", frames, 113))
    batch = extract_payloads(pcap, "udp")
    assert int(batch.valid.sum()) == 1 and batch.payload(0) == PAYLOAD
    # strict mode reads the SLL protocol field; IPv6-over-SLL also decodes
    strict = extract_payloads(pcap, "udp", strict=True)
    assert int(strict.valid.sum()) == 1
    v6 = [_sll(_ipv6_udp(PAYLOAD), 0x86DD)]
    p6 = read_pcap(_write_pcap_lt(tmp_path / "sll6.pcap", v6, 113))
    b6 = extract_payloads(p6, "udp", ipv6=True)
    assert int(b6.valid.sum()) == 1 and b6.payload(0) == PAYLOAD


def test_linktype_raw_ip(tmp_path):
    frames = [_ipv4_udp(PAYLOAD), _ipv6_udp(PAYLOAD)]
    pcap = read_pcap(_write_pcap_lt(tmp_path / "raw.pcap", frames, 101))
    v4only = extract_payloads(pcap, "udp", keep_invalid=True)
    assert v4only.valid.tolist() == [True, False]
    assert v4only.payload(0) == PAYLOAD
    both = extract_payloads(pcap, "udp", ipv6=True, keep_invalid=True)
    assert both.valid.tolist() == [True, True]
    assert both.payload(1) == PAYLOAD
    strict = extract_payloads(pcap, "udp", strict=True, keep_invalid=True)
    assert strict.valid.tolist() == [True, False]


@pytest.mark.parametrize("endian", ["<", ">"])
def test_linktype_null_loopback(tmp_path, endian):
    frames = [
        struct.pack(endian + "I", 2) + _ipv4_udp(PAYLOAD),
        struct.pack(endian + "I", 30) + _ipv6_udp(PAYLOAD),
    ]
    pcap = read_pcap(_write_pcap_lt(tmp_path / f"null{ord(endian)}.pcap", frames, 0))
    batch = extract_payloads(pcap, "udp", ipv6=True, keep_invalid=True)
    assert batch.valid.tolist() == [True, True]
    assert batch.payload(0) == PAYLOAD and batch.payload(1) == PAYLOAD
    strict = extract_payloads(pcap, "udp", strict=True, keep_invalid=True)
    assert strict.valid.tolist() == [True, False]  # v6 needs ipv6=True


def test_unknown_linktype_keeps_ethernet_fallback(tmp_path):
    """Reference behavior: everything not specially handled decodes as
    Ethernet (the fixtures are linktype 1; this pins the fallback)."""
    frames = [_eth(_ipv4_udp(PAYLOAD), 0x0800)]
    pcap = read_pcap(_write_pcap_lt(tmp_path / "odd.pcap", frames, 147))
    batch = extract_payloads(pcap, "udp")
    assert int(batch.valid.sum()) == 1 and batch.payload(0) == PAYLOAD


# -- randomized differential fuzz: vectorized decode vs a per-packet oracle --


def _oracle_extract(pkt, origlen, mode, lt, strict, vlan, ipv6):
    """Independent, sequential re-statement of the extended predicate.

    Mirrors io/decode.py's documented semantics (including the reference's
    v4 quirks) one packet at a time — a divergence means the vectorized
    masks are wrong somewhere.
    """
    cap = len(pkt)
    L = origlen

    def byte(i):
        return pkt[i] if 0 <= i < cap else None

    # link layer
    if lt == 113:
        et_off, l2 = 14, 16
    elif lt in (101, 12, 14):
        et_off, l2 = None, 0
    elif lt == 0:
        et_off, l2 = None, 4
    else:
        et_off, l2 = 12, 14

    et = None
    if et_off is not None:
        def read_et(o):
            return (pkt[o] << 8) | pkt[o + 1] if cap >= o + 2 else -1

        et = read_et(et_off)
        if vlan:
            for _ in range(2):
                if et in (0x8100, 0x88A8):
                    et_off += 4
                    et = read_et(et_off)
            l2 = et_off + 2
        is_v6 = et == 0x86DD
        v4_ok = et == 0x0800
    elif lt == 0:
        if cap >= 4:
            fam_le = int.from_bytes(pkt[:4], "little")
            fam_be = int.from_bytes(pkt[:4], "big")
            is_v6 = fam_le in (24, 28, 30) or fam_be in (24, 28, 30)
            v4_ok = 2 in (fam_le, fam_be)
        else:
            is_v6 = v4_ok = False
    else:  # raw IP
        is_v6 = cap >= 1 and (pkt[0] >> 4) == 6
        v4_ok = cap >= 1 and (pkt[0] >> 4) == 4

    if ipv6 and is_v6:
        want = 17 if mode == "udp" else 6
        if L - l2 < 40 or byte(l2 + 6) is None or byte(l2 + 6) != want:
            return None
        if mode == "udp":
            if L - l2 - 40 < 8:
                return None
            poff = l2 + 40 + 8
        else:
            th = byte(l2 + 40 + 12)
            if th is None:
                return None
            tcplen = (th >> 4) * 4
            if tcplen < 20:
                return None
            poff = l2 + 40 + tcplen
        if L - poff < 0:
            return None
        return poff, L - poff

    vhl = byte(l2)
    iplen = (vhl & 0x0F) * 4 if vhl is not None else 0
    proto = byte(l2 + 9)
    if mode == "udp":
        ok = (
            L >= l2 and L - l2 >= 20 and vhl is not None
            and L - l2 >= iplen and proto == 17 and L - l2 - iplen >= 8
        )
        if strict:
            ok = ok and iplen >= 20 and v4_ok
        poff = l2 + iplen + 8
    else:
        ok = vhl is not None and iplen >= 20
        th = byte(l2 + iplen + 12)
        ok = ok and th is not None
        tcplen = (th >> 4) * 4 if th is not None else 0
        ok = ok and tcplen >= 20
        if strict:
            ok = ok and proto == 6 and v4_ok
        poff = l2 + iplen + tcplen
    if not ok or L - poff < 0:
        return None
    return poff, L - poff


@pytest.mark.parametrize("lt", [1, 113, 101, 0, 147])
@pytest.mark.parametrize("mode", ["udp", "tcp"])
def test_fuzz_extended_decode_vs_oracle(tmp_path, lt, mode):
    rng = np.random.default_rng(lt * 31 + (mode == "tcp"))
    frames = []
    for _ in range(300):
        kind = rng.integers(0, 6)
        payload = bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
        if kind == 0:  # pure random bytes
            frame = bytes(rng.integers(0, 256, rng.integers(0, 80), dtype=np.uint8))
        else:
            inner = {
                1: lambda: _ipv4_udp(payload),
                2: lambda: _ipv6_udp(payload),
                3: lambda: _ipv6_tcp(payload),
                4: lambda: _ipv4_udp(payload),
                5: lambda: _ipv6_udp(payload),
            }[int(kind)]()
            if lt == 113:
                frame = _sll(inner, int(rng.choice([0x0800, 0x86DD, 0x1234])))
            elif lt in (101,):
                frame = inner
            elif lt == 0:
                fam = int(rng.choice([2, 24, 30, 99]))
                order = "<" if rng.integers(0, 2) else ">"
                frame = struct.pack(order + "I", fam) + inner
            else:
                tags = []
                if rng.integers(0, 2):
                    tags.append((0x8100, int(rng.integers(0, 4096))))
                et = int(rng.choice([0x0800, 0x86DD, 0x1234]))
                frame = _eth(inner, et, vlan_tags=tags)
            if rng.integers(0, 4) == 0:  # random truncation
                frame = frame[: rng.integers(0, len(frame) + 1)]
        frames.append(frame)
    path = _write_pcap_lt(tmp_path / f"fuzz_{lt}_{mode}.pcap", frames, lt)
    pcap = read_pcap(path)
    for strict in (False, True):
        batch = extract_payloads(
            pcap, mode, strict=strict, vlan=True, ipv6=True, keep_invalid=True
        )
        for i, frame in enumerate(frames):
            want = _oracle_extract(
                frame, len(frame), mode, lt, strict, vlan=True, ipv6=True
            )
            if want is None:
                assert not batch.valid[i], (lt, mode, strict, i)
            else:
                poff, plen = want
                assert batch.valid[i], (lt, mode, strict, i)
                assert int(batch.lengths[i]) == min(plen, max(len(frame) - poff, 0)), (
                    lt, mode, strict, i,
                )
                assert batch.payload(i) == frame[poff : poff + int(batch.lengths[i])]


def test_bpf_mask_ipv6_fragment_matches_kernel_program(tmp_path):
    """Regression (round-2 review): tcpdump's 'udp' — and the kernel cBPF
    program LiveSource installs — accept an IPv6 FRAGMENT whose post-
    fragment next-header matches; bpf_protocol_mask must agree, or live
    and replay 'sniffed' totals diverge on fragmented v6 traffic."""
    import struct

    from multithreading_string_matching.io.decode import bpf_protocol_mask
    from multithreading_string_matching.io.live import (
        bpf_protocol_program,
        bpf_simulate,
    )
    from multithreading_string_matching.io.pcap import read_pcap

    def v6_frame(next_hdr, frag_next=None):
        payload = b"\x00" * 16
        ext = b""
        if frag_next is not None:
            ext = struct.pack(">BB", frag_next, 0) + b"\x00" * 6  # frag hdr
        ip = struct.pack(
            ">IHBB16s16s", 0x6 << 28, len(ext) + len(payload), next_hdr, 64,
            b"\x00" * 16, b"\x00" * 16,
        )
        return b"\xaa" * 12 + b"\x86\xdd" + ip + ext + payload

    frames = [
        v6_frame(17),            # plain v6 UDP
        v6_frame(44, frag_next=17),   # fragmented v6 UDP
        v6_frame(44, frag_next=6),    # fragmented v6 TCP
        v6_frame(6),             # plain v6 TCP
    ]
    raw = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for f in frames:
        raw += struct.pack("<IIII", 0, 0, len(f), len(f)) + f
    p = tmp_path / "v6frag.pcap"
    p.write_bytes(raw)
    pcap = read_pcap(p)

    for mode in ("udp", "tcp"):
        mask = bpf_protocol_mask(pcap, mode).tolist()
        prog = bpf_protocol_program(mode)
        kernel = [bpf_simulate(prog, f) > 0 for f in frames]
        assert mask == kernel, f"{mode}: mask {mask} != cBPF {kernel}"
    assert bpf_protocol_mask(pcap, "udp").tolist() == [True, True, False, False]
