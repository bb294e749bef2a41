"""Synthetic corpus generation — the stand-in for the stripped mega_udp.pcap.

The reference bundles a ``mega_udp.pcap`` that is absent from the repo
(.MISSING_LARGE_BLOBS:1).  This generator writes classic-pcap files of
arbitrary size whose packets exercise the same decode paths (valid UDP with
varying IHL, invalid runts, non-UDP protocols) and whose payloads embed
pattern occurrences at a controlled rate, so benchmarks and stress tests can
scale beyond the bundled fixtures.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np


def synth_patterns(
    n: int,
    *,
    min_len: int = 2,
    max_len: int = 12,
    dup_rate: float = 0.1,
    seed: int = 0,
) -> list:
    """A seeded rule-file-shaped pattern list: ``n`` ASCII-letter/digit
    tokens of mixed length in ``[min_len, max_len]``, about ``dup_rate`` of
    them repeats of an earlier entry (pattern files keep duplicates, and
    counts report each entry — serial.c:163-166)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
        np.uint8,
    )
    out = []
    for _ in range(n):
        if out and rng.random() < dup_rate:
            out.append(out[int(rng.integers(0, len(out)))])
            continue
        ln = int(rng.integers(min_len, max_len + 1))
        out.append(alphabet[rng.integers(0, alphabet.size, ln)].tobytes())
    return out


def synth_udp_pcap(
    path,
    num_packets: int,
    *,
    payload_len: int = 1024,
    payload_len_jitter: int = 0,
    patterns: Optional[Sequence[bytes]] = None,
    plant_rate: float = 0.01,
    invalid_rate: float = 0.0,
    seed: int = 0,
) -> int:
    """Write a synthetic Ethernet/IPv4/UDP capture; returns total payload bytes.

    ``plant_rate``: fraction of packets that get one pattern planted at a
    random offset.  ``invalid_rate``: fraction of packets made undecodable
    (runts / wrong protocol) to exercise the validity predicate.
    """
    from multithreading_string_matching.io.pcap import classic_global_header

    rng = np.random.default_rng(seed)
    total_payload = 0
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i in range(num_packets):
            r = rng.random()
            if r < invalid_rate:
                kind = rng.integers(0, 2)
                pkt = (
                    bytes(rng.integers(0, 256, size=10, dtype=np.uint8))  # runt
                    if kind == 0
                    else _eth_ipv4(b"x" * 20, proto=6)  # TCP proto in udp mode
                )
            else:
                ln = payload_len
                if payload_len_jitter:
                    ln = int(rng.integers(max(0, payload_len - payload_len_jitter),
                                          payload_len + payload_len_jitter + 1))
                payload = rng.integers(0, 256, size=ln, dtype=np.uint8)
                if patterns is not None and rng.random() < plant_rate and ln > 0:
                    p = patterns[int(rng.integers(0, len(patterns)))]
                    if len(p) <= ln:
                        off = int(rng.integers(0, ln - len(p) + 1))
                        payload[off : off + len(p)] = np.frombuffer(p, np.uint8)
                # ~10% of packets carry IP options (ihl=6) so the decoder's
                # variable-header arithmetic is exercised, not just ihl=5.
                ihl = 6 if rng.random() < 0.1 else 5
                pkt = _eth_ipv4(payload.tobytes(), proto=17, ihl=ihl)
                total_payload += ln
            f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
            f.write(pkt)
    return total_payload


def synth_tcp_flows_pcap(
    path,
    flows,
    *,
    segment_len: int = 0,
    interleave_seed: Optional[int] = None,
    noise_packets: int = 0,
    seed: int = 0,
    reorder_seed: Optional[int] = None,
    retransmit_rate: float = 0.0,
    overlap_rate: float = 0.0,
    vlan_rate: float = 0.0,
) -> int:
    """Write a capture of TCP flows with controlled segmentation.

    ``flows``: sequence of ``((src_ip, dst_ip, sport, dport), payload)`` or
    ``(key, payload, segment_lens)`` — the stream bytes are split into
    segments (``segment_lens`` explicit, or fixed ``segment_len``, or one
    segment).  Segments keep per-flow order; ``interleave_seed`` shuffles
    segments ACROSS flows (the split-signature test shape: another flow's
    packet lands between two halves of a signature).  ``noise_packets``
    appends undecodable/UDP frames to exercise the non-flow path.  Returns
    total stream bytes.

    Pathological-wire knobs (round 5 — what sequence-aware reassembly
    exists to survive; seq numbers stay TRUE to each byte's stream
    position throughout):

    - ``reorder_seed``: shuffle each flow's segment EMISSION order (the
      capture-order concatenation then sees scrambled bytes; seq-ordered
      reassembly recovers the stream);
    - ``retransmit_rate``: after a segment, re-emit a random earlier
      segment of the same flow verbatim (pure retransmission — dropped by
      first-bytes-win trimming);
    - ``overlap_rate``: emit a segment with a tail of its predecessor
      prepended and seq rewound by that much (overlapping retransmit —
      trimmed to its new bytes);
    - ``vlan_rate``: independently wrap each flow frame in an 802.1Q tag
      (~1 in 4 of the tagged frames gets an 802.1ad+802.1Q QinQ pair) —
      the ``--flows --vlan`` test wire; noise packets stay untagged."""
    from multithreading_string_matching.io.pcap import classic_global_header

    rng = np.random.default_rng(seed)
    frames = []  # (flow_order_tag, frame bytes)
    total = 0
    for fi, spec in enumerate(flows):
        key, payload = spec[0], bytes(spec[1])
        seglens = spec[2] if len(spec) > 2 else None
        total += len(payload)
        if seglens is None:
            step = segment_len if segment_len > 0 else max(1, len(payload))
            seglens = [step] * (-(-len(payload) // step)) if payload else [0]
        pos = 0
        seq = 1000 * (fi + 1)
        segs = []  # (seq, bytes) in stream order, pre-knobs
        for sl in seglens:
            seg = payload[pos : pos + sl]
            pos += sl
            segs.append((seq, seg))
            seq += len(seg)
        assert pos >= len(payload), "segment_lens shorter than payload"
        if overlap_rate > 0:
            out = []
            for si, (sq, seg) in enumerate(segs):
                if si and out and rng.random() < overlap_rate:
                    prev_seg = segs[si - 1][1]
                    ov = int(rng.integers(1, len(prev_seg) + 1)) if prev_seg else 0
                    if ov:
                        seg = prev_seg[len(prev_seg) - ov :] + seg
                        sq -= ov
                out.append((sq, seg))
            segs = out
        emit = list(segs)
        if retransmit_rate > 0:
            out = []
            for si, s in enumerate(emit):
                out.append(s)
                if rng.random() < retransmit_rate:
                    out.append(emit[int(rng.integers(0, si + 1))])
            emit = out
        if reorder_seed is not None:
            np.random.default_rng(reorder_seed + fi).shuffle(emit)
        mk = _eth_ipv6_tcp if ":" in str(key[0]) else _eth_ipv4_tcp
        for sq, seg in emit:
            fr = mk(seg, key, sq)
            if vlan_rate > 0 and rng.random() < vlan_rate:
                fr = _vlan_wrap(fr, rng, double=rng.random() < 0.25)
            frames.append((fi, fr))
    if interleave_seed is not None:
        # Shuffle WHICH flow emits at each slot, then emit each flow's
        # segments in order — random cross-flow interleaving that preserves
        # per-flow segment order (the only order reassembly relies on).
        tags = [fi for fi, _ in frames]
        np.random.default_rng(interleave_seed).shuffle(tags)
        by_flow = {}
        for fi, fr in frames:
            by_flow.setdefault(fi, []).append(fr)
        nxt = {fi: 0 for fi in by_flow}
        out_frames = []
        for fi in tags:
            out_frames.append(by_flow[fi][nxt[fi]])
            nxt[fi] += 1
    else:
        out_frames = [fr for _, fr in frames]
    for _ in range(noise_packets):
        pay = rng.integers(0, 256, size=int(rng.integers(0, 64)),
                           dtype=np.uint8).tobytes()
        out_frames.append(_eth_ipv4(pay, proto=17))
    with open(path, "wb") as f:
        f.write(classic_global_header())
        for i, pkt in enumerate(out_frames):
            f.write(struct.pack("<IIII", i, 0, len(pkt), len(pkt)))
            f.write(pkt)
    return total


def _vlan_wrap(frame: bytes, rng, *, double: bool) -> bytes:
    """Insert one 802.1Q tag — or an 802.1ad outer + 802.1Q inner QinQ
    pair — after the Ethernet addresses, preserving the original
    ethertype (the layout io.decode's tag walk skips)."""
    tags = b"\x81\x00" + int(rng.integers(1, 4095)).to_bytes(2, "big")
    if double:
        tags = (b"\x88\xa8" + int(rng.integers(1, 4095)).to_bytes(2, "big")
                + tags)
    return frame[:12] + tags + frame[12:]


def _ip4(s) -> bytes:
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    return bytes(int(x) for x in str(s).split("."))


def _eth_ipv4_tcp(payload: bytes, key, seq: int) -> bytes:
    src, dst, sport, dport = key
    ihl = 5
    ip = bytearray(ihl * 4)
    ip[0] = (4 << 4) | ihl
    ip[9] = 6
    total = ihl * 4 + 20 + len(payload)
    ip[2:4] = total.to_bytes(2, "big")
    ip[12:16] = _ip4(src)
    ip[16:20] = _ip4(dst)
    tcp = struct.pack(">HHIIHHHH", sport, dport, seq, 0,
                      (5 << 12) | 0x18, 65535, 0, 0)  # doff=5, PSH|ACK
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + tcp + payload


def _eth_ipv6_tcp(payload: bytes, key, seq: int) -> bytes:
    """Ethernet + IPv6 (fixed 40-byte header, next-header TCP) + TCP frame —
    flow keys with ':' in the source address route here (synth knob for the
    round-5 v6 flow-key support).  Addresses parse via inet_pton (full or
    '::' shorthand)."""
    import socket

    src, dst, sport, dport = key
    ip6 = bytearray(40)
    ip6[0] = 6 << 4
    ip6[4:6] = (20 + len(payload)).to_bytes(2, "big")
    ip6[6] = 6      # next header: TCP
    ip6[7] = 64     # hop limit
    ip6[8:24] = socket.inet_pton(socket.AF_INET6, str(src))
    ip6[24:40] = socket.inet_pton(socket.AF_INET6, str(dst))
    tcp = struct.pack(">HHIIHHHH", sport, dport, seq, 0,
                      (5 << 12) | 0x18, 65535, 0, 0)
    return b"\x00" * 12 + b"\x86\xdd" + bytes(ip6) + tcp + payload


def _eth_ipv4(payload: bytes, proto: int = 17, ihl: int = 5) -> bytes:
    ip = bytearray(ihl * 4)
    ip[0] = (4 << 4) | ihl
    ip[9] = proto
    total = ihl * 4 + 8 + len(payload)
    ip[2:4] = total.to_bytes(2, "big")
    udp = struct.pack(">HHHH", 1234, 5678, 8 + len(payload), 0)
    return b"\x00" * 12 + b"\x08\x00" + bytes(ip) + udp + payload
