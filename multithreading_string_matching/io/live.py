"""Live / streaming packet sources (component C3).

The reference opens an interface with libpcap, installs a "udp"/"tcp" BPF
filter, and pulls packets one at a time until SIGINT
(live_openmp_task.c:103-166).  Here a source is just an iterator of
:class:`PcapFile` batches feeding the same tensor pipeline:

- :class:`LiveSource` — an AF_PACKET raw socket (Linux; needs CAP_NET_RAW).
  Protocol filtering is NOT done here: the vectorized decoder already
  implements the mode predicate (the reference's BPF filter and
  dump_*_packet checks overlap — doing it once in the decoder keeps one
  code path for offline and live).
- :class:`FileReplaySource` — replays a pcap file in batches, for tests and
  offline development (the reference's own fixtures stand in for traffic).

Batch granularity defaults to 10 packets (live_openmp_task.c:142).
"""

from __future__ import annotations

import ctypes
import mmap
import select
import socket
import struct
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from multithreading_string_matching.io.pcap import PcapFile, read_pcap

DEFAULT_BATCH = 10
ETH_P_ALL = 0x0003

# Linux socket-option constants for kernel-level capture control (values
# from <linux/filter.h> / <linux/if_packet.h>; stable ABI).
SO_ATTACH_FILTER = 26
SOL_PACKET = 263
PACKET_ADD_MEMBERSHIP = 1
PACKET_DROP_MEMBERSHIP = 2
PACKET_MR_PROMISC = 1

LINKTYPE_ETHERNET = 1
LINKTYPE_RAW = 101
# ARPHRD (if_arp.h) hardware type -> pcap linktype, libpcap's pcap-linux
# mapping for the decoder's supported linktypes: Ethernet-framed interfaces
# keep EN10MB (Linux lo included); header-less IP interfaces (ipip/sit
# tunnels, tun, wireguard's ARPHRD_NONE) are raw IP.
_LINKTYPE_BY_HATYPE = {
    1: LINKTYPE_ETHERNET,      # ARPHRD_ETHER
    772: LINKTYPE_ETHERNET,    # ARPHRD_LOOPBACK
    768: LINKTYPE_RAW,         # ARPHRD_TUNNEL (ipip)
    776: LINKTYPE_RAW,         # ARPHRD_SIT
    778: LINKTYPE_RAW,         # ARPHRD_IPGRE
    65534: LINKTYPE_RAW,       # ARPHRD_NONE (tun, wireguard)
}
# Hardware types whose frames are really Ethernet-laid-out — the only ones
# where the EN10MB cBPF filter offsets are valid.
_ETHER_HATYPES = (1, 772)

_PROTO_NUM = {"udp": 17, "tcp": 6}

# TPACKET_V3 memory-mapped RX ring (<linux/if_packet.h>, stable ABI).
# This is the capture path libpcap itself uses under pcap_open_live on
# Linux — the kernel writes frames into shared memory in block-sized
# batches and hands each block to userspace with one status-word flip, so
# the per-packet recvfrom() syscall disappears from the hot loop.
PACKET_VERSION = 10
PACKET_RX_RING = 5
TPACKET_V3 = 2
TP_STATUS_KERNEL = 0
TP_STATUS_USER = 1
TP_STATUS_VLAN_VALID = 1 << 4
TP_STATUS_VLAN_TPID_VALID = 1 << 6

# Ring geometry: 32 x 128 KiB blocks (4 MiB).  A block must hold a
# max-snaplen frame (65535 + headers < 128 KiB); tp_block_size must be a
# multiple of the page size, tp_frame_size of TPACKET_ALIGNMENT(16), and
# tp_frame_nr must equal blocks * (block_size // frame_size).
_RING_BLOCK_SIZE = 1 << 17
_RING_BLOCK_NR = 32
_RING_FRAME_SIZE = 2048

# struct offsets inside the mapped ring (tpacket_block_desc / tpacket3_hdr).
_BD_STATUS = 8         # tpacket_hdr_v1.block_status (after version+priv u32s)
_BD_NUM_PKTS = 12      # tpacket_hdr_v1.num_pkts, offset_to_first_pkt
_T3_FIXED = "<IIIIIIHH"  # next_off, sec, nsec, snaplen, len, status, mac, net
_T3_VLAN_TCI = 32      # hv1.tp_vlan_tci (u32, after tp_rxhash at 28)
_T3_VLAN_TPID = 36     # hv1.tp_vlan_tpid (u16)


def bpf_protocol_program(mode: str) -> List[Tuple[int, int, int, int]]:
    """The classic-BPF program ``pcap_compile(handle, &fp, "udp"/"tcp")``
    produces for an EN10MB link (tcpdump -dd), as (code, jt, jf, k) tuples.

    The reference installs exactly this filter in the kernel
    (live_openmp_task.c:127-136) so non-matching traffic is dropped before
    it ever crosses into userspace; :class:`LiveSource` with
    ``filter_mode=`` reproduces that.  Structure: ethertype switch at
    byte 12 — IPv6 checks the next-header byte (20) and, for fragments
    (next-header 44), the post-fragment-header byte (54); IPv4 checks the
    protocol byte (23).  Accept returns the full snap, reject returns 0.
    """
    proto = _PROTO_NUM[mode]
    return [
        (0x28, 0, 0, 12),       # ldh [12]        ethertype
        (0x15, 0, 5, 0x86DD),   # jeq IPv6  ? +1 : +6
        (0x30, 0, 0, 20),       # ldb [20]        v6 next header
        (0x15, 6, 0, proto),    # jeq proto ? accept
        (0x15, 0, 6, 44),       # jeq frag  ? +1 : reject
        (0x30, 0, 0, 54),       # ldb [54]        post-frag next header
        (0x15, 3, 4, proto),    # jeq proto ? accept : reject
        (0x15, 0, 3, 0x0800),   # jeq IPv4  ? +1 : reject
        (0x30, 0, 0, 23),       # ldb [23]        v4 protocol
        (0x15, 0, 1, proto),    # jeq proto ? +1 : reject
        (0x06, 0, 0, 0x40000),  # ret 262144      accept (full snap)
        (0x06, 0, 0, 0),        # ret 0           drop
    ]


def bpf_simulate(program, frame: bytes) -> int:
    """Reference interpreter for the cBPF subset the programs above use
    (ldh/ldb absolute, jeq, ret) — lets tests prove the filter's accept/
    reject behavior without a kernel.  Returns the snap length (0 = drop).
    Out-of-bounds loads terminate with 0, as the kernel's checker does."""
    pc, acc = 0, 0
    while pc < len(program):
        code, jt, jf, k = program[pc]
        if code == 0x28:     # ldh [k]
            if k + 2 > len(frame):
                return 0
            acc = struct.unpack_from(">H", frame, k)[0]
        elif code == 0x30:   # ldb [k]
            if k >= len(frame):
                return 0
            acc = frame[k]
        elif code == 0x15:   # jeq #k, jt, jf
            pc += jt if acc == k else jf
        elif code == 0x06:   # ret #k
            return k
        else:  # pragma: no cover - programs above use no other opcodes
            raise ValueError(f"unsupported cBPF opcode {code:#x}")
        pc += 1
    raise ValueError("cBPF program fell off the end")


def _attach_kernel_filter(sock: socket.socket, mode: str) -> None:
    """setsockopt(SO_ATTACH_FILTER) with the classic-BPF protocol program —
    struct sock_fprog is (u16 len, pad, struct sock_filter *)."""
    prog = bpf_protocol_program(mode)
    blob = b"".join(struct.pack("HBBI", *insn) for insn in prog)
    buf = ctypes.create_string_buffer(blob, len(blob))
    fprog = struct.pack("HL", len(prog), ctypes.addressof(buf))
    # The kernel copies the program during setsockopt; buf only needs to
    # outlive this call (it does — local scope).
    sock.setsockopt(socket.SOL_SOCKET, SO_ATTACH_FILTER, fprog)


def _batch_from_packets(packets, linktype=1) -> PcapFile:
    """Wrap a list of raw packet byte strings as an in-memory PcapFile."""
    if packets:
        buf = np.frombuffer(b"".join(packets), dtype=np.uint8).copy()
        lens = np.array([len(p) for p in packets], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    else:
        buf = np.zeros(0, dtype=np.uint8)
        lens = np.zeros(0, dtype=np.int64)
        offsets = np.zeros(0, dtype=np.int64)
    now = int(time.time())
    return PcapFile(
        buf=buf,
        offsets=offsets,
        caplens=lens,
        origlens=lens.copy(),
        ts_sec=np.full(len(packets), now, dtype=np.int64),
        ts_frac=np.zeros(len(packets), dtype=np.int64),
        linktype=linktype,
        snaplen=65535,
        nanos=False,
    )


class FileReplaySource:
    """Replay a pcap file as batches of whole packets."""

    def __init__(self, path, batch_size: int = DEFAULT_BATCH):
        self.pcap = read_pcap(path)
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[PcapFile]:
        pc = self.pcap
        for start in range(0, pc.num_packets, self.batch_size):
            stop = min(start + self.batch_size, pc.num_packets)
            yield PcapFile(
                buf=pc.buf,
                offsets=pc.offsets[start:stop],
                caplens=pc.caplens[start:stop],
                origlens=pc.origlens[start:stop],
                ts_sec=pc.ts_sec[start:stop],
                ts_frac=pc.ts_frac[start:stop],
                linktype=pc.linktype,
                snaplen=pc.snaplen,
                nanos=pc.nanos,
            )


class LiveSource:
    """Capture from a network interface via an AF_PACKET raw socket.

    Yields batches of ``batch_size`` packets; a receive timeout lets the
    caller's stop flag (SIGINT) be observed between packets, mirroring the
    reference's pcap_next loop + signalFlag (live_openmp_task.c:164-166).
    A partial batch is yielded on stop — the reference's leftover-drain
    (live_openmp_task.c:222-225).

    ``filter_mode='udp'|'tcp'`` installs the classic-BPF protocol program
    IN THE KERNEL (SO_ATTACH_FILTER) — non-matching traffic is dropped
    before the userspace recv loop ever sees it, exactly the reference's
    pcap_compile/pcap_setfilter (live_openmp_task.c:127-136).  Frames that
    raced onto the socket before the filter attached are drained off.

    ``promiscuous=True`` joins PACKET_MR_PROMISC on the interface (dropped
    again on close), the reference's ``pcap_open_live(..., promisc=1, ...)``
    (live_openmp_task.c:111-112) — an IDS tap on a mirror port needs it to
    see frames not addressed to this host.

    ``ring=True`` switches the receive loop to a TPACKET_V3 memory-mapped
    RX ring — the same kernel fast path libpcap uses under pcap_open_live.
    Frames land in shared memory in block-sized batches; userspace pays
    one poll() per retired block instead of one recvfrom() per packet, and
    each batch carries the kernel's own per-packet nanosecond timestamps
    and true wire lengths (recv mode can only stamp at batch assembly and
    cannot see pre-truncation lengths).  Batches are one-per-block (up to
    128 KiB of frames), not ``batch_size``-sized; a quiet interface still
    retires (empty) blocks every ``timeout_s`` so SIGINT is observed.
    Kernel-stripped VLAN tags are reinserted from the ring metadata, so
    ring and recv captures decode identically under ``vlan=True``.
    """

    def __init__(
        self,
        interface: str,
        batch_size: int = DEFAULT_BATCH,
        snaplen: int = 65535,
        timeout_s: float = 0.5,
        filter_mode: Optional[str] = None,
        promiscuous: bool = False,
        ring: bool = False,
    ):
        if filter_mode is not None and filter_mode not in _PROTO_NUM:
            raise ValueError(
                f"filter_mode must be one of {sorted(_PROTO_NUM)} or None, "
                f"got {filter_mode!r}"
            )
        self.interface = interface
        self.batch_size = batch_size
        self.snaplen = snaplen
        self.timeout_s = timeout_s
        self.filter_mode = filter_mode
        self.promiscuous = promiscuous
        self.ring = ring
        self.stopped = False
        self.linktype = LINKTYPE_ETHERNET  # resolved from ARPHRD at open()
        self._sock: Optional[socket.socket] = None
        self._promisc_on = False
        self._ring_map: Optional[mmap.mmap] = None

    def open(self):
        self._sock = socket.socket(
            socket.AF_PACKET, socket.SOCK_RAW, socket.htons(ETH_P_ALL)
        )
        try:
            # Order matters (libpcap's): BIND first — an unbound ETH_P_ALL
            # socket receives from EVERY interface, so anything queued
            # pre-bind could be mistaken for this interface's traffic.
            # Then filter, then drain (pre-bind strays from other
            # interfaces AND, when a filter was attached, frames that
            # raced in unfiltered post-bind), then promisc.
            self._sock.bind((self.interface, 0))
            # Map the interface's ARPHRD hardware type to the pcap linktype
            # (libpcap's pcap-linux mapping for the types we decode):
            # raw-IP interfaces (tun/wireguard/ipip/sit) carry no Ethernet
            # header — decoding them as Ethernet silently mismatches every
            # packet.  Unknown types keep the Ethernet fallback (= the
            # decoder's documented reference behavior).
            hatype = self._sock.getsockname()[3]
            self.linktype = _LINKTYPE_BY_HATYPE.get(hatype, LINKTYPE_ETHERNET)
            if self.filter_mode is not None:
                # Attach the EN10MB cBPF program only when the hardware
                # type is KNOWN Ethernet-framed: on an unknown type the
                # linktype falls back to Ethernet for DECODE (reference
                # behavior), but installing Ethernet-offset filter loads
                # there would silently drop nearly all traffic.  Skipped
                # filters run post-capture instead (bpf_protocol_mask is
                # linktype-aware; counts and 'sniffed' stay equivalent).
                if hatype in _ETHER_HATYPES:
                    _attach_kernel_filter(self._sock, self.filter_mode)
            self._sock.setblocking(False)
            try:
                while True:
                    self._sock.recv(self.snaplen)
            except (BlockingIOError, InterruptedError):
                pass
            if self.ring:
                # Version must be set before the ring is sized; frames
                # arriving from here on are delivered into the mapping,
                # never the (just-drained) socket queue.  The block retire
                # timer doubles as the stop-flag poll interval.
                self._sock.setsockopt(SOL_PACKET, PACKET_VERSION, TPACKET_V3)
                req3 = struct.pack(
                    "7I", _RING_BLOCK_SIZE, _RING_BLOCK_NR, _RING_FRAME_SIZE,
                    _RING_BLOCK_SIZE // _RING_FRAME_SIZE * _RING_BLOCK_NR,
                    max(1, int(self.timeout_s * 1000)), 0, 0,
                )
                self._sock.setsockopt(SOL_PACKET, PACKET_RX_RING, req3)
                self._ring_map = mmap.mmap(
                    self._sock.fileno(), _RING_BLOCK_SIZE * _RING_BLOCK_NR,
                    mmap.MAP_SHARED, mmap.PROT_READ | mmap.PROT_WRITE,
                )
            if self.promiscuous:
                mreq = struct.pack(
                    "IHH8s", socket.if_nametoindex(self.interface),
                    PACKET_MR_PROMISC, 0, b"\x00" * 8,
                )
                self._sock.setsockopt(SOL_PACKET, PACKET_ADD_MEMBERSHIP, mreq)
                self._promisc_on = True
            self._sock.settimeout(self.timeout_s)
        except BaseException:
            if self._ring_map is not None:
                self._ring_map.close()
                self._ring_map = None
            self._sock.close()
            self._sock = None
            raise

    def close(self):
        if self._ring_map is not None:
            self._ring_map.close()
            self._ring_map = None
        if self._sock is not None:
            if self._promisc_on:
                try:
                    mreq = struct.pack(
                        "IHH8s", socket.if_nametoindex(self.interface),
                        PACKET_MR_PROMISC, 0, b"\x00" * 8,
                    )
                    self._sock.setsockopt(
                        SOL_PACKET, PACKET_DROP_MEMBERSHIP, mreq
                    )
                except OSError:
                    pass  # interface went away; kernel drops it with the fd
                self._promisc_on = False
            self._sock.close()
            self._sock = None

    def __enter__(self) -> "LiveSource":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stop(self):
        self.stopped = True

    def __iter__(self) -> Iterator[PcapFile]:
        if self._sock is None:
            self.open()
        if self.ring:
            yield from self._iter_ring()
        else:
            yield from self._iter_recv()

    def _iter_recv(self) -> Iterator[PcapFile]:
        pending = []
        try:
            while not self.stopped:
                try:
                    pkt = self._sock.recv(self.snaplen)
                except socket.timeout:
                    continue
                pending.append(pkt)
                if len(pending) >= self.batch_size:
                    yield _batch_from_packets(pending, linktype=self.linktype)
                    pending = []
            if pending:  # leftover partial batch on graceful stop
                yield _batch_from_packets(pending, linktype=self.linktype)
        finally:
            self.close()

    def _read_block(self, blk: int) -> Optional[PcapFile]:
        """Consume one USER-owned ring block: walk its tpacket3 packets,
        build a batch, and hand the block back to the kernel.  Returns
        None for an (empty) timer-retired block."""
        mm = self._ring_map
        num_pkts, first_off = struct.unpack_from("<II", mm, blk + _BD_NUM_PKTS)
        pkts: List[bytes] = []
        secs: List[int] = []
        nsecs: List[int] = []
        origs: List[int] = []
        off = blk + first_off
        for _ in range(num_pkts):
            (nxt, sec, nsec, snap, length, pstatus, mac, _net
             ) = struct.unpack_from(_T3_FIXED, mm, off)
            frame = bytes(mm[off + mac : off + mac + snap])
            if (pstatus & TP_STATUS_VLAN_VALID
                    and self.linktype == LINKTYPE_ETHERNET
                    and len(frame) >= 12):
                # The kernel strips 802.1Q tags on ingress and parks them
                # in the ring metadata; reinsert so ring captures decode
                # like wire frames (what libpcap does for tcpdump).
                tci = struct.unpack_from("<I", mm, off + _T3_VLAN_TCI)[0]
                tpid = (
                    struct.unpack_from("<H", mm, off + _T3_VLAN_TPID)[0]
                    if pstatus & TP_STATUS_VLAN_TPID_VALID else 0x8100
                )
                frame = (frame[:12] + struct.pack(">HH", tpid, tci & 0xFFFF)
                         + frame[12:])
                length += 4
            # TPACKET_V3 delivers full frames regardless of snaplen;
            # truncate the copy so caplens never exceed the PcapFile's
            # declared snaplen (matching recv mode's recv(snaplen) and the
            # headers write_pcap emits).  tp_len stays the wire length.
            wire_len = max(length, len(frame))
            if len(frame) > self.snaplen:
                frame = frame[: self.snaplen]
            pkts.append(frame)
            secs.append(sec)
            nsecs.append(nsec)
            origs.append(wire_len)
            off += nxt
        struct.pack_into("<I", mm, blk + _BD_STATUS, TP_STATUS_KERNEL)
        if not pkts:
            return None
        lens = np.array([len(p) for p in pkts], dtype=np.int64)
        return PcapFile(
            buf=np.frombuffer(b"".join(pkts), dtype=np.uint8).copy(),
            offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
            caplens=lens,
            origlens=np.array(origs, dtype=np.int64),
            ts_sec=np.array(secs, dtype=np.int64),
            ts_frac=np.array(nsecs, dtype=np.int64),
            linktype=self.linktype,
            snaplen=self.snaplen,
            nanos=True,
        )

    def _iter_ring(self) -> Iterator[PcapFile]:
        mm = self._ring_map
        poller = select.poll()
        poller.register(self._sock.fileno(), select.POLLIN | select.POLLERR)
        idx = 0
        try:
            while not self.stopped:
                blk = idx * _RING_BLOCK_SIZE
                status = struct.unpack_from("<I", mm, blk + _BD_STATUS)[0]
                if not (status & TP_STATUS_USER):
                    # Quiet ring: the retire timer (timeout_s) bounds how
                    # long this sleeps, so the stop flag stays responsive.
                    poller.poll(max(1, int(self.timeout_s * 1000)))
                    continue
                batch = self._read_block(blk)
                idx = (idx + 1) % _RING_BLOCK_NR
                if batch is not None:
                    yield batch
            # Graceful-stop drain: blocks the kernel already retired are
            # ours to keep (the reference's leftover-batch drain).  The
            # still-open block stays with the kernel — same loss semantics
            # as libpcap's pcap_close mid-block.  Bounded to ONE ring pass:
            # _read_block hands each block back to the kernel, which under
            # sustained traffic refills and retires it again — an unbounded
            # drain would chase the producer forever and stop() would hang.
            for _ in range(_RING_BLOCK_NR):
                blk = idx * _RING_BLOCK_SIZE
                status = struct.unpack_from("<I", mm, blk + _BD_STATUS)[0]
                if not (status & TP_STATUS_USER):
                    break
                batch = self._read_block(blk)
                idx = (idx + 1) % _RING_BLOCK_NR
                if batch is not None:
                    yield batch
        finally:
            self.close()
