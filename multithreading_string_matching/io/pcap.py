"""Classic-pcap file reading (reference component C2, ingest layer L1).

The reference uses libpcap's ``pcap_open_offline`` + ``pcap_next_ex``
(serial.c:91,115) to iterate packets one at a time and copies each packet's
bytes into a freshly malloc'd buffer.  We replace libpcap entirely: the
classic pcap container is a 24-byte global header followed by
``(16-byte record header, captured bytes)`` records, which a few dozen lines
of numpy parse directly into flat arrays.  All bundled fixtures are classic
pcap, little-endian magic 0xa1b2c3d4, linktype 1 (Ethernet).

Design notes:
- The whole capture is kept as ONE flat ``uint8`` buffer plus per-packet
  ``(offset, caplen, origlen)`` arrays.  Header decode (io/decode.py) then
  runs as vectorized numpy gathers over that buffer — there is no per-packet
  Python object, no per-packet copy until the final padded payload tensor is
  materialized for the device.
- An optional C++ fast path (native/pcap_fast.cpp) walks the record chain;
  the numpy walker below is the portable reference implementation.

Semantics notes vs the reference:
- serial.c:117 copies and decodes ``header->len`` (the ORIGINAL length), not
  ``header->caplen`` — undefined behavior when a packet was truncated at
  capture time (caplen < len).  We define the spec as: decode against
  ``origlen`` (matching the reference's arithmetic) but never read bytes
  beyond ``caplen``; a packet whose decode would need unavailable bytes is
  invalid.  On the bundled fixtures caplen == len for every packet, so this
  never diverges.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Union
import os

import numpy as np

MAGIC_USEC_LE = 0xA1B2C3D4
MAGIC_USEC_BE = 0xD4C3B2A1
MAGIC_NSEC_LE = 0xA1B23C4D
MAGIC_NSEC_BE = 0x4D3CB2A1

LINKTYPE_ETHERNET = 1

# Streaming sanity cap on one record/block: a corrupt length field must
# error out, not buffer gigabytes before discovering the file ends (the
# one-shot readers are implicitly bounded by having the whole file in hand).
# Far above any real capture record (snaplen caps packets at 64 KiB-ish).
_MAX_STREAM_RECORD = 1 << 28

_GLOBAL_HDR = struct.Struct("<IHHiIII")
_GLOBAL_HDR_BE = struct.Struct(">IHHiIII")


class _PrefixReader:
    """A binary reader that replays sniffed head bytes before the stream.

    Lets :func:`open_capture` detect compression magic on non-seekable
    inputs (pipes, stdin) — the 6 sniffed bytes are re-served first, then
    reads pass through.  Implements just the read/close surface the codec
    wrappers and the pcap parsers use.
    """

    def __init__(self, head: bytes, f, owns: bool):
        self._head = head
        self._f = f
        self._owns = owns  # close-through only for files WE opened

    def read(self, n: int = -1) -> bytes:
        if self._head:
            if n is None or n < 0:
                out = self._head + self._f.read()
                self._head = b""
                return out
            out, self._head = self._head[:n], self._head[n:]
            if len(out) < n:
                out += self._f.read(n - len(out))
            return out
        return self._f.read(n)

    def read1(self, n: int = -1) -> bytes:
        """At most one underlying read — never blocks for a full buffer."""
        if self._head:
            out, self._head = (self._head, b"") if n is None or n < 0 else (
                self._head[:n], self._head[n:]
            )
            return out
        r1 = getattr(self._f, "read1", None)
        return r1(n) if r1 is not None else self._f.read(n)

    def seekable(self) -> bool:
        # Drives the parsers' refill mode: big blocking reads for files,
        # whatever-arrived reads for pipes/sockets.
        probe = getattr(self._f, "seekable", None)
        return bool(probe and probe())

    def readable(self) -> bool:  # io protocol, used by BZ2File/LZMAFile
        return True

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _CodecClose:
    """Close a codec wrapper AND its underlying reader together.

    gzip/bz2/lzma file objects never close a ``fileobj`` they were handed;
    this keeps ``with open_capture(path) as f`` leak-free for compressed
    paths while still honoring the reader's own ownership flag.
    """

    def __init__(self, codec, under: "_PrefixReader"):
        self._codec = codec
        self._under = under

    def read(self, n: int = -1) -> bytes:
        return self._codec.read(n)

    def read1(self, n: int = -1) -> bytes:
        return self._codec.read1(n)

    def seekable(self) -> bool:
        # The UNDERLYING source's seekability is the refill-mode signal
        # (decompressed-stream seekability is irrelevant here).
        return self._under.seekable()

    def close(self) -> None:
        self._codec.close()
        self._under.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _codec_errors(f) -> tuple:
    """Exception types that mean "corrupt/truncated compressed data" — ONLY
    when a codec wrapper is actually in the stack.  For plain files the
    tuple is empty, so a genuine I/O error (disk/NFS EIO) propagates as the
    OSError it always was instead of being swallowed or mislabeled.  Codec
    modules import lazily here so plain-pcap reading works on Python builds
    without the optional _lzma/_bz2 modules.
    """
    if not isinstance(f, _CodecClose):
        return ()
    errs = [EOFError, OSError]
    try:
        import zlib

        errs.append(zlib.error)
    except ImportError:
        pass
    try:
        import lzma

        errs.append(lzma.LZMAError)
    except ImportError:
        pass
    return tuple(errs)


def _stream_read(f, n: int, strict: bool) -> bytes:
    """Read exactly ``n`` bytes (short only at end-of-stream).

    Loops over short reads — raw/unbuffered pipe sources legally return
    partial data.  A truncated or corrupt compressed file surfaces as a
    codec exception mid-read; map that onto the same contract the parsers
    give truncated plain files: ``strict=True`` raises ValueError,
    ``strict=False`` ends the stream at the last good byte (libpcap-with-
    zlib likewise returns what it decompressed).  Tolerant codec reads step
    via read1 (one underlying read per call) — a big buffered read() would
    discard everything it decoded when the codec raises mid-loop, losing
    the recoverable prefix.
    """
    errors = _codec_errors(f)
    r1 = getattr(f, "read1", None) if (errors and not strict) else None
    parts = []
    got = 0
    while got < n:
        try:
            b = r1(n - got) if r1 is not None else f.read(n - got)
        except errors as e:
            if strict:
                raise ValueError(
                    f"truncated or corrupt compressed capture: {e}"
                ) from e
            break
        if not b:
            break
        parts.append(b)
        got += len(b)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _stream_read1(f, n: int, strict: bool) -> bytes:
    """At most one underlying read: whatever has arrived, up to ``n``.

    The refill mode for non-seekable sources (pipes, stdin): a live
    ``tcpdump -w - |`` feed must flow packets through as they arrive — an
    exact 4 MB fill would stall the matcher until 4 MB of traffic
    accumulated.  Returns b"" only at end-of-stream (or, tolerantly, at a
    codec error).
    """
    errors = _codec_errors(f)
    r1 = getattr(f, "read1", None)
    try:
        return r1(n) if r1 is not None else f.read(n)
    except errors as e:
        if strict:
            raise ValueError(
                f"truncated or corrupt compressed capture: {e}"
            ) from e
        return b""


def _source_seekable(f) -> bool:
    probe = getattr(f, "seekable", None)
    return bool(probe and probe())


def _read_all(f, strict: bool, chunk: int = 4 << 20) -> bytes:
    """Read a whole capture stream, honoring the truncation contract.

    Strict mode is one plain ``read()`` — no extra copies on the 1 GB-class
    one-shot path.  Tolerant mode chunks so the prefix a decompressor
    produced before dying survives the exception.
    """
    if strict:
        try:
            return f.read()
        except _codec_errors(f) as e:
            raise ValueError(
                f"truncated or corrupt compressed capture: {e}"
            ) from e
    parts = []
    while True:
        b = _stream_read(f, chunk, False)
        if not b:
            return b"".join(parts)
        parts.append(b)


def open_capture(source) -> BinaryIO:
    """Open a capture for reading, transparently decompressing.

    ``source`` is a path, ``"-"`` (stdin), or an already-open binary file
    object (e.g. the stdout pipe of ``tcpdump -w -`` — live capture without
    raw-socket privileges in this process).  Capture archives are routinely
    stored gzip/bzip2/xz-compressed (tcpdump rotation hooks, wireshark
    exports); libpcap itself reads ``.pcap.gz`` when built against zlib.
    Detection is by content magic, never file extension, so renamed files
    and pipes work.  All three codecs stream — used from :func:`iter_pcap`
    the decompressed bytes are never fully resident.  No pcap variant can
    collide with these magics (classic pcap starts 0xa1b2/0x4d3c/0xd4c3,
    pcapng starts 0x0a0d0d0a).
    """
    if isinstance(source, (str, os.PathLike)) and str(source) == "-":
        import sys

        source = sys.stdin.buffer
    owns = not hasattr(source, "read")
    f = open(source, "rb") if owns else source
    # Loop the sniff: a raw/unbuffered pipe legally returns short reads,
    # and 4 of 6 xz magic bytes must not demote the file to "plain pcap".
    head = b""
    while len(head) < 6:
        b = f.read(6 - len(head))
        if not b:
            break
        head += b
    pr = _PrefixReader(head, f, owns)
    if head[:2] == b"\x1f\x8b":
        import gzip

        return _CodecClose(gzip.GzipFile(fileobj=pr, mode="rb"), pr)
    if head[:3] == b"BZh":
        import bz2

        return _CodecClose(bz2.BZ2File(pr, "rb"), pr)
    if head[:6] == b"\xfd7zXZ\x00":
        import lzma

        return _CodecClose(lzma.LZMAFile(pr, "rb"), pr)
    return pr


@dataclass(frozen=True)
class PcapFile:
    """A fully ingested capture: one flat byte buffer + per-packet indices."""

    # uint8[total_bytes] — every packet's captured bytes live at
    # buf[offsets[i] : offsets[i]+caplens[i]].  Packets need NOT be
    # contiguous: natively-streamed batches keep the 16-byte record headers
    # between them (one span memcpy instead of one copy per record).
    buf: np.ndarray
    offsets: np.ndarray    # int64[N] — start of packet i's captured bytes in buf
    caplens: np.ndarray    # int64[N] — captured length of packet i
    origlens: np.ndarray   # int64[N] — original (on-the-wire) length of packet i
    ts_sec: np.ndarray     # int64[N]
    ts_frac: np.ndarray    # int64[N] — microseconds or nanoseconds (see nanos)
    linktype: int
    snaplen: int
    nanos: bool

    @property
    def num_packets(self) -> int:
        return int(self.offsets.shape[0])

    def packet(self, i: int) -> np.ndarray:
        """Captured bytes of packet i (a view into the flat buffer)."""
        o = int(self.offsets[i])
        return self.buf[o : o + int(self.caplens[i])]


def _parse_global_header(head: bytes):
    if len(head) < 24:
        raise ValueError("pcap file shorter than its 24-byte global header")
    magic = struct.unpack("<I", head[:4])[0]
    if magic in (MAGIC_USEC_LE, MAGIC_NSEC_LE):
        hdr = _GLOBAL_HDR.unpack(head[:24])
        swapped, nanos = False, magic == MAGIC_NSEC_LE
    elif magic in (MAGIC_USEC_BE, MAGIC_NSEC_BE):
        hdr = _GLOBAL_HDR_BE.unpack(head[:24])
        swapped, nanos = True, magic == MAGIC_NSEC_BE
    else:
        if head[:4] == b"\x0a\x0d\x0d\x0a":
            return "pcapng"
        raise ValueError(f"not a classic pcap file (magic {head[:4].hex()})")
    _, vmaj, vmin, _tz, _sig, snaplen, linktype = hdr
    if (vmaj, vmin) != (2, 4):
        # Tolerate but note other 2.x versions; the record layout is identical.
        if vmaj != 2:
            raise ValueError(f"unsupported pcap version {vmaj}.{vmin}")
    return swapped, nanos, snaplen, linktype


def read_pcap(
    path, *, strict: bool = True, use_native: bool = True
) -> PcapFile:
    """Parse a classic pcap file into a :class:`PcapFile`.

    ``path`` is a filesystem path, ``"-"`` (stdin), or an open binary file
    object (a pipe works — ``tcpdump -w -`` feeds this directly).
    ``strict=False`` tolerates a truncated final record (keeps the complete
    prefix), mirroring libpcap's behavior of returning what it can read.
    ``use_native`` takes the C++ record walk when available (bit-identical;
    see io/native.py).  Compressed captures (gzip/bzip2/xz, detected by
    content magic) decompress transparently — see :func:`open_capture`.
    """
    with open_capture(path) as f:
        raw = _read_all(f, strict)
    parsed = _parse_global_header(raw[:24])
    if parsed == "pcapng":
        # libpcap's pcap_open_offline reads pcapng transparently; so do we.
        return _read_pcapng(raw, strict=strict, use_native=use_native)
    swapped, nanos, snaplen, linktype = parsed
    data = np.frombuffer(raw, dtype=np.uint8)
    total = data.shape[0]

    if use_native:
        from multithreading_string_matching.io import native

        if native.available():
            offs, caps, origs, tss, tsf = native.parse_records(data, swapped, strict)
            return PcapFile(
                buf=data, offsets=offs, caplens=caps, origlens=origs,
                ts_sec=tss, ts_frac=tsf,
                linktype=linktype, snaplen=snaplen, nanos=nanos,
            )

    rec = struct.Struct(">IIII" if swapped else "<IIII")

    offsets, caplens, origlens, tss, tsf = [], [], [], [], []
    pos = 24
    while pos + 16 <= total:
        sec, frac, incl, orig = rec.unpack_from(raw, pos)
        pos += 16
        if pos + incl > total:
            if strict:
                raise ValueError(
                    f"truncated pcap record at byte {pos - 16}: "
                    f"needs {incl} bytes, file has {total - pos}"
                )
            break
        offsets.append(pos)
        caplens.append(incl)
        origlens.append(orig)
        tss.append(sec)
        tsf.append(frac)
        pos += incl
    if strict and pos != total:
        raise ValueError(f"{total - pos} trailing bytes after last pcap record")

    return PcapFile(
        buf=data,
        offsets=np.asarray(offsets, dtype=np.int64),
        caplens=np.asarray(caplens, dtype=np.int64),
        origlens=np.asarray(origlens, dtype=np.int64),
        ts_sec=np.asarray(tss, dtype=np.int64),
        ts_frac=np.asarray(tsf, dtype=np.int64),
        linktype=linktype,
        snaplen=snaplen,
        nanos=nanos,
    )


_PCAPNG_BOM = 0x1A2B3C4D
# pcapng packet-block types the native walker handles (PB/SPB/EPB).
_PCAPNG_PACKET_BLOCKS = (2, 3, 6)
# if_tsresol divisors are Python ints (10**v can exceed int64 for exotic
# resolutions); the native walk only runs while every divisor fits.  Shared
# between the one-shot and streaming readers so the bound cannot drift.
_MAX_TSDIV = 1 << 62


def _extend_native_pcapng(
    accs, span, doffs, caps, origs, ss, ff
):
    """Append one native pcapng walk's packets to the batch accumulators
    ``accs = (chunks, offsets, caplens, origlens, tss, tsf)``.  ``span`` is
    the walked bytes TRIMMED to the last packet's data end — that keeps the
    shared Python block parser's buf-position derivation
    (``offsets[-1] + caplens[-1]``) exact for whatever block it parses
    next.  Offsets point at each packet's data inside the span (block
    headers stay in place)."""
    chunks, offsets, caplens, origlens, tss, tsf = accs
    base = (offsets[-1] + caplens[-1]) if offsets else 0
    chunks.append(span)
    offsets.extend((doffs + base).tolist())
    caplens.extend(caps.tolist())
    origlens.extend(origs.tolist())
    tss.extend(ss.tolist())
    tsf.extend(ff.tolist())


def _read_pcapng(
    raw: bytes, *, strict: bool = True, use_native: bool = True
) -> PcapFile:
    """Minimal pcapng reader: SHB / IDB / EPB / SPB / obsolete PB blocks.

    The reference gets pcapng support for free from libpcap
    (``pcap_open_offline`` autodetects the container); this provides the same
    capability.  Per-section endianness is honored; unknown block types are
    skipped by their length field.  Timestamps are normalized to
    microseconds (``if_tsresol`` applied); the linktype is taken from the
    first interface (the vectorized decoder only interprets Ethernet anyway —
    packets of other linktypes simply fail the validity predicate).
    """
    total = len(raw)
    pos = 0
    end = "<"  # per-section; set at each SHB
    interfaces = []            # (linktype, snaplen, tsresol_divisor_to_usec)
    first_meta = None          # (linktype, snaplen) of the first interface ever
    saw_interface = False
    offsets, caplens, origlens, tss, tsf = [], [], [], [], []
    chunks = []                # captured-bytes slices, concatenated at the end

    def u32(b, o):
        return struct.unpack_from(end + "I", b, o)[0]

    if use_native:
        from multithreading_string_matching.io import native

        use_native = native.available()

    while pos + 12 <= total:
        # Peek the type: invoking the walker on a non-packet block would
        # pay the call + output-array allocation only to stop immediately.
        if (
            use_native
            and u32(raw, pos) in _PCAPNG_PACKET_BLOCKS
            and all(it[2] <= _MAX_TSDIV for it in interfaces)
        ):
            # Runs of packet blocks parse natively (same walker as the
            # streaming reader; block size unbounded — the one-shot reader
            # has no streaming bound — but the batch is capped so the
            # per-call output arrays stay ~40 MB even on multi-GB files).
            count, consumed, status, aux, doffs, caps, origs, ss, ff = (
                native.parse_pcapng(
                    raw, pos, end == ">", 1 << 20, 1 << 62,
                    [it[2] for it in interfaces],
                    interfaces[0][1] if interfaces else 0,
                )
            )
            if count:
                trim = int(doffs[-1] + caps[-1])
                _extend_native_pcapng(
                    (chunks, offsets, caplens, origlens, tss, tsf),
                    raw[pos : pos + trim], doffs, caps, origs, ss, ff,
                )
                pos += consumed
            if status == 1:  # batch cap reached: just keep walking
                continue
            if status == 0:  # next block incomplete
                if aux <= 12:
                    break  # sub-12-byte tail: the while guard's silent exit
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {pos}"
                    )
                break
            if status == 4:  # invalid block header (same message as below)
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {pos}"
                    )
                break
            if status == 5:  # malformed packet block
                if strict:
                    raise ValueError(
                        f"malformed pcapng block (type 0x{aux:08x}) "
                        f"at byte {pos}"
                    )
                break
            # status 2: a non-packet block — handled below, then the walk
            # resumes natively.  (status 3 impossible at max_block 2^62.)
        btype = u32(raw, pos)
        if btype == 0x0A0D0D0A:  # SHB: re-detect endianness from its BOM
            bom_le = struct.unpack_from("<I", raw, pos + 8)[0]
            if bom_le == _PCAPNG_BOM:
                end = "<"
            elif struct.unpack_from(">I", raw, pos + 8)[0] == _PCAPNG_BOM:
                end = ">"
            else:
                raise ValueError("pcapng SHB with invalid byte-order magic")
            # Interface IDs are SECTION-scoped: a new section's packet blocks
            # must not resolve against a previous section's IDBs (wrong
            # tsresol/linktype otherwise — e.g. mergecap -a output).
            if interfaces:
                saw_interface = True
                if first_meta is None:
                    first_meta = (interfaces[0][0], interfaces[0][1])
            interfaces.clear()
        blen = u32(raw, pos + 4)
        if blen < 12 or blen % 4 or pos + blen > total:
            if strict:
                raise ValueError(f"truncated/invalid pcapng block at byte {pos}")
            break
        body = raw[pos + 8 : pos + blen - 4]
        try:
            _parse_pcapng_block(
                btype, body, end, interfaces,
                offsets, caplens, origlens, tss, tsf, chunks, pos=pos,
            )
        except struct.error as e:
            if strict:
                raise ValueError(
                    f"malformed pcapng block (type 0x{btype:08x}) at byte {pos}"
                ) from e
            break
        pos += blen

    if strict and offsets and not (interfaces or saw_interface):
        raise ValueError("pcapng file has packet blocks but no interface block")
    if first_meta is None and interfaces:
        first_meta = (interfaces[0][0], interfaces[0][1])
    linktype, snaplen = first_meta if first_meta else (LINKTYPE_ETHERNET, 65535)
    blob = b"".join(chunks)
    return PcapFile(
        buf=np.frombuffer(blob, dtype=np.uint8).copy()
        if blob
        else np.zeros(0, dtype=np.uint8),
        offsets=np.asarray(offsets, dtype=np.int64),
        caplens=np.asarray(caplens, dtype=np.int64),
        origlens=np.asarray(origlens, dtype=np.int64),
        ts_sec=np.asarray(tss, dtype=np.int64),
        ts_frac=np.asarray(tsf, dtype=np.int64),
        linktype=linktype,
        snaplen=snaplen,
        nanos=False,
    )


def _parse_pcapng_block(
    btype, body, end, interfaces, offsets, caplens, origlens, tss, tsf, chunks,
    *, pos,
):
    """Dispatch one pcapng block body; raises struct.error / ValueError on
    malformed content (the caller maps struct.error per strictness)."""
    buf_pos = offsets[-1] + caplens[-1] if offsets else 0

    def u32(b, o):
        return struct.unpack_from(end + "I", b, o)[0]

    def ticks_to_usec(ts_hi, ts_lo, iface):
        # A packet block citing a not-yet-seen interface keeps the
        # microsecond default (the spec says IDBs come first, but writers
        # that emit a late IDB exist and the packets are still countable —
        # the EOF interface check + test_stream_pcapng_idb_after_epb pin
        # this leniency).  KNOWN TRADEOFF: if the late IDB declares a
        # non-microsecond if_tsresol, the early blocks' timestamps are
        # scaled with the default — byte counts are unaffected.
        div = interfaces[iface][2] if iface < len(interfaces) else 1_000_000
        ticks = (ts_hi << 32) | ts_lo
        sec = ticks // div
        if sec > 0x7FFF_FFFF_FFFF_FFFF:
            # Not representable as int64 seconds (corrupt/absurd capture):
            # struct.error so the caller's malformed-block mapping applies —
            # and so the native walk (which checks the same bound) and this
            # path fail identically instead of np.asarray raising a raw
            # OverflowError at batch-flush time.
            raise struct.error(f"pcapng timestamp overflows int64 at byte {pos}")
        return sec, ((ticks % div) * 1_000_000) // div

    if btype == 0x00000001:  # IDB
        linktype = struct.unpack_from(end + "H", body, 0)[0]
        snaplen = u32(body, 4)
        tsres_div = 1_000_000  # default 1e-6 ticks -> per-usec divisor 1
        o = 8
        while o + 4 <= len(body):  # options
            code, olen = struct.unpack_from(end + "HH", body, o)
            if code == 0:
                break
            if o + 4 + olen > len(body):
                # Truncated option value: struct.error so the caller's
                # strictness mapping applies (ValueError / stop-at-prefix)
                # instead of a raw IndexError escaping both modes.
                raise struct.error(
                    f"pcapng IDB option truncated at byte {pos}"
                )
            if code == 9 and olen >= 1:  # if_tsresol
                v = body[o + 4]
                tsres_div = 2 ** (v & 0x7F) if v & 0x80 else 10 ** v
            o += 4 + (-(-olen // 4) * 4)
        interfaces.append((linktype, snaplen, tsres_div))
    elif btype == 0x00000006:  # Enhanced Packet Block
        iface, ts_hi, ts_lo, incl, orig = struct.unpack_from(end + "IIIII", body, 0)
        data = body[20 : 20 + incl]
        if len(data) < incl:
            # struct.error: the caller maps it to ValueError (strict) / stop.
            raise struct.error(f"pcapng EPB shorter than caplen at byte {pos}")
        sec, frac = ticks_to_usec(ts_hi, ts_lo, iface)
        tss.append(sec)
        tsf.append(frac)
        offsets.append(buf_pos)
        caplens.append(incl)
        origlens.append(orig)
        chunks.append(data)
    elif btype == 0x00000003:  # Simple Packet Block
        orig = u32(body, 0)
        snap = interfaces[0][1] if interfaces else 0
        incl = min(orig, snap) if snap else orig
        # A writer that stored fewer bytes than min(orig, snaplen) is
        # indistinguishable from block padding here (SPB carries no caplen
        # field); clipping to the body bounds the damage to <=3 pad bytes.
        data = body[4 : 4 + incl]
        offsets.append(buf_pos)
        caplens.append(len(data))
        origlens.append(orig)
        tss.append(0)
        tsf.append(0)
        chunks.append(data)
    elif btype == 0x00000002:  # obsolete Packet Block (same ts encoding as EPB)
        iface, _drops, ts_hi, ts_lo, incl, orig = struct.unpack_from(
            end + "HHIIII", body, 0
        )
        data = body[20 : 20 + incl]
        if len(data) < incl:
            raise struct.error(f"pcapng PB shorter than caplen at byte {pos}")
        sec, frac = ticks_to_usec(ts_hi, ts_lo, iface)
        offsets.append(buf_pos)
        caplens.append(incl)
        origlens.append(orig)
        tss.append(sec)
        tsf.append(frac)
        chunks.append(data)
    # all other block types (SHB handled by the caller, NRB, ISB, custom,
    # ...) carry no packets and are skipped


def iter_pcap(
    path,
    batch_packets: int = 1024,
    *,
    strict: bool = True,
    read_size: int = 4 << 20,
    use_native: bool = True,
) -> Iterator[PcapFile]:
    """Stream a capture as bounded-memory :class:`PcapFile` batches.

    ``read_pcap`` materializes the whole file; this walks it incrementally
    (``read_size`` bytes at a time) and yields batches of at most
    ``batch_packets`` packets — the ingest analogue of the reference's task
    program, which pulls packets from libpcap in batches of 100 instead of
    loading the capture up front (openmp_task.c:131-156).  Captures larger
    than host RAM stream through; peak residency is one batch plus one read
    buffer.  Handles classic pcap and pcapng, same as :func:`read_pcap`;
    batch concatenation is byte-identical to the one-shot read (tested).

    ``path`` is a filesystem path, ``"-"`` (stdin), or an open binary file
    object — ``tcpdump -i eth0 -w - | ... match --pcap - --stream`` is the
    privilege-separated live-capture shape (the capturing process holds the
    raw socket, this one only reads a pipe).  ``strict=False`` tolerates a
    truncated final record/block (yields the complete prefix), mirroring
    libpcap.  Compressed captures (gzip/bzip2/xz) stream through the
    decompressor without ever materializing the decompressed file — see
    :func:`open_capture`.

    ``use_native`` takes the C++ streaming record walk when available
    (bit-identical packets/metadata; tested against the Python walk).  The
    native path keeps each batch's record headers in ``buf`` (offsets point
    past them) so the whole span copies with one memcpy instead of one
    ``bytes()`` per record — :class:`PcapFile` never requires packets to be
    contiguous.
    """
    if batch_packets < 1:
        raise ValueError("batch_packets must be >= 1")
    with open_capture(path) as f:
        # Header reads are always strict: a capture whose global header is
        # unreadable has no complete prefix to tolerate.
        head = _stream_read(f, 4, True)
        if head == b"\x0a\x0d\x0d\x0a":
            yield from _iter_pcapng_stream(
                f, head, batch_packets, strict, read_size, use_native
            )
            return
        head += _stream_read(f, 20, True)
        parsed = _parse_global_header(head)
        # parsed == "pcapng" is impossible: the SHB magic returned above.
        swapped, nanos, snaplen, linktype = parsed
        rec = struct.Struct(">IIII" if swapped else "<IIII")

        pend = bytearray()
        pos = 0
        eof = False
        offsets, caplens, origlens, tss, tsf, chunks = [], [], [], [], [], []
        buf_pos = 0
        n_rec = 0

        def _cat(parts) -> np.ndarray:
            # Scalar appends (Python walk) or array extends (native walk).
            if parts and isinstance(parts[0], np.ndarray):
                return parts[0] if len(parts) == 1 else np.concatenate(parts)
            return np.asarray(parts, dtype=np.int64)

        def flush() -> PcapFile:
            nonlocal buf_pos, n_rec
            if chunks and isinstance(chunks[0], np.ndarray):
                buf = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            else:
                blob = b"".join(chunks)
                buf = (
                    np.frombuffer(blob, dtype=np.uint8).copy()
                    if blob
                    else np.zeros(0, dtype=np.uint8)
                )
            out = PcapFile(
                buf=buf,
                offsets=_cat(offsets),
                caplens=_cat(caplens),
                origlens=_cat(origlens),
                ts_sec=_cat(tss),
                ts_frac=_cat(tsf),
                linktype=linktype, snaplen=snaplen, nanos=nanos,
            )
            offsets.clear(); caplens.clear(); origlens.clear()
            tss.clear(); tsf.clear(); chunks.clear()
            buf_pos = 0
            n_rec = 0
            return out

        seekable = _source_seekable(f)

        def refill(need: int) -> bool:
            """Grow ``pend`` until ``need`` bytes are available past ``pos``.

            Files take exact read_size fills; pipes take whatever has
            arrived (read1) so a live feed flows through per arrival."""
            nonlocal pos, eof
            while len(pend) - pos < need and not eof:
                if pos:
                    del pend[:pos]
                    pos = 0
                want = max(read_size, need)
                b = (
                    _stream_read(f, want, strict)
                    if seekable
                    else _stream_read1(f, want, strict)
                )
                if not b:
                    eof = True
                else:
                    pend.extend(b)
            return len(pend) - pos >= need

        if use_native:
            from multithreading_string_matching.io import native

            use_native = native.available()

        while True:
            if not refill(16):
                avail = len(pend) - pos
                if avail and strict:
                    raise ValueError(
                        f"{avail} trailing bytes after last pcap record"
                    )
                break
            if use_native:
                count, consumed, status, need, o, c, g, s, fr = (
                    native.parse_stream(
                        pend, pos, swapped, batch_packets - n_rec,
                        _MAX_STREAM_RECORD,
                    )
                )
                if count:
                    # ONE span copy, headers included: offsets already point
                    # past each 16-byte record header inside the span.
                    chunks.append(
                        np.frombuffer(
                            pend, dtype=np.uint8, count=consumed, offset=pos
                        ).copy()
                    )
                    o += buf_pos
                    offsets.append(o); caplens.append(c); origlens.append(g)
                    tss.append(s); tsf.append(fr)
                    buf_pos += consumed
                    n_rec += count
                    pos += consumed
                if status == 1:  # batch full
                    yield flush()
                    continue
                if status == 2:  # oversized record (same error as below)
                    if strict:
                        raise ValueError(
                            f"pcap record of {need} bytes exceeds the "
                            f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                            "use read_pcap for this capture"
                        )
                    break
                # status 0: the next record straddles the buffer end.
                if need == 16:
                    continue  # partial header: top-of-loop refill/EOF logic
                if not refill(need):
                    if strict:
                        raise ValueError(
                            f"truncated pcap record: needs {need - 16} bytes, "
                            f"file has {len(pend) - pos - 16}"
                        )
                    break
                continue
            sec, frac, incl, orig = rec.unpack_from(pend, pos)
            if incl > _MAX_STREAM_RECORD:
                # Distinct from truncation: the record may be VALID but
                # exceeds the streaming buffer bound (read_pcap has no such
                # cap) — say so instead of mislabeling it 'truncated'.
                if strict:
                    raise ValueError(
                        f"pcap record of {incl} bytes exceeds the "
                        f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                        "use read_pcap for this capture"
                    )
                break
            if not refill(16 + incl):
                if strict:
                    raise ValueError(
                        f"truncated pcap record: needs {incl} bytes, "
                        f"file has {len(pend) - pos - 16}"
                    )
                break
            pos += 16
            chunks.append(bytes(pend[pos : pos + incl]))
            pos += incl
            offsets.append(buf_pos)
            buf_pos += incl
            caplens.append(incl)
            origlens.append(orig)
            tss.append(sec)
            tsf.append(frac)
            n_rec += 1
            if n_rec >= batch_packets:
                yield flush()
        if n_rec:
            yield flush()


def _iter_pcapng_stream(
    f, head: bytes, batch_packets: int, strict: bool, read_size: int,
    use_native: bool = True,
) -> Iterator[PcapFile]:
    """Block-at-a-time pcapng walk (blocks are self-delimiting); shares the
    per-block parser with :func:`_read_pcapng` so the two paths cannot
    diverge.  Interface state (endianness, linktype, tsresol) persists across
    yielded batches; the first interface's linktype labels every batch, as in
    the one-shot reader.

    With the native library available, RUNS of packet blocks (EPB/SPB/PB)
    parse through one C call per buffer fill (``msm_parse_pcapng``); any
    other block type returns control here so section/interface state stays
    in exactly one place.  Same leniencies, same error strings, same batch
    boundaries (differentially tested against the Python walk)."""
    if use_native:
        from multithreading_string_matching.io import native

        use_native = native.available()
    pend = bytearray(head)
    pos = 0
    eof = False
    file_off = 0
    end = "<"
    interfaces: list = []
    first_meta = None          # (linktype, snaplen) of the first interface ever
    saw_interface = False
    offsets, caplens, origlens, tss, tsf, chunks = [], [], [], [], [], []

    seekable = _source_seekable(f)

    def refill(need: int) -> bool:
        nonlocal pos, eof
        while len(pend) - pos < need and not eof:
            if pos:
                del pend[:pos]
                pos = 0
            want = max(read_size, need)
            b = (
                _stream_read(f, want, strict)
                if seekable
                else _stream_read1(f, want, strict)
            )
            if not b:
                eof = True
            else:
                pend.extend(b)
        return len(pend) - pos >= need

    def flush() -> PcapFile:
        blob = b"".join(chunks)
        meta = first_meta or (
            (interfaces[0][0], interfaces[0][1])
            if interfaces
            else (LINKTYPE_ETHERNET, 65535)
        )
        out = PcapFile(
            buf=np.frombuffer(blob, dtype=np.uint8).copy()
            if blob
            else np.zeros(0, dtype=np.uint8),
            offsets=np.asarray(offsets, dtype=np.int64),
            caplens=np.asarray(caplens, dtype=np.int64),
            origlens=np.asarray(origlens, dtype=np.int64),
            ts_sec=np.asarray(tss, dtype=np.int64),
            ts_frac=np.asarray(tsf, dtype=np.int64),
            linktype=meta[0],
            snaplen=meta[1],
            nanos=False,
        )
        offsets.clear(); caplens.clear(); origlens.clear()
        tss.clear(); tsf.clear(); chunks.clear()
        return out

    saw_packets = False
    while True:
        if not refill(12):
            # The one-shot reader's `while pos + 12 <= total` silently
            # ignores a sub-12-byte tail even in strict mode; match it.
            break
        if (
            use_native
            # Peek the type: a non-packet block would stop the walker
            # immediately — skip the call + output-array allocation.
            and struct.unpack_from(end + "I", pend, pos)[0]
            in _PCAPNG_PACKET_BLOCKS
            and all(it[2] <= _MAX_TSDIV for it in interfaces)
        ):
            remaining = batch_packets - len(offsets)
            count, consumed, status, aux, doffs, caps, origs, ss, ff = (
                native.parse_pcapng(
                    pend, pos, end == ">",
                    # When the flush gate below holds a late-IDB section's
                    # packets, remaining can hit 0 — keep walking unbounded
                    # like the Python loop does.
                    remaining if remaining > 0 else 1 << 60,
                    _MAX_STREAM_RECORD,
                    [it[2] for it in interfaces],
                    interfaces[0][1] if interfaces else 0,
                )
            )
            if count:
                trim = int(doffs[-1] + caps[-1])
                _extend_native_pcapng(
                    (chunks, offsets, caplens, origlens, tss, tsf),
                    # memoryview: one copy out of the mutable buffer, not a
                    # bytearray-slice copy followed by a bytes() copy.
                    bytes(memoryview(pend)[pos : pos + trim]),
                    doffs, caps, origs, ss, ff,
                )
                pos += consumed
                file_off += consumed
                saw_packets = True
            if len(offsets) >= batch_packets and (
                interfaces or first_meta is not None
            ):
                yield flush()
            if status == 1:  # batch full
                continue
            if status == 3:  # oversized block (same error as below)
                if strict:
                    raise ValueError(
                        f"pcapng block of {aux} bytes exceeds the "
                        f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                        "use read_pcap for this capture"
                    )
                break
            if status == 4:  # invalid block header
                if strict:
                    raise ValueError(
                        f"truncated/invalid pcapng block at byte {file_off}"
                    )
                break
            if status == 5:  # malformed packet block
                if strict:
                    raise ValueError(
                        f"malformed pcapng block (type 0x{aux:08x}) "
                        f"at byte {file_off}"
                    )
                break
            if status == 0:  # next block straddles the buffer end
                if aux <= 12:
                    continue  # partial header: top-of-loop refill/EOF logic
                if not refill(aux):
                    if strict:
                        raise ValueError(
                            f"truncated/invalid pcapng block at byte "
                            f"{file_off}"
                        )
                    break
                continue
            # status 2: a non-packet block — the Python parser below owns
            # section (SHB) and interface (IDB) state; it handles this one
            # block, then the walk resumes natively.
        # The SHB type is an endianness palindrome, so reading it with the
        # previous section's byte order still detects a new section.
        btype = struct.unpack_from(end + "I", pend, pos)[0]
        if btype == 0x0A0D0D0A:
            bom_le = struct.unpack_from("<I", pend, pos + 8)[0]
            if bom_le == _PCAPNG_BOM:
                end = "<"
            elif struct.unpack_from(">I", pend, pos + 8)[0] == _PCAPNG_BOM:
                end = ">"
            else:
                raise ValueError("pcapng SHB with invalid byte-order magic")
            # Section-scoped interface IDs (see _read_pcapng).
            if interfaces:
                saw_interface = True
                if first_meta is None:
                    first_meta = (interfaces[0][0], interfaces[0][1])
            interfaces.clear()
        blen = struct.unpack_from(end + "I", pend, pos + 4)[0]
        if blen > _MAX_STREAM_RECORD:
            if strict:
                raise ValueError(
                    f"pcapng block of {blen} bytes exceeds the "
                    f"{_MAX_STREAM_RECORD}-byte streaming bound; "
                    "use read_pcap for this capture"
                )
            break
        if blen < 12 or blen % 4 or not refill(blen):
            if strict:
                raise ValueError(
                    f"truncated/invalid pcapng block at byte {file_off}"
                )
            break
        body = bytes(pend[pos + 8 : pos + blen - 4])
        try:
            _parse_pcapng_block(
                btype, body, end, interfaces,
                offsets, caplens, origlens, tss, tsf, chunks, pos=file_off,
            )
        except struct.error as e:
            if strict:
                raise ValueError(
                    f"malformed pcapng block (type 0x{btype:08x}) "
                    f"at byte {file_off}"
                ) from e
            break
        pos += blen
        file_off += blen
        saw_packets = saw_packets or bool(offsets)
        # Hold the batch until the section's linktype is KNOWN (its first
        # IDB) — flushing earlier would label pre-IDB packet blocks (the
        # nonstandard late-IDB leniency case) with the Ethernet fallback
        # while read_pcap labels the whole file with the late IDB's
        # linktype.  Standard captures (IDB first) flush on schedule; a
        # nonstandard section buffers its pre-IDB packets in memory, which
        # is exactly read_pcap's residency for the same file.
        if len(offsets) >= batch_packets and (
            interfaces or first_meta is not None
        ):
            yield flush()
    if offsets:
        yield flush()
    # Interface presence is checked at EOF, exactly like the one-shot
    # reader — an IDB may legally arrive after the first packet block.
    if strict and saw_packets and not (interfaces or saw_interface):
        raise ValueError("pcapng file has packet blocks but no interface block")


def _serialize_records(pcap: PcapFile, idx: np.ndarray) -> np.ndarray:
    """Serialize the selected packets as classic-pcap record bytes.

    One output buffer, headers filled vectorized, payload bytes copied as
    contiguous per-record slices (the fast host-materialization shape —
    DESIGN.md §6).
    """
    if idx.size and (idx.min() < 0 or idx.max() >= pcap.num_packets):
        raise ValueError(
            f"packet index out of range (capture has {pcap.num_packets})"
        )
    secs = pcap.ts_sec[idx]
    fracs = pcap.ts_frac[idx]
    caps = pcap.caplens[idx]
    origs = pcap.origlens[idx]
    for name, arr in (("ts_sec", secs), ("ts_frac", fracs),
                      ("caplen", caps), ("origlen", origs)):
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError(f"{name} not representable as a pcap u32 field")
    out_sizes = 16 + caps
    rec_starts = np.concatenate(([0], np.cumsum(out_sizes)[:-1]))
    out = np.zeros(int(out_sizes.sum()), dtype=np.uint8)
    hdr = np.empty((idx.size, 4), dtype="<u4")
    hdr[:, 0] = secs
    hdr[:, 1] = fracs
    hdr[:, 2] = caps
    hdr[:, 3] = origs
    hdr_bytes = hdr.view(np.uint8).reshape(idx.size, 16)
    for k in range(idx.size):
        rs = int(rec_starts[k])
        out[rs : rs + 16] = hdr_bytes[k]
        src = int(pcap.offsets[idx[k]])
        n = int(caps[k])
        out[rs + 16 : rs + 16 + n] = pcap.buf[src : src + n]
    return out


def classic_global_header(
    linktype: int = LINKTYPE_ETHERNET, snaplen: int = 65535,
    nanos: bool = False,
) -> bytes:
    """The 24-byte classic-pcap global header (shared by every writer)."""
    magic = MAGIC_NSEC_LE if nanos else MAGIC_USEC_LE
    return struct.pack("<IHHiIII", magic, 2, 4, 0, 0, snaplen, linktype)


class PcapWriter:
    """Incremental classic-pcap writer (streaming counterpart of
    :func:`write_pcap`).

    The global header is written lazily from the first chunk's metadata
    (even an empty selection locks it — stream callers pass every chunk
    through so the header reflects the capture, not a guess); later chunks
    must agree on linktype and timestamp resolution (a classic pcap has
    exactly one of each).  The constructor's ``linktype``/``snaplen``/
    ``nanos`` are the fallback used only if the stream ends before any
    chunk arrives.  Usable as a context manager.

    A ``.gz``/``.bz2``/``.xz`` path suffix compresses the output stream
    (extension-based — output has no magic to sniff); appends stay
    incremental inside one compressed member, and the read side accepts
    the result transparently.
    """

    def __init__(
        self, path: Union[str, os.PathLike], *,
        linktype: int = LINKTYPE_ETHERNET, snaplen: int = 65535,
        nanos: bool = False,
    ):
        suffix = str(path).lower()
        if suffix.endswith(".gz"):
            import gzip

            self._f = gzip.open(path, "wb")
        elif suffix.endswith(".bz2"):
            import bz2

            self._f = bz2.open(path, "wb")
        elif suffix.endswith(".xz"):
            import lzma

            self._f = lzma.open(path, "wb")
        else:
            self._f = open(path, "wb")
        self._meta = None  # (linktype, nanos)
        self._fallback = (linktype, snaplen, nanos)
        self.packets_written = 0

    def write(self, pcap: PcapFile, indices=None) -> int:
        if indices is None:
            idx = np.arange(pcap.num_packets, dtype=np.int64)
        else:
            idx = np.asarray(indices).ravel()
            if idx.dtype == bool:
                # A row-hit mask is the natural thing to hold at call sites;
                # silently coercing True/False to packets 1/0 would be a
                # quiet disaster, so accept masks explicitly.
                if idx.size != pcap.num_packets:
                    raise ValueError(
                        f"boolean mask has {idx.size} entries for a "
                        f"{pcap.num_packets}-packet capture"
                    )
                idx = np.flatnonzero(idx)
            idx = idx.astype(np.int64)
        if self._meta is None:
            self._meta = (pcap.linktype, pcap.nanos)
            self._f.write(
                classic_global_header(pcap.linktype, pcap.snaplen, pcap.nanos)
            )
        elif self._meta != (pcap.linktype, pcap.nanos):
            raise ValueError(
                f"chunk metadata {(pcap.linktype, pcap.nanos)} does not match "
                f"the stream's (linktype, nanos)={self._meta}"
            )
        self._f.write(_serialize_records(pcap, idx).tobytes())
        self.packets_written += int(idx.size)
        return int(idx.size)

    def close(self) -> None:
        if not self._f.closed:
            if self._meta is None:
                # No chunk ever arrived: still emit a valid (empty) pcap.
                lt, sl, ns = self._fallback
                self._f.write(classic_global_header(lt, sl, ns))
            self._f.close()

    def __enter__(self) -> "PcapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_pcap(
    path: Union[str, os.PathLike],
    pcap: PcapFile,
    indices=None,
) -> int:
    """Write (a subset of) a parsed capture back out as classic pcap.

    The reference has no capture writer at all — results only ever leave as
    printf counts (serial.c:163-169).  A serving deployment wants the
    opposite: hand the matched packets to downstream tooling (wireshark,
    replay, retention).  ``indices`` selects which packets to emit (default:
    all), preserving original record bytes, timestamps, snaplen and linktype;
    timestamp resolution follows ``pcap.nanos``.  pcapng inputs re-emit as
    classic pcap (timestamps were already normalized at read time).

    Returns the number of packets written.
    """
    with PcapWriter(path) as w:
        return w.write(pcap, indices)


def concat_pcaps(pcaps) -> PcapFile:
    """Concatenate parsed captures into one, packets in input order.

    The serving shape for rotated capture files: merge, then every
    downstream surface (counts, per-packet attribution, offsets, dump)
    works unchanged with packet numbering global across the inputs.
    Linktype and timestamp resolution must agree (classic pcap has exactly
    one of each); snaplen becomes the maximum.
    """
    pcaps = list(pcaps)
    if not pcaps:
        raise ValueError("concat_pcaps needs at least one capture")
    if len(pcaps) == 1:
        return pcaps[0]
    meta = {(p.linktype, p.nanos) for p in pcaps}
    if len(meta) > 1:
        raise ValueError(
            f"captures disagree on (linktype, nanos): {sorted(meta)}"
        )
    bufs = [p.buf for p in pcaps]
    base = np.cumsum([0] + [b.shape[0] for b in bufs[:-1]])
    return PcapFile(
        buf=np.concatenate(bufs),
        offsets=np.concatenate([p.offsets + off for p, off in zip(pcaps, base)]),
        caplens=np.concatenate([p.caplens for p in pcaps]),
        origlens=np.concatenate([p.origlens for p in pcaps]),
        ts_sec=np.concatenate([p.ts_sec for p in pcaps]),
        ts_frac=np.concatenate([p.ts_frac for p in pcaps]),
        linktype=pcaps[0].linktype,
        snaplen=max(p.snaplen for p in pcaps),
        nanos=pcaps[0].nanos,
    )


def read_pcap_range(path: Union[str, os.PathLike], start: int, stop: int) -> PcapFile:
    """Read only packets [start, stop) — the per-host sharded-ingest primitive.

    The distributed path (parallel/distributed.py) has each host read its own
    packet range, instead of the reference's rank-0-reads-everything +
    MPI_Scatterv funnel (mpi_dumping.c:107-161).  Callers that already hold
    the parsed capture should use :func:`slice_pcap` directly and avoid a
    second file walk.
    """
    return slice_pcap(read_pcap(path), start, stop)


def slice_pcap(
    full: PcapFile, start: int, stop: int, *, copy: bool = True
) -> PcapFile:
    """Packets [start, stop) of an already-parsed capture.

    ``copy=True`` narrows the byte buffer to just the selected range so the
    rest can be freed (the sharded-ingest shape); ``copy=False`` keeps a view
    of the full buffer (cheap transient slices, e.g. pipeline batches)."""
    start = max(0, start)
    stop = min(full.num_packets, stop)
    if start >= stop:
        empty = np.zeros(0, dtype=np.int64)
        return PcapFile(
            buf=np.zeros(0, dtype=np.uint8),
            offsets=empty, caplens=empty, origlens=empty,
            ts_sec=empty, ts_frac=empty,
            linktype=full.linktype, snaplen=full.snaplen, nanos=full.nanos,
        )
    if not copy:
        return PcapFile(
            buf=full.buf,
            offsets=full.offsets[start:stop],
            caplens=full.caplens[start:stop],
            origlens=full.origlens[start:stop],
            ts_sec=full.ts_sec[start:stop],
            ts_frac=full.ts_frac[start:stop],
            linktype=full.linktype, snaplen=full.snaplen, nanos=full.nanos,
        )
    lo = int(full.offsets[start])
    hi = int(full.offsets[stop - 1] + full.caplens[stop - 1])
    return PcapFile(
        buf=full.buf[lo:hi].copy(),
        offsets=full.offsets[start:stop] - lo,
        caplens=full.caplens[start:stop],
        origlens=full.origlens[start:stop],
        ts_sec=full.ts_sec[start:stop],
        ts_frac=full.ts_frac[start:stop],
        linktype=full.linktype,
        snaplen=full.snaplen,
        nanos=full.nanos,
    )
