"""Streaming (bounded-memory) pcap ingest: io.pcap.iter_pcap.

The reference's task program never loads the capture up front — it pulls
packets from libpcap in batches of 100 (openmp_task.c:131-156).  iter_pcap is
that ingest shape: batch concatenation must be byte-identical to the one-shot
read_pcap on every fixture, for classic pcap and pcapng, at any batch size
and read-buffer size (including buffers smaller than one record, which forces
the refill path).
"""

import struct

import numpy as np
import pytest

from multithreading_string_matching import Matcher, iter_pcap, load_patterns, read_pcap
from multithreading_string_matching.parallel.pipeline import count_pcap_pipelined

from test_pcapng import _pcapng_from


def _assert_stream_equals_full(path, full, batch_packets, **kw):
    batches = list(iter_pcap(path, batch_packets, **kw))
    assert sum(b.num_packets for b in batches) == full.num_packets
    for b in batches[:-1]:
        assert b.num_packets == batch_packets
    if batches:
        assert 0 < batches[-1].num_packets <= batch_packets
    i = 0
    for b in batches:
        assert b.linktype == full.linktype
        for j in range(b.num_packets):
            assert bytes(b.packet(j)) == bytes(full.packet(i))
            assert int(b.caplens[j]) == int(full.caplens[i])
            assert int(b.origlens[j]) == int(full.origlens[i])
            assert int(b.ts_sec[j]) == int(full.ts_sec[i])
            assert int(b.ts_frac[j]) == int(full.ts_frac[i])
            i += 1


@pytest.mark.parametrize("name", ["udp.pcap", "tcp.pcap", "udp_1000.pcap"])
@pytest.mark.parametrize("batch_packets", [1, 7, 100, 10_000])
def test_stream_equals_one_shot_classic(reference_dir, name, batch_packets):
    path = reference_dir / name
    _assert_stream_equals_full(path, read_pcap(path), batch_packets)


def test_stream_tiny_read_buffer_forces_refills(reference_dir):
    """A 64-byte read buffer is smaller than every record: each record header
    and body straddles refills."""
    path = reference_dir / "udp.pcap"
    _assert_stream_equals_full(path, read_pcap(path), 3, read_size=64)


@pytest.mark.parametrize("end", ["<", ">"])
def test_stream_pcapng_equals_one_shot(reference_dir, tmp_path, end):
    classic = read_pcap(reference_dir / "udp.pcap")
    ng = tmp_path / "u.pcapng"
    ng.write_bytes(_pcapng_from(classic, end=end, junk_block=True))
    _assert_stream_equals_full(ng, read_pcap(ng), 4)
    _assert_stream_equals_full(ng, read_pcap(ng), 4, read_size=64)


def test_stream_truncated_classic(reference_dir, tmp_path):
    raw = (reference_dir / "udp.pcap").read_bytes()
    cut = tmp_path / "cut.pcap"
    cut.write_bytes(raw[: len(raw) - 5])  # clip the last record's tail
    with pytest.raises(ValueError):
        list(iter_pcap(cut, 4))
    tolerant = list(iter_pcap(cut, 4, strict=False))
    full = read_pcap(reference_dir / "udp.pcap")
    assert sum(b.num_packets for b in tolerant) == full.num_packets - 1


def test_stream_trailing_garbage_classic(reference_dir, tmp_path):
    raw = (reference_dir / "udp.pcap").read_bytes()
    bad = tmp_path / "trail.pcap"
    bad.write_bytes(raw + b"\x01\x02\x03")  # < 16 bytes: not a record header
    with pytest.raises(ValueError, match="trailing"):
        list(iter_pcap(bad, 1000))
    tolerant = list(iter_pcap(bad, 1000, strict=False))
    assert sum(b.num_packets for b in tolerant) == read_pcap(
        reference_dir / "udp.pcap"
    ).num_packets


def test_stream_truncated_pcapng(reference_dir, tmp_path):
    classic = read_pcap(reference_dir / "udp.pcap")
    blob = _pcapng_from(classic)
    cut = tmp_path / "cut.pcapng"
    cut.write_bytes(blob[: len(blob) - 6])
    with pytest.raises(ValueError):
        list(iter_pcap(cut, 4))
    tolerant = list(iter_pcap(cut, 4, strict=False))
    assert sum(b.num_packets for b in tolerant) == classic.num_packets - 1


def test_stream_empty_capture(tmp_path):
    empty = tmp_path / "empty.pcap"
    empty.write_bytes(
        struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    )
    assert list(iter_pcap(empty, 8)) == []


def test_stream_batch_packets_validation(reference_dir):
    with pytest.raises(ValueError):
        list(iter_pcap(reference_dir / "udp.pcap", 0))


def test_pipelined_counts_unchanged_by_streaming(reference_dir):
    """The task pipeline now ingests via iter_pcap; totals must still match
    the one-shot scan (BASELINE.md fixture totals pin this elsewhere too)."""
    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    counts = count_pcap_pipelined(matcher, reference_dir / "udp_1000.pcap", "udp")
    one_shot = matcher.count_pcap(reference_dir / "udp_1000.pcap", "udp")
    assert (np.asarray(counts) == np.asarray(one_shot)).all()
    assert int(np.asarray(counts).sum()) == 1006


# -- count_pcap_streamed: fixed-shape packed-tile streaming scan ------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(batch_packets=64, tile_rows=32, pack_width=256),
        dict(batch_packets=1000, tile_rows=8, pack_width=2048),
        dict(batch_packets=17, tile_rows=16, pack_width=128),  # forces oversize routing
    ],
)
def test_streamed_counts_equal_one_shot(reference_dir, kw):
    from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    got = count_pcap_streamed(matcher, reference_dir / "udp_1000.pcap", "udp", **kw)
    want = matcher.count_pcap(reference_dir / "udp_1000.pcap", "udp")
    assert (np.asarray(got) == np.asarray(want)).all()
    assert int(np.asarray(got).sum()) == 1006


def test_streamed_nul_pattern_fallback(reference_dir):
    from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

    matcher = Matcher([b"http", b"\x00\x00"], engine="window")
    got = count_pcap_streamed(matcher, reference_dir / "udp.pcap", "udp")
    want = matcher.count_pcap(reference_dir / "udp.pcap", "udp")
    assert (np.asarray(got) == np.asarray(want)).all()


def test_streamed_empty_and_tcp(reference_dir):
    from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    got = count_pcap_streamed(matcher, reference_dir / "tcp.pcap", "tcp",
                              batch_packets=5, tile_rows=8, pack_width=512)
    assert int(np.asarray(got).sum()) == 4
    # udp mode on tcp.pcap yields zero valid payloads -> all-zero counts.
    zero = count_pcap_streamed(matcher, reference_dir / "tcp.pcap", "udp")
    assert int(np.asarray(zero).sum()) == 0
    assert zero.shape == (len(matcher.patterns),)


def test_streamed_pallas_interpret_path(synth_udp):
    """count_pcap_streamed with the default 'pallas' engine (resolved to
    the window engine) equals the one-shot count."""
    from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

    path, pats = synth_udp
    matcher = Matcher(pats, engine="pallas")
    got = count_pcap_streamed(
        matcher, path, "udp", batch_packets=64, tile_rows=64, pack_width=512,
    )
    want = Matcher(pats, engine="window").count_pcap(path, "udp")
    assert np.asarray(got).tolist() == want.tolist()
    assert int(want.sum()) > 0


def test_cli_stream_flag(reference_dir):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match",
         "--pcap", str(reference_dir / "udp_1000.pcap"),
         "--patterns", str(reference_dir / "strings.txt"),
         "--stream", "--engine", "window", "--json"],
        capture_output=True, text=True, check=True,
        env={"MSM_PLATFORM": "cpu", "PATH": "/usr/bin:/bin", "HOME": "/root"},
    )
    assert sum(json.loads(out.stdout)["counts"]) == 1006


# -- review-finding regressions ---------------------------------------------


def test_stream_pcapng_idb_after_epb_matches_one_shot(tmp_path):
    """An IDB arriving after the first packet block is legal for read_pcap
    (its interface check runs at EOF); the streamed walk must accept it
    too."""
    out = bytearray()

    def block(btype, body):
        blen = 12 + len(body) + ((-len(body)) % 4)
        out.extend(struct.pack("<II", btype, blen))
        out.extend(body + b"\x00" * ((-len(body)) % 4))
        out.extend(struct.pack("<I", blen))

    block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    data = b"\xab" * 60
    block(0x00000006, struct.pack("<IIIII", 0, 0, 0, len(data), len(data)) + data)
    block(0x00000001, struct.pack("<HHI", 1, 0, 65535))
    p = tmp_path / "late_idb.pcapng"
    p.write_bytes(bytes(out))
    full = read_pcap(p)
    assert full.num_packets == 1
    _assert_stream_equals_full(p, full, 4)


def test_stream_pcapng_late_idb_linktype_matches_one_shot(tmp_path):
    """Batches flushed from a section whose IDB arrives LATE must carry the
    IDB's linktype, not the Ethernet fallback: the stream holds pre-IDB
    packet blocks until the section's linktype is known, so streamed and
    one-shot decode identically (SLL 113 here would shift every header
    offset under the fallback)."""
    out = bytearray()

    def block(btype, body):
        blen = 12 + len(body) + ((-len(body)) % 4)
        out.extend(struct.pack("<II", btype, blen))
        out.extend(body + b"\x00" * ((-len(body)) % 4))
        out.extend(struct.pack("<I", blen))

    block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    data1 = b"\xab" * 60
    data2 = b"\xcd" * 48
    block(0x00000006, struct.pack("<IIIII", 0, 0, 0, len(data1), len(data1)) + data1)
    block(0x00000006, struct.pack("<IIIII", 0, 0, 0, len(data2), len(data2)) + data2)
    block(0x00000001, struct.pack("<HHI", 113, 0, 65535))  # SLL, late
    p = tmp_path / "late_idb_sll.pcapng"
    p.write_bytes(bytes(out))
    full = read_pcap(p)
    assert full.linktype == 113
    batches = list(iter_pcap(p, batch_packets=1))
    assert sum(b.num_packets for b in batches) == full.num_packets
    assert all(b.linktype == 113 for b in batches)


def test_stream_pcapng_random_layouts_match_one_shot(tmp_path):
    """Generative differential: random pcapng section/IDB/EPB/SPB layouts
    (multiple sections, late IDBs, extra interfaces, junk blocks, both
    endiannesses) must parse IDENTICALLY through read_pcap and iter_pcap at
    random batch sizes — packets, bytes, timestamps, and linktype labels."""
    from multithreading_string_matching.io.pcap import iter_pcap, read_pcap

    rng = np.random.default_rng(11)

    def block(end, btype, body):
        pad = (-len(body)) % 4
        blen = 12 + len(body) + pad
        return (struct.pack(end + "II", btype, blen) + body
                + b"\x00" * pad + struct.pack(end + "I", blen))

    for trial in range(30):
        end = "<" if rng.integers(2) else ">"
        out = bytearray()
        n_sections = int(rng.integers(1, 3))
        for _ in range(n_sections):
            out += block(end, 0x0A0D0D0A,
                         struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
            n_idbs = int(rng.integers(0, 3))
            idb_written = 0
            wrote_pkt = False
            n_blocks = int(rng.integers(0, 6))
            for _ in range(n_blocks):
                kind = rng.integers(0, 4)
                if kind == 0 and idb_written < n_idbs:
                    lt = int(rng.choice([1, 101, 113]))
                    out += block(end, 0x00000001,
                                 struct.pack(end + "HHI", lt, 0, 65535))
                    idb_written += 1
                elif kind == 1:
                    data = rng.integers(0, 256, int(rng.integers(1, 80))
                                        ).astype(np.uint8).tobytes()
                    out += block(end, 0x00000006, struct.pack(
                        end + "IIIII", 0, int(rng.integers(0, 100)),
                        int(rng.integers(0, 10**6)), len(data), len(data),
                    ) + data)
                    wrote_pkt = True
                elif kind == 2:
                    data = rng.integers(0, 256, int(rng.integers(1, 40))
                                        ).astype(np.uint8).tobytes()
                    out += block(end, 0x00000003,
                                 struct.pack(end + "I", len(data)) + data)
                    wrote_pkt = True
                else:  # unknown block type: both readers must skip it
                    out += block(end, 0x0BADBEEF, b"\x07" * 8)
            if wrote_pkt and not idb_written:
                # strict read_pcap requires an interface block somewhere;
                # appending it LATE exercises the leniency path both
                # readers must label identically.
                out += block(end, 0x00000001,
                             struct.pack(end + "HHI", 113, 0, 65535))
        p = tmp_path / f"fuzz_{trial}.pcapng"
        p.write_bytes(bytes(out))
        full = read_pcap(p)
        for bp in (1, 3, 1000):
            batches = list(iter_pcap(p, batch_packets=bp))
            n = sum(b.num_packets for b in batches)
            assert n == full.num_packets, f"trial {trial} bp={bp}"
            assert all(b.linktype == full.linktype for b in batches), (
                f"trial {trial} bp={bp}: linktype labels diverge"
            )
            i = 0
            for b in batches:
                for k in range(b.num_packets):
                    assert (
                        b.packet(k).tobytes() == full.packet(i).tobytes()
                    ), f"trial {trial} packet {i}"
                    assert b.ts_sec[k] == full.ts_sec[i]
                    i += 1


def test_stream_pcapng_tiny_tail_ignored_like_one_shot(tmp_path, reference_dir):
    classic = read_pcap(reference_dir / "udp.pcap")
    blob = _pcapng_from(classic) + b"\x01\x02\x03"  # < 12 bytes of tail
    p = tmp_path / "tail.pcapng"
    p.write_bytes(blob)
    full = read_pcap(p)  # one-shot silently ignores the tail
    _assert_stream_equals_full(p, full, 7)


def test_stream_native_walk_matches_python_walk(tmp_path):
    """Generative differential: the C++ streaming record walk
    (use_native=True, the default) must agree with the pure-Python walk on
    random classic captures — both endiannesses, zero-length records, random
    record sizes, random batch/read sizes, and truncated tails (strict raise
    AND tolerant prefix)."""
    from multithreading_string_matching.io import native

    if not native.available():
        pytest.skip("native ingest unavailable")
    rng = np.random.default_rng(23)

    def run(path, bp, rs, strict):
        out = []
        for un in (True, False):
            try:
                out.append(("ok", list(iter_pcap(
                    path, bp, read_size=rs, strict=strict, use_native=un))))
            except ValueError as e:
                out.append(("err", str(e)))
        return out

    for trial in range(25):
        end = ">" if rng.integers(2) else "<"
        magic = 0xA1B23C4D if rng.integers(2) else 0xA1B2C3D4
        out = bytearray(struct.pack(end + "IHHiIII", magic, 2, 4, 0, 0, 65535, 1))
        for _ in range(int(rng.integers(0, 40))):
            n = int(rng.choice([0, 1, 17, 60, 300, 1600]))
            out += struct.pack(
                end + "IIII", int(rng.integers(0, 2**31)),
                int(rng.integers(0, 10**6)), n, n + int(rng.integers(0, 5)),
            )
            out += rng.integers(0, 256, n).astype(np.uint8).tobytes()
        if rng.integers(2):  # clip the tail: truncated record or header
            out = out[: max(24, len(out) - int(rng.integers(1, 30)))]
        p = tmp_path / f"nat_{trial}.pcap"
        p.write_bytes(bytes(out))
        for bp in (1, 7, 1000):
            for rs in (64, 4 << 20):
                for strict in (True, False):
                    (nk, nv), (pk, pv) = run(p, bp, rs, strict)
                    tag = f"trial {trial} bp={bp} rs={rs} strict={strict}"
                    assert nk == pk, f"{tag}: outcome diverged {nk} vs {pk}"
                    if nk == "err":
                        assert nv == pv, f"{tag}: errors differ"
                        continue
                    assert len(nv) == len(pv), tag
                    for bn, bp_ in zip(nv, pv):
                        assert bn.num_packets == bp_.num_packets, tag
                        for j in range(bn.num_packets):
                            assert bytes(bn.packet(j)) == bytes(bp_.packet(j))
                        for f in ("caplens", "origlens", "ts_sec", "ts_frac"):
                            assert (getattr(bn, f) == getattr(bp_, f)).all(), (
                                f"{tag}: {f}"
                            )


def test_stream_pcapng_native_walk_matches_python_walk(tmp_path):
    """Generative differential for the native pcapng packet-block walk:
    random EPB/SPB/PB mixes (multiple sections, late IDBs, if_tsresol
    options, junk blocks, both endiannesses, clipped tails) must stream
    IDENTICALLY through use_native=True and =False — packets, metadata,
    timestamps, linktype labels, and error strings."""
    from multithreading_string_matching.io import native

    if not native.available():
        pytest.skip("native ingest unavailable")
    rng = np.random.default_rng(31)

    def block(end, btype, body):
        pad = (-len(body)) % 4
        blen = 12 + len(body) + pad
        return (struct.pack(end + "II", btype, blen) + body
                + b"\x00" * pad + struct.pack(end + "I", blen))

    def run(path, bp, rs, strict):
        out = []
        for un in (True, False):
            try:
                out.append(("ok", list(iter_pcap(
                    path, bp, read_size=rs, strict=strict, use_native=un))))
            except ValueError as e:
                out.append(("err", str(e)))
        return out

    for trial in range(25):
        end = ">" if rng.integers(2) else "<"
        out = bytearray()
        for _ in range(int(rng.integers(1, 3))):  # sections
            out += block(end, 0x0A0D0D0A,
                         struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
            for _ in range(int(rng.integers(0, 14))):
                kind = int(rng.integers(0, 6))
                if kind == 0:  # IDB, sometimes with if_tsresol
                    body = struct.pack(
                        end + "HHI", int(rng.choice([1, 101, 113])), 0,
                        int(rng.choice([0, 64, 65535])),
                    )
                    if rng.integers(2):
                        # 0 = 1-tick seconds (tiny divisor: huge ts_hi can
                        # overflow int64 seconds — must fail identically);
                        # 14/16 = divisors past ~1.8e13 (the uint64 frac-
                        # multiply overflow regime — needs the 128-bit
                        # multiply to match Python's big ints).
                        body += struct.pack(end + "HH", 9, 1) + bytes(
                            [int(rng.choice([0, 3, 6, 9, 14, 16]))]
                        ) + b"\x00\x00\x00"
                        body += struct.pack(end + "HH", 0, 0)
                    out += block(end, 0x00000001, body)
                elif kind == 1:  # EPB
                    data = rng.integers(0, 256, int(rng.integers(0, 90))
                                        ).astype(np.uint8).tobytes()
                    out += block(end, 0x00000006, struct.pack(
                        end + "IIIII", int(rng.integers(0, 3)),
                        # Occasionally a huge ts_hi: with a small divisor
                        # the seconds overflow int64 (must be 'malformed'
                        # in BOTH paths), with a big one it exercises the
                        # full 64-bit tick range.
                        int(rng.choice([0, 1000, 2**31, 2**32 - 1])),
                        int(rng.integers(0, 2**32)), len(data),
                        len(data) + int(rng.integers(0, 9)),
                    ) + data)
                elif kind == 2:  # SPB (snaplen-clipped)
                    data = rng.integers(0, 256, int(rng.integers(0, 70))
                                        ).astype(np.uint8).tobytes()
                    out += block(end, 0x00000003,
                                 struct.pack(end + "I", len(data)) + data)
                elif kind == 3:  # obsolete PB
                    data = rng.integers(0, 256, int(rng.integers(0, 50))
                                        ).astype(np.uint8).tobytes()
                    out += block(end, 0x00000002, struct.pack(
                        end + "HHIIII", 0, 0, 0,
                        int(rng.integers(0, 10**6)), len(data), len(data),
                    ) + data)
                elif kind == 4:  # junk block (skipped by both)
                    out += block(end, 0x0BADBEEF, b"\x07" * 12)
                else:  # malformed EPB: caplen beyond body
                    out += block(end, 0x00000006, struct.pack(
                        end + "IIIII", 0, 0, 0, 4000, 4000) + b"x" * 8)
        if rng.integers(2):  # clipped tail
            out = out[: max(4, len(out) - int(rng.integers(1, 40)))]
        p = tmp_path / f"natng_{trial}.pcapng"
        p.write_bytes(bytes(out))
        # One-shot reader: native vs Python on the same image.
        from multithreading_string_matching.io.pcap import _read_pcapng

        for strict in (True, False):
            one = []
            for un in (True, False):
                try:
                    one.append(("ok", _read_pcapng(
                        bytes(out), strict=strict, use_native=un)))
                except ValueError as e:
                    one.append(("err", str(e)))
            (nk, nv), (pk, pv) = one
            tag = f"trial {trial} one-shot strict={strict}"
            assert nk == pk, f"{tag}: outcome diverged"
            if nk == "err":
                assert nv == pv, f"{tag}: errors differ"
            else:
                assert nv.num_packets == pv.num_packets, tag
                assert nv.linktype == pv.linktype, tag
                for j in range(nv.num_packets):
                    assert bytes(nv.packet(j)) == bytes(pv.packet(j)), tag
                for f in ("caplens", "origlens", "ts_sec", "ts_frac"):
                    assert (getattr(nv, f) == getattr(pv, f)).all(), (
                        f"{tag}: {f}"
                    )
        for bp in (1, 5, 1000):
            for rs in (64, 4 << 20):
                for strict in (True, False):
                    (nk, nv), (pk, pv) = run(p, bp, rs, strict)
                    tag = f"trial {trial} bp={bp} rs={rs} strict={strict}"
                    assert nk == pk, f"{tag}: outcome diverged {nk} vs {pk}"
                    if nk == "err":
                        assert nv == pv, f"{tag}: errors differ"
                        continue
                    assert len(nv) == len(pv), tag
                    for bn, bp_ in zip(nv, pv):
                        assert bn.num_packets == bp_.num_packets, tag
                        assert bn.linktype == bp_.linktype, tag
                        for j in range(bn.num_packets):
                            assert bytes(bn.packet(j)) == bytes(bp_.packet(j))
                        for f in ("caplens", "origlens", "ts_sec", "ts_frac"):
                            assert (getattr(bn, f) == getattr(bp_, f)).all(), (
                                f"{tag}: {f}"
                            )


def test_pcapng_timestamp_extremes_native_equals_python(tmp_path):
    """Deterministic pins for the two native-timestamp regressions: (a) an
    if_tsresol divisor past ~1.8e13 overflowed the uint64 frac multiply
    (needs the 128-bit multiply); (b) seconds past int64 with a tiny
    divisor must be 'malformed pcapng block' in BOTH paths, not a silent
    negative ts_sec natively and a raw OverflowError in Python."""
    from multithreading_string_matching.io.pcap import _read_pcapng

    def ng(tsresol, ts_hi, ts_lo):
        out = bytearray()

        def block(btype, body):
            pad = (-len(body)) % 4
            blen = 12 + len(body) + pad
            out.extend(struct.pack("<II", btype, blen) + body
                       + b"\x00" * pad + struct.pack("<I", blen))

        block(0x0A0D0D0A, struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
        idb = struct.pack("<HHI", 1, 0, 65535)
        idb += struct.pack("<HH", 9, 1) + bytes([tsresol]) + b"\x00\x00\x00"
        idb += struct.pack("<HH", 0, 0)
        block(0x00000001, idb)
        block(0x00000006,
              struct.pack("<IIIII", 0, ts_hi, ts_lo, 4, 4) + b"data")
        return bytes(out)

    # (a) tsresol=14 (divisor 1e14): exact big-int frac, both paths equal.
    ticks = 123_456_789_012_345_678
    raw = ng(14, ticks >> 32, ticks & 0xFFFFFFFF)
    nat = _read_pcapng(raw, use_native=True)
    py = _read_pcapng(raw, use_native=False)
    div = 10**14
    assert int(nat.ts_sec[0]) == int(py.ts_sec[0]) == ticks // div
    assert (int(nat.ts_frac[0]) == int(py.ts_frac[0])
            == ((ticks % div) * 1_000_000) // div)

    # (b) tsresol=0 (1-tick seconds) with ticks >= 2^63: identical
    # malformed-block error from both paths, strict and tolerant.
    raw = ng(0, 2**32 - 1, 2**32 - 5)
    errs = []
    for un in (True, False):
        with pytest.raises(ValueError, match="malformed pcapng block") as ei:
            _read_pcapng(raw, use_native=un)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    for un in (True, False):  # tolerant: keep the (empty) prefix
        assert _read_pcapng(raw, strict=False, use_native=un).num_packets == 0


def test_stream_corrupt_record_length_bounded(tmp_path):
    """A flipped caplen field must error promptly, not buffer gigabytes."""
    hdr = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    rec = struct.pack("<IIII", 0, 0, (1 << 28) + 16, 60) + b"\x00" * 60
    p = tmp_path / "corrupt.pcap"
    p.write_bytes(hdr + rec)
    # The error names the streaming bound honestly (a >256 MiB record may
    # be VALID — read_pcap handles it), instead of mislabeling 'truncated'.
    with pytest.raises(ValueError, match="streaming bound"):
        list(iter_pcap(p, 4))
    assert list(iter_pcap(p, 4, strict=False)) == []


def test_streamed_honors_engine_selection(reference_dir):
    from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

    matcher = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    stats = {}
    got = count_pcap_streamed(
        matcher, reference_dir / "udp.pcap", "udp", engine="ac", stats=stats
    )
    want = matcher.count_pcap(reference_dir / "udp.pcap", "udp", engine="ac")
    assert (np.asarray(got) == np.asarray(want)).all()
    assert int(np.asarray(got).sum()) == 39
    assert stats["packets"] == 20 and stats["payload_bytes"] == 3347


def test_stream_multi_section_pcapng_mixed_endianness(tmp_path, reference_dir):
    """Two sections (SHBs) with opposite byte orders in one file: both the
    one-shot and streamed readers must parse all packets of both."""
    a = read_pcap(reference_dir / "udp.pcap")
    blob = _pcapng_from(a, end="<") + _pcapng_from(a, end=">")
    p = tmp_path / "two_sections.pcapng"
    p.write_bytes(blob)
    full = read_pcap(p)
    assert full.num_packets == 2 * a.num_packets
    _assert_stream_equals_full(p, full, 7)
    _assert_stream_equals_full(p, full, 7, read_size=64)


def test_streamed_nul_pattern_fallback_fills_stats(reference_dir):
    """NUL-containing pattern sets can't pack; the fallback must still fill
    the caller's stats dict (it used to drop it silently)."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    m = Matcher([b"ab\x00c", b"http"], engine="window")
    stats = {}
    counts = count_pcap_streamed(
        m, reference_dir / "udp.pcap", "udp", stats=stats
    )
    assert counts.shape == (2,)
    assert int(counts[1]) == 5  # golden http count
    assert stats["packets"] == 20
    assert stats["valid_payloads"] == 20
    assert stats["payload_bytes"] == 3347


def test_streamed_sharded_equals_oneshot(reference_dir):
    """--stream --sharded: packed tiles shard over the 8-device mesh with a
    psum merge per tile; counts are bit-identical to the one-shot scan."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.patterns import load_patterns
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    stats = {}
    counts = count_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp",
        sharded=True, batch_packets=130, tile_rows=40, pack_width=2048,
        stats=stats,
    )
    want = m.count_batch(
        extract_payloads(read_pcap(reference_dir / "udp_1000.pcap"), "udp")
    )
    assert counts.tolist() == want.tolist()
    assert int(counts.sum()) == 1006
    assert stats["packets"] == 1000

    # Oversized routing composes with sharding: the host-side detour
    # returns EXPANDED [P] counts while the sharded tiles accumulate
    # UNIQUE [U] — the dup expansion must apply to the tile side only.
    counts_over = count_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp",
        sharded=True, batch_packets=64, tile_rows=16, pack_width=128,
    )
    assert counts_over.tolist() == want.tolist()

    # AC engine shards too (unique->dup expansion via its own map).
    counts_ac = count_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp",
        sharded=True, engine="ac", tile_rows=24,
    )
    assert counts_ac.tolist() == want.tolist()


def test_scan_streamed_int64_totals(reference_dir):
    """Attribution-streaming totals past 2^31 must come back as exact int64,
    not wrap through an int32 cast (round-1 verdict weak #1 / advisor low:
    count_pcap_streamed handled this, scan_pcap_streamed did not)."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.pipeline import (
        scan_pcap_streamed,
    )

    m = Matcher([b"http", b"udp"], engine="window")
    # Per-row counts too slow to reach 2^31 by real scanning: stub the
    # per-chunk counter; the accumulation/cast logic under test is unchanged.
    big = np.int64(2) ** 28

    def fake_count_batch(batch, per_packet=False, **kw):
        assert per_packet
        return np.full((batch.payloads.shape[0], 2), big, dtype=np.int64)

    m.count_batch = fake_count_batch  # instance attr shadows the method
    counts = scan_pcap_streamed(
        m, reference_dir / "udp.pcap", "udp", batch_packets=10
    )
    want = big * 20  # 20 packets x 2^28 each = 5.37e9 > int32 max
    assert counts.dtype == np.int64
    assert (counts == want).all()


def test_pipelined_int64_totals(reference_dir, monkeypatch):
    """count_pcap_pipelined drains its device int32 accumulator to host
    int64 before it can wrap, and returns exact int64 totals past 2^31
    (round-1 verdict weak #1: the accumulator previously never drained)."""
    import jax.numpy as jnp

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel import pipeline as pp

    m = Matcher([b"http", b"udp"], engine="window")
    big = 2**30

    def fake_window(wp, payloads, lengths, **kw):
        return jnp.full((2,), big, jnp.int32)

    monkeypatch.setattr(pp, "count_matches_window", fake_window)
    monkeypatch.setattr(pp, "DRAIN_POSITIONS", 1)  # drain every batch
    counts = pp.count_pcap_pipelined(
        m, reference_dir / "udp.pcap", "udp", batch_size=5
    )
    want = big * 4  # 4 batches x 2^30 = 4.29e9: wraps in int32, exact here
    assert counts.dtype == np.int64
    assert (counts == want).all()


def test_streamed_sharded_no_retrace_per_tile(reference_dir):
    """One fixed executable per engine for the whole sharded stream: the
    module-level jits (_sharded_count / _sharded_count_window) must hit
    their trace cache on every tile after the first — a retrace per packed
    tile would mean a recompile per tile in production."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.patterns import load_patterns
    from multithreading_string_matching.parallel import mesh as mesh_mod
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    before_w = mesh_mod._sharded_count_window._cache_size()
    before_a = mesh_mod._sharded_count._cache_size()
    # tile_rows=40 over 1000 packets -> many tiles, each one shard_fn call.
    count_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp",
        sharded=True, batch_packets=130, tile_rows=40,
    )
    count_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp",
        sharded=True, engine="ac", batch_packets=130, tile_rows=40,
    )
    assert mesh_mod._sharded_count_window._cache_size() <= before_w + 1
    assert mesh_mod._sharded_count._cache_size() <= before_a + 1


def test_cli_stream_sharded(reference_dir, capsys):
    import json

    from multithreading_string_matching.cli import main

    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--sharded",
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39

    # --stream --sharded --offsets: sharded attribution (per-row kernel over
    # the mesh) must report the same offsets as the unsharded streamed scan.
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--sharded", "--offsets",
    ])
    assert code == 0
    blob_s = json.loads(capsys.readouterr().out)
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--offsets",
    ])
    assert code == 0
    blob_u = json.loads(capsys.readouterr().out)
    assert blob_s["counts"] == blob_u["counts"]
    assert sorted(map(tuple, blob_s["offsets"])) == sorted(
        map(tuple, blob_u["offsets"])
    )
    assert len(blob_s["offsets"]) == 39


def test_streamed_sharded_guards(reference_dir):
    import pytest

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    plain = Matcher([b"http"], engine="window")
    from multithreading_string_matching.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="mesh"):
        count_pcap_streamed(
            plain, reference_dir / "udp.pcap", "udp", mesh=make_mesh()
        )


def test_streamed_sync_dispatch_identical(reference_dir):
    """sync_dispatch=True (the bench's overlap-measurement mode) changes
    only the blocking schedule, never the counts."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.patterns import load_patterns
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    a = count_pcap_streamed(m, reference_dir / "udp_1000.pcap", "udp",
                            batch_packets=64, tile_rows=32)
    b = count_pcap_streamed(m, reference_dir / "udp_1000.pcap", "udp",
                            batch_packets=64, tile_rows=32,
                            sync_dispatch=True)
    assert a.tolist() == b.tolist()
    assert int(a.sum()) == 1006


def test_new_paths_empty_and_runt_captures(tmp_path):
    """Round-2 surfaces on degenerate inputs: header-only and all-runt
    captures return zeros everywhere (no crash, no shape error)."""
    import jax

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.pcap import classic_global_header
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_streamed_distributed,
    )
    from multithreading_string_matching.parallel.mesh import make_mesh
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
        scan_pcap_streamed,
    )
    from multithreading_string_matching.parallel.stream import StreamMatcher

    empty = tmp_path / "empty.pcap"
    empty.write_bytes(classic_global_header())
    runts = tmp_path / "runts.pcap"
    raw = classic_global_header()
    for _ in range(5):
        raw += struct.pack("<IIII", 0, 0, 10, 10) + b"\x00" * 10
    runts.write_bytes(raw)

    m = Matcher([b"http", b"xml"], engine="window")
    mesh = make_mesh(jax.devices("cpu")[:8])
    for p in (empty, runts):
        assert scan_pcap_streamed(m, p, "udp", sharded=True, mesh=mesh).tolist() == [0, 0]
        c, o = scan_pcap_streamed(m, p, "udp", sharded=True, mesh=mesh, offsets=True)
        assert c.tolist() == [0, 0] and len(o) == 0
        assert count_pcap_streamed(m, p, "udp", sharded=True, mesh=mesh).tolist() == [0, 0]
        assert count_pcap_streamed_distributed(m, p, "udp").counts.tolist() == [0, 0]
    s = StreamMatcher(m, sharded=True, mesh=mesh)
    assert s.counts().tolist() == [0, 0]


def test_pipelined_pallas_engine(synth_udp):
    """count_pcap_pipelined runs the window engine whatever the matcher
    asks for — identical counts."""
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_pipelined,
    )

    path, pats = synth_udp
    want = count_pcap_pipelined(Matcher(pats, engine="window"), path, "udp")
    got = count_pcap_pipelined(Matcher(pats, engine="ac"), path, "udp")
    assert got.tolist() == want.tolist()
    assert int(got.sum()) > 0


def test_cli_stream_distributed_single_process(reference_dir, capsys):
    """match --stream --distributed: single-process degenerate run equals
    the plain streamed scan; guards reject non-counts flags and
    --distributed without --stream."""
    import json

    import pytest

    from multithreading_string_matching.cli import main

    code = main([
        "match", "--pcap", str(reference_dir / "udp_1000.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--distributed",
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 1006
    assert blob["packets"] == 1000

    with pytest.raises(SystemExit, match="counts-only"):
        main([
            "match", "--pcap", str(reference_dir / "udp.pcap"),
            "--patterns", str(reference_dir / "strings.txt"),
            "--stream", "--distributed", "--offsets",
        ])
    with pytest.raises(SystemExit, match="requires --stream"):
        main([
            "match", "--pcap", str(reference_dir / "udp.pcap"),
            "--patterns", str(reference_dir / "strings.txt"),
            "--distributed",
        ])


def test_scan_streamed_unsharded_pallas_rows(synth_udp, tmp_path):
    """Unsharded streamed attribution with a default ('pallas') matcher —
    counts, offsets, and dump bytes identical to an explicit window
    matcher."""
    import json

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.patterns import load_patterns
    from multithreading_string_matching.parallel.pipeline import (
        scan_pcap_streamed,
    )

    path, pats = synth_udp
    w_dump, p_dump = tmp_path / "w.pcap", tmp_path / "p.pcap"
    m_w = Matcher(pats, engine="window")
    c_w, o_w = scan_pcap_streamed(
        m_w, path, "udp", offsets=True, dump_path=w_dump, batch_packets=130,
    )
    m_p = Matcher(pats)
    stats = {}
    c_p, o_p = scan_pcap_streamed(
        m_p, path, "udp", offsets=True, dump_path=p_dump, batch_packets=130,
        stats=stats,
    )
    assert stats["engine_resolved"] == "window"
    assert c_p.tolist() == c_w.tolist()
    assert int(c_p.sum()) > 0
    assert sorted(map(tuple, o_p)) == sorted(map(tuple, o_w))
    assert w_dump.read_bytes() == p_dump.read_bytes()


def test_sync_dispatch_rejects_nul_fallback(reference_dir):
    """sync_dispatch is a packed-path measurement mode; silently timing the
    per-row fallback would fabricate an 'overlap gain' — so it raises."""
    import pytest

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    nul = Matcher([b"a\x00b"], engine="window")
    with pytest.raises(ValueError, match="sync_dispatch"):
        count_pcap_streamed(
            nul, reference_dir / "udp.pcap", "udp", sync_dispatch=True
        )


def test_stream_blob_reports_actual_engine(reference_dir, capsys):
    """The execution blob echoes the engine the pipeline REPORTED (stats),
    not a re-derived rule: streamed attribution is window-native, so a kmp
    matcher shows engine_resolved=window with the remap note."""
    import json

    from multithreading_string_matching.cli import main

    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--offsets",
        "--engine", "kmp",
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert blob["execution"]["engine_resolved"] == "window"
    assert blob["execution"]["streamed_remap"] == "kmp->window"
    assert sum(blob["counts"]) == 39
    assert "engine_resolved" not in blob  # popped from the stats spread


def test_streamed_sharded_nul_patterns(reference_dir):
    """NUL-containing pattern sets can't sequence-pack, so sharded streaming
    routes them through the per-row scanner — sharded over the same mesh,
    not an unsharded fallback or a raise (round-1 verdict weak #3)."""
    import jax

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.parallel.mesh import make_mesh
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    nul = Matcher([b"ab\x00c", b"http", b"\x00\x00"], engine="window")
    mesh = make_mesh(jax.devices("cpu")[:8])
    stats = {}
    counts = count_pcap_streamed(
        nul, reference_dir / "udp.pcap", "udp",
        sharded=True, mesh=mesh, batch_packets=7, stats=stats,
    )
    want = nul.count_batch(
        extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    )
    assert counts.tolist() == want.tolist()
    assert stats["packets"] == 20


def test_scan_streamed_sharded_offsets_and_dump(reference_dir, tmp_path):
    """Sharded streamed attribution: offsets, dump selection, and counts all
    bit-identical to the unsharded streamed scan (the heavy per-row scan
    shards over the mesh; positions come from the flagged rows only)."""
    import jax

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.patterns import load_patterns
    from multithreading_string_matching.parallel.mesh import make_mesh
    from multithreading_string_matching.parallel.pipeline import (
        scan_pcap_streamed,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    mesh = make_mesh(jax.devices("cpu")[:8])
    d_s, d_u = tmp_path / "s.pcap", tmp_path / "u.pcap"
    stats_s, stats_u = {}, {}
    c_s, o_s = scan_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp", offsets=True,
        dump_path=d_s, sharded=True, mesh=mesh, batch_packets=130,
        stats=stats_s,
    )
    c_u, o_u = scan_pcap_streamed(
        m, reference_dir / "udp_1000.pcap", "udp", offsets=True,
        dump_path=d_u, batch_packets=130, stats=stats_u,
    )
    assert c_s.tolist() == c_u.tolist()
    assert int(c_s.sum()) == 1006
    assert sorted(map(tuple, o_s)) == sorted(map(tuple, o_u))
    assert stats_s["dumped_packets"] == stats_u["dumped_packets"]
    assert read_pcap(d_s).buf.tobytes() == read_pcap(d_u).buf.tobytes()
