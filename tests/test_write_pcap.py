"""write_pcap + `match --dump-matches`: re-emitting (matched) packets.

The reference never writes captures — results only leave as printf counts
(serial.c:163-169).  The writer must round-trip bit-exactly with the reader,
and the dump of matched packets must preserve every match (counts on the
dump equal counts on the full capture, because matches only live in matched
packets).
"""

import json

import numpy as np
import pytest

from multithreading_string_matching.api import Matcher
from multithreading_string_matching.cli import main
from multithreading_string_matching.io.decode import extract_payloads
from multithreading_string_matching.io.patterns import load_patterns
from multithreading_string_matching.io.pcap import (
    read_pcap,
    slice_pcap,
    write_pcap,
)


def _records(pf):
    return [
        (
            int(pf.ts_sec[i]), int(pf.ts_frac[i]), int(pf.origlens[i]),
            pf.packet(i).tobytes(),
        )
        for i in range(pf.num_packets)
    ]


def test_full_roundtrip_bit_exact(reference_dir, tmp_path):
    src = read_pcap(reference_dir / "udp.pcap")
    out = tmp_path / "copy.pcap"
    assert write_pcap(out, src) == src.num_packets
    dst = read_pcap(out)
    assert dst.linktype == src.linktype
    assert dst.snaplen == src.snaplen
    assert dst.nanos == src.nanos
    assert _records(dst) == _records(src)


def test_subset_selection_and_order(reference_dir, tmp_path):
    src = read_pcap(reference_dir / "udp_1000.pcap")
    idx = np.asarray([5, 2, 999, 2])  # arbitrary order, duplicates allowed
    out = tmp_path / "subset.pcap"
    assert write_pcap(out, src, idx) == 4
    dst = read_pcap(out)
    want = [_records(src)[i] for i in idx]
    assert _records(dst) == want


def test_empty_selection(reference_dir, tmp_path):
    src = read_pcap(reference_dir / "udp.pcap")
    out = tmp_path / "empty.pcap"
    assert write_pcap(out, src, np.zeros(0, dtype=np.int64)) == 0
    dst = read_pcap(out)
    assert dst.num_packets == 0
    assert dst.linktype == src.linktype


def test_index_out_of_range(reference_dir, tmp_path):
    src = read_pcap(reference_dir / "udp.pcap")
    with pytest.raises(ValueError, match="out of range"):
        write_pcap(tmp_path / "x.pcap", src, [src.num_packets])
    with pytest.raises(ValueError, match="out of range"):
        write_pcap(tmp_path / "x.pcap", src, [-1])


def test_pcapng_reemits_as_classic(reference_dir, tmp_path):
    # Build a pcapng from fixture packets using the test helper in
    # test_pcapng, then read->write->read must preserve the records.
    from tests.test_pcapng import _pcapng_from

    src = read_pcap(reference_dir / "udp.pcap")
    sub = slice_pcap(src, 0, 5)
    ng = tmp_path / "a.pcapng"
    ng.write_bytes(_pcapng_from(sub))
    parsed = read_pcap(ng)
    out = tmp_path / "b.pcap"
    write_pcap(out, parsed)
    again = read_pcap(out)
    assert _records(again) == _records(parsed)


def test_dump_matches_preserves_all_counts(reference_dir, tmp_path, capsys):
    out = tmp_path / "hits.pcap"
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--dump-matches", str(out),
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert blob["dump_path"] == str(out)

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    dump = read_pcap(out)
    assert dump.num_packets == blob["dumped_packets"] > 0
    sub_counts = m.count_batch(extract_payloads(dump, "udp"))
    assert sub_counts.tolist() == blob["counts"]

    # Every dumped packet really contains a match; none were dropped.
    full = read_pcap(reference_dir / "udp.pcap")
    per_row = m.count_batch(extract_payloads(full, "udp"), per_packet=True)
    batch = extract_payloads(full, "udp")
    n_valid = int(batch.valid.sum())
    assert int((per_row[:n_valid].sum(axis=1) > 0).sum()) == dump.num_packets


def test_dump_matches_sharded(reference_dir, tmp_path, capsys):
    """--dump-matches --sharded: the row-sharded scan keeps packet identity,
    so the dumped capture is byte-identical to the unsharded dump."""
    out_s = tmp_path / "s.pcap"
    out_u = tmp_path / "u.pcap"
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json",
        "--dump-matches", str(out_s), "--sharded",
    ])
    assert code == 0
    blob_s = json.loads(capsys.readouterr().out)
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--dump-matches", str(out_u),
    ])
    assert code == 0
    blob_u = json.loads(capsys.readouterr().out)
    assert blob_s["counts"] == blob_u["counts"]
    assert blob_s["dumped_packets"] == blob_u["dumped_packets"] > 0
    assert out_s.read_bytes() == out_u.read_bytes()


def test_dump_matches_with_per_packet_json(reference_dir, tmp_path, capsys):
    out = tmp_path / "hits.pcap"
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--per-packet",
        "--dump-matches", str(out),
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    mat = np.asarray(blob["counts"])
    assert mat.ndim == 2
    assert blob["dumped_packets"] == int((mat.sum(axis=1) > 0).sum())


# -- streaming dump (bounded-memory matched-packet extraction) ------------

def test_pcap_writer_incremental(reference_dir, tmp_path):
    from multithreading_string_matching.io.pcap import PcapWriter

    src = read_pcap(reference_dir / "udp_1000.pcap")
    out = tmp_path / "inc.pcap"
    with PcapWriter(out) as w:
        w.write(slice_pcap(src, 0, 300))
        w.write(slice_pcap(src, 300, 700), np.arange(100))
        assert w.packets_written == 400
    dst = read_pcap(out)
    want = _records(slice_pcap(src, 0, 300)) + _records(
        slice_pcap(src, 300, 400)
    )
    assert _records(dst) == want


def test_pcap_writer_empty_stream(tmp_path):
    from multithreading_string_matching.io.pcap import PcapWriter

    out = tmp_path / "none.pcap"
    with PcapWriter(out):
        pass
    assert read_pcap(out).num_packets == 0


def test_pcap_writer_metadata_mismatch(reference_dir, tmp_path):
    from dataclasses import replace

    from multithreading_string_matching.io.pcap import PcapWriter

    src = read_pcap(reference_dir / "udp.pcap")
    with PcapWriter(tmp_path / "x.pcap") as w:
        w.write(src)
        with pytest.raises(ValueError, match="metadata"):
            w.write(replace(src, linktype=113))


def test_dump_matches_streamed_equals_oneshot(reference_dir, tmp_path):
    from multithreading_string_matching.parallel.pipeline import (
        dump_matches_streamed,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    out = tmp_path / "hits.pcap"
    stats = {}
    # Tiny chunks force many writer appends and many per-row scans.
    counts = dump_matches_streamed(
        m, reference_dir / "udp_1000.pcap", out, "udp",
        batch_packets=97, stats=stats,
    )
    full = read_pcap(reference_dir / "udp_1000.pcap")
    batch = extract_payloads(full, "udp")
    want = m.count_batch(batch)
    assert counts.tolist() == want.tolist()
    assert int(counts.sum()) == 1006  # BASELINE.md variant A

    dump = read_pcap(out)
    assert dump.num_packets == stats["dumped_packets"]
    # The dump reproduces the full capture's counts exactly.
    got = m.count_batch(extract_payloads(dump, "udp"))
    assert got.tolist() == want.tolist()
    # And it contains precisely the matching packets.
    per_row = m.count_batch(batch, per_packet=True)
    n_valid = int(batch.valid.sum())
    assert dump.num_packets == int((per_row[:n_valid].sum(axis=1) > 0).sum())


def test_cli_stream_dump_matches(reference_dir, tmp_path, capsys):
    out = tmp_path / "hits.pcap"
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--dump-matches", str(out),
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39
    assert blob["dump_path"] == str(out)
    assert read_pcap(out).num_packets == blob["dumped_packets"] == 10


# -- live-mode dump (StreamMatcher dump_writer) ----------------------------

def test_stream_matcher_dump_writer(reference_dir, tmp_path):
    from multithreading_string_matching.io.live import FileReplaySource
    from multithreading_string_matching.io.pcap import PcapWriter
    from multithreading_string_matching.parallel.stream import StreamMatcher

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    out = tmp_path / "live_hits.pcap"
    with PcapWriter(out) as w:
        stream = StreamMatcher(m, dump_writer=w)
        for batch in FileReplaySource(str(reference_dir / "udp.pcap")):
            stream.feed_pcap_slice(batch, "udp", bpf_filter=True)
        counts = stream.counts()
    assert int(counts.sum()) == 39

    dump = read_pcap(out)
    got = m.count_batch(extract_payloads(dump, "udp"))
    assert got.tolist() == counts.tolist()
    assert dump.num_packets == 10  # matching packets of udp.pcap


def test_stream_matcher_dump_batched_flush(reference_dir, tmp_path):
    """Packed-mode dump attribution batches slices into ONE scan per
    ~dump_scan_rows (no per-slice dispatch); explicit flush() before the
    writer closes yields the same dump as per-slice mode."""
    from multithreading_string_matching.io.live import FileReplaySource
    from multithreading_string_matching.io.pcap import PcapWriter
    from multithreading_string_matching.parallel.stream import StreamMatcher

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    out_b = tmp_path / "batched.pcap"
    out_u = tmp_path / "per_slice.pcap"
    with PcapWriter(out_b) as w:
        s = StreamMatcher(m, dump_writer=w)
        assert s._tiles is not None
        for batch in FileReplaySource(str(reference_dir / "udp.pcap")):
            s.feed_pcap_slice(batch, "udp", bpf_filter=True)
        # Nothing written yet: 20 packets < dump_scan_rows -> all pending.
        assert s._dump_pending_rows > 0 and w.packets_written == 0
        s.flush()
        assert s._dump_pending_rows == 0
    with PcapWriter(out_u) as w2:
        s2 = StreamMatcher(m, dump_writer=w2, packed=False)
        for batch in FileReplaySource(str(reference_dir / "udp.pcap")):
            s2.feed_pcap_slice(batch, "udp", bpf_filter=True)
    assert out_b.read_bytes() == out_u.read_bytes()
    assert read_pcap(out_b).num_packets == 10


def test_cli_live_dump_matches(reference_dir, tmp_path, capsys):
    out = tmp_path / "live_hits.pcap"
    code = main([
        "live", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "4", "udp",
        "--dump-matches", str(out),
    ])
    assert code == 0
    stdout = capsys.readouterr().out
    assert "http: 5 times!" in stdout
    assert read_pcap(out).num_packets == 10


def test_cli_live_dump_matches_missing_value(reference_dir, capsys):
    code = main([
        "live", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "--dump-matches",
    ])
    assert code == 1
    assert "USAGE" in capsys.readouterr().out


# -- review-finding regressions --------------------------------------------

def test_pcap_writer_accepts_boolean_mask(reference_dir, tmp_path):
    from multithreading_string_matching.io.pcap import PcapWriter

    src = read_pcap(reference_dir / "udp.pcap")
    mask = np.zeros(src.num_packets, dtype=bool)
    mask[[3, 7]] = True
    out = tmp_path / "m.pcap"
    with PcapWriter(out) as w:
        assert w.write(src, mask) == 2
    assert _records(read_pcap(out)) == [_records(src)[3], _records(src)[7]]
    with PcapWriter(tmp_path / "bad.pcap") as w:
        with pytest.raises(ValueError, match="boolean mask"):
            w.write(src, mask[:-1])


def test_pcap_writer_empty_selection_locks_metadata(reference_dir, tmp_path):
    from dataclasses import replace

    from multithreading_string_matching.io.pcap import PcapWriter

    src = replace(read_pcap(reference_dir / "udp.pcap"), linktype=113)
    out = tmp_path / "sll.pcap"
    with PcapWriter(out) as w:
        w.write(src, np.zeros(0, dtype=np.int64))  # no packets, metadata only
    dst = read_pcap(out)
    assert dst.num_packets == 0
    assert dst.linktype == 113  # not the Ethernet fallback


def test_dump_matches_streamed_locks_linktype_when_all_invalid(tmp_path):
    """A capture whose packets never decode still dumps with ITS linktype."""
    import struct as _s

    from multithreading_string_matching.io.pcap import classic_global_header
    from multithreading_string_matching.parallel.pipeline import (
        dump_matches_streamed,
    )

    src = tmp_path / "runts.pcap"
    with open(src, "wb") as f:
        f.write(classic_global_header(linktype=113))
        for i in range(5):
            f.write(_s.pack("<IIII", i, 0, 4, 4) + b"\x00" * 4)  # undecodable
    m = Matcher([b"needle"], engine="window")
    out = tmp_path / "hits.pcap"
    counts = dump_matches_streamed(m, src, out, "udp")
    assert counts.tolist() == [0]
    dst = read_pcap(out)
    assert dst.num_packets == 0
    assert dst.linktype == 113


def test_writer_roundtrip_fuzz(tmp_path):
    """Random synthetic captures survive write->read->write bit-exactly."""
    from multithreading_string_matching.io.synth import synth_udp_pcap

    rng = np.random.default_rng(42)
    for trial in range(5):
        src_path = tmp_path / f"s{trial}.pcap"
        synth_udp_pcap(
            src_path, int(rng.integers(1, 40)),
            payload_len=int(rng.integers(0, 300)),
            payload_len_jitter=int(rng.integers(0, 50)),
            invalid_rate=float(rng.random() * 0.5),
            seed=trial,
        )
        src = read_pcap(src_path)
        out1 = tmp_path / f"o{trial}.pcap"
        write_pcap(out1, src)
        assert out1.read_bytes() == src_path.read_bytes()  # bit-identical file


# -- multi-capture ingest ---------------------------------------------------

def test_concat_pcaps_counts_and_dump(reference_dir, tmp_path, capsys):
    from multithreading_string_matching.io.pcap import concat_pcaps

    a = read_pcap(reference_dir / "udp.pcap")
    b = read_pcap(reference_dir / "udp_1000.pcap")
    merged = concat_pcaps([a, b])
    assert merged.num_packets == a.num_packets + b.num_packets
    assert _records(merged) == _records(a) + _records(b)

    with pytest.raises(ValueError, match="at least one"):
        concat_pcaps([])
    from dataclasses import replace
    with pytest.raises(ValueError, match="disagree"):
        concat_pcaps([a, replace(b, linktype=113)])

    out = tmp_path / "hits.pcap"
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--pcap", str(reference_dir / "udp_1000.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--dump-matches", str(out),
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39 + 1006
    # The dump spans both captures and reproduces the merged counts.
    m = Matcher(load_patterns(reference_dir / "strings.txt"), engine="window")
    got = m.count_batch(extract_payloads(read_pcap(out), "udp"))
    assert got.tolist() == blob["counts"]


def test_cli_multi_pcap_stream_matches_oneshot(reference_dir, capsys):
    code = main([
        "match", "--pcap", str(reference_dir / "udp_1000.pcap"),
        "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream",
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 1045
    assert blob["packets"] == 1020


def test_cli_match_requires_pcap(reference_dir):
    with pytest.raises(SystemExit, match="pcap"):
        main(["match", "--patterns", str(reference_dir / "strings.txt")])


# -- streamed offsets --------------------------------------------------------

def test_stream_offsets_equal_oneshot(reference_dir, capsys):
    """Streamed --offsets reproduce the one-shot find_matches rows exactly —
    numbered by ORIGINAL capture packet (valid-row indices mapped through
    batch.valid) — even across tiny chunks and two files."""
    from multithreading_string_matching.parallel.pipeline import (
        scan_pcap_streamed,
    )
    from multithreading_string_matching.io.pcap import concat_pcaps

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    paths = [reference_dir / "udp.pcap", reference_dir / "udp_1000.pcap"]
    counts, rows = scan_pcap_streamed(
        m, paths, "udp", offsets=True, batch_packets=57,
    )
    merged = concat_pcaps([read_pcap(p) for p in paths])
    batch = extract_payloads(merged, "udp")
    want_rows = np.asarray(m.find_matches(batch.payloads, batch.lengths))
    want_rows = want_rows.copy()
    want_rows[:, 0] = np.flatnonzero(batch.valid)[want_rows[:, 0]]
    got = sorted(map(tuple, rows.tolist()))
    want = sorted(map(tuple, want_rows.tolist()))
    assert got == want
    assert int(counts.sum()) == 39 + 1006
    # udp_1000 has invalid packets, so packet numbering must EXCEED the
    # valid-row count somewhere — the regression this semantics fixes.
    assert rows[:, 0].max() >= int(batch.valid.sum())


def test_cli_stream_offsets_json(reference_dir, capsys):
    code = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json", "--stream", "--offsets",
    ])
    assert code == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39
    uniq = blob["unique_patterns"]
    # Every offset row's pattern really occurs at that position.
    pcap = read_pcap(reference_dir / "udp.pcap")
    batch = extract_payloads(pcap, "udp")
    assert len(blob["offsets"]) == 39
    for row, start, u in blob["offsets"]:
        pat = uniq[u].encode("latin-1")
        assert batch.payload(row)[start : start + len(pat)] == pat
