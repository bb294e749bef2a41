"""Compressed-capture ingest (io/pcap.py open_capture).

Capture archives are routinely stored compressed (tcpdump -z gzips rotated
files; libpcap built with zlib reads .pcap.gz itself).  The reference, built
on plain libpcap, would also accept gzip captures on zlib builds — so the
framework accepts gzip plus the other two stdlib codecs (bzip2, xz), detected
by content magic, never extension.  Pins: one-shot == streamed == plain on
every codec, through both the classic and pcapng containers, and through the
streamed counting pipeline.
"""

import bz2
import gzip
import lzma

import numpy as np
import pytest

from multithreading_string_matching.io import open_capture, read_pcap, iter_pcap, concat_pcaps
from multithreading_string_matching.api import Matcher, load_patterns
from multithreading_string_matching.parallel.pipeline import count_pcap_streamed

CODECS = {
    "gzip": gzip.compress,
    "bz2": bz2.compress,
    "xz": lzma.compress,
}


def _same_capture(a, b):
    # One-shot parses keep the whole file as buf (offsets point into it);
    # streamed batches keep only captured bytes — compare per-packet views.
    assert a.num_packets == b.num_packets
    assert a.linktype == b.linktype and a.nanos == b.nanos
    np.testing.assert_array_equal(a.caplens, b.caplens)
    np.testing.assert_array_equal(a.origlens, b.origlens)
    np.testing.assert_array_equal(a.ts_sec, b.ts_sec)
    np.testing.assert_array_equal(a.ts_frac, b.ts_frac)
    for i in range(a.num_packets):
        np.testing.assert_array_equal(a.packet(i), b.packet(i))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_read_pcap_compressed_equals_plain(codec, reference_dir, tmp_path):
    raw = (reference_dir / "udp.pcap").read_bytes()
    # Deliberately misleading extension: detection must be by magic.
    path = tmp_path / "capture.pcap"
    path.write_bytes(CODECS[codec](raw))
    _same_capture(read_pcap(path), read_pcap(reference_dir / "udp.pcap"))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_iter_pcap_streams_compressed(codec, reference_dir, tmp_path):
    raw = (reference_dir / "udp_1000.pcap").read_bytes()
    path = tmp_path / f"cap.{codec}"
    path.write_bytes(CODECS[codec](raw))
    # Small read_size forces many decompressor refills mid-record.
    batches = list(iter_pcap(path, batch_packets=64, read_size=4096))
    assert len(batches) > 1
    _same_capture(concat_pcaps(batches), read_pcap(reference_dir / "udp_1000.pcap"))


def test_open_capture_plain_passthrough(reference_dir):
    with open_capture(reference_dir / "udp.pcap") as f:
        head = f.read(4)
    assert head == (reference_dir / "udp.pcap").read_bytes()[:4]


def test_pcapng_gzip(tmp_path, reference_dir):
    # pcapng container under gzip: both readers agree with the plain parse.
    from tests.test_pcapng import _pcapng_from

    plain = tmp_path / "s.pcapng"
    plain.write_bytes(_pcapng_from(read_pcap(reference_dir / "udp.pcap")))
    gz = tmp_path / "s.pcapng.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    _same_capture(read_pcap(gz), read_pcap(plain))
    batches = list(iter_pcap(gz, batch_packets=7, read_size=512))
    _same_capture(concat_pcaps(batches), read_pcap(plain))


def test_iter_pcap_from_pipe(reference_dir):
    # The privilege-separated live shape: tcpdump -w - | match --pcap -.
    # A real OS pipe (non-seekable) standing in for the capture process.
    import subprocess

    proc = subprocess.Popen(
        ["cat", str(reference_dir / "udp_1000.pcap")], stdout=subprocess.PIPE
    )
    try:
        batches = list(iter_pcap(proc.stdout, batch_packets=100))
    finally:
        proc.wait(timeout=30)
    _same_capture(concat_pcaps(batches), read_pcap(reference_dir / "udp_1000.pcap"))


def test_read_pcap_from_gzip_pipe(reference_dir, tmp_path):
    # Compression magic sniffed on a non-seekable stream.
    import subprocess

    gz = tmp_path / "c.gz"
    gz.write_bytes(gzip.compress((reference_dir / "udp.pcap").read_bytes()))
    proc = subprocess.Popen(["cat", str(gz)], stdout=subprocess.PIPE)
    try:
        got = read_pcap(proc.stdout)
    finally:
        proc.wait(timeout=30)
    _same_capture(got, read_pcap(reference_dir / "udp.pcap"))


def test_cli_match_stdin(reference_dir, tmp_path, monkeypatch, capsys):
    # match --pcap - reads the capture from stdin.
    import io as _io

    from multithreading_string_matching.cli import main

    raw = (reference_dir / "udp.pcap").read_bytes()
    monkeypatch.setattr(
        "sys.stdin", type("S", (), {"buffer": _io.BytesIO(raw)})()
    )
    code = main([
        "match", "--pcap", "-",
        "--patterns", str(reference_dir / "strings.txt"),
        "--stream", "--engine", "window",
    ])
    out = capsys.readouterr().out
    assert code == 0
    assert "rpc: 7 times!" in out


def test_iter_pcap_unbuffered_pipe_short_reads(reference_dir):
    # Raw (buffering=0) pipe ends deliver short reads; the sniff/header/refill
    # loops must fill rather than treat a short read as EOF.
    import os
    import threading

    raw = (reference_dir / "udp_1000.pcap").read_bytes()
    r, w = os.pipe()

    def writer():
        # Drip in awkward sizes (3 bytes splits every magic/header boundary).
        for i in range(0, len(raw), 3):
            os.write(w, raw[i : i + 3])
        os.close(w)

    t = threading.Thread(target=writer)
    t.start()
    try:
        got = concat_pcaps(list(iter_pcap(os.fdopen(r, "rb", buffering=0), batch_packets=100)))
    finally:
        t.join(timeout=30)
    _same_capture(got, read_pcap(reference_dir / "udp_1000.pcap"))


def test_iter_pcap_pipe_yields_before_eof(reference_dir):
    # Live-pipe liveness: a batch must come out while the writer is still
    # open (a blocking 4 MB fill would stall until EOF).
    import os
    import struct as _struct
    import threading

    full = read_pcap(reference_dir / "udp_1000.pcap")
    raw = (reference_dir / "udp_1000.pcap").read_bytes()
    # Bytes of the global header + first 3 records.
    upto = int(full.offsets[3])  # offset of record 3's data; its header is 16 back
    head = raw[: upto - 16]
    r, w = os.pipe()
    os.write(w, head)

    batches = iter_pcap(os.fdopen(r, "rb", buffering=0), batch_packets=2)
    first = next(batches)  # must arrive with the pipe still open
    assert first.num_packets == 2
    np.testing.assert_array_equal(first.caplens, full.caplens[:2])

    def finish():
        os.write(w, raw[upto - 16 :])
        os.close(w)

    t = threading.Thread(target=finish)
    t.start()
    rest = list(batches)
    t.join(timeout=30)
    got = concat_pcaps([first] + rest)
    assert got.num_packets == full.num_packets


def test_streamed_pipeline_accepts_file_object(reference_dir):
    # count_pcap_streamed must treat a file object as ONE source, not
    # iterate it as a sequence of paths.
    patterns = load_patterns(reference_dir / "strings.txt")
    m = Matcher(patterns, engine="window")
    with open(reference_dir / "udp_1000.pcap", "rb") as f:
        got = count_pcap_streamed(m, f, batch_packets=128)
    want = m.count_pcap(reference_dir / "udp_1000.pcap")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_plain_file_oserror_propagates(reference_dir):
    # A genuine I/O error on an UNCOMPRESSED source must surface as the
    # OSError it is — not swallowed (tolerant) or relabeled (strict).
    raw = (reference_dir / "udp.pcap").read_bytes()

    class Flaky:
        def __init__(self):
            self.served = 0

        def read(self, n=-1):
            if n is None or n < 0 or self.served >= 100:
                # A read-all (or any read past byte 100) dies mid-flight,
                # as a BufferedReader.read() does on a real EIO.
                raise OSError(5, "Input/output error")
            out = raw[self.served : self.served + min(n, 64)]
            self.served += len(out)
            return out

    with pytest.raises(OSError):
        read_pcap(Flaky())
    with pytest.raises(OSError):
        read_pcap(Flaky(), strict=False)
    with pytest.raises(OSError):
        list(iter_pcap(Flaky(), strict=False))


def test_open_capture_does_not_close_caller_stream(reference_dir):
    import io as _io

    stream = _io.BytesIO((reference_dir / "udp.pcap").read_bytes())
    with open_capture(stream) as f:
        f.read(24)
    assert not stream.closed  # caller owns it
    # ... but paths we opened ourselves are closed by the context manager.
    with open_capture(reference_dir / "udp.pcap") as f:
        f.read(24)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_truncated_compressed_strict_raises(codec, reference_dir, tmp_path):
    blob = CODECS[codec]((reference_dir / "udp_1000.pcap").read_bytes())
    path = tmp_path / "t.bin"
    path.write_bytes(blob[: len(blob) - 17])
    with pytest.raises(ValueError, match="compressed"):
        read_pcap(path)  # strict default
    with pytest.raises(ValueError, match="compressed"):
        list(iter_pcap(path, batch_packets=64))


# bz2 is absent: it decodes in ~900 KB blocks, so a truncated single-block
# archive has NO recoverable prefix (codec-inherent) — tolerant mode then
# sees an empty stream and raises the missing-global-header ValueError.
@pytest.mark.parametrize("codec", ["gzip", "xz"])
def test_truncated_compressed_tolerant_keeps_prefix(codec, reference_dir, tmp_path):
    raw = (reference_dir / "udp_1000.pcap").read_bytes()
    blob = CODECS[codec](raw)
    path = tmp_path / "t.bin"
    path.write_bytes(blob[: len(blob) - 17])
    full = read_pcap(reference_dir / "udp_1000.pcap")
    part = read_pcap(path, strict=False)
    assert 0 < part.num_packets <= full.num_packets
    np.testing.assert_array_equal(part.caplens, full.caplens[: part.num_packets])
    streamed = list(iter_pcap(path, batch_packets=64, strict=False, read_size=4096))
    got = concat_pcaps(streamed)
    assert got.num_packets == part.num_packets


@pytest.mark.parametrize("suffix", ["gz", "bz2", "xz"])
def test_write_pcap_compressed_roundtrip(suffix, reference_dir, tmp_path):
    from multithreading_string_matching.io.pcap import write_pcap, PcapWriter

    full = read_pcap(reference_dir / "udp.pcap")
    out = tmp_path / f"out.pcap.{suffix}"
    n = write_pcap(out, full)
    assert n == full.num_packets
    _same_capture(read_pcap(out), full)

    # Incremental writer: two chunks inside one compressed member.
    out2 = tmp_path / f"inc.pcap.{suffix}"
    with PcapWriter(out2) as w:
        w.write(full, np.arange(0, 10))
        w.write(full, np.arange(10, full.num_packets))
    _same_capture(read_pcap(out2), full)


def test_streamed_counts_on_gzip(reference_dir, tmp_path):
    patterns = load_patterns(reference_dir / "strings.txt")
    gz = tmp_path / "udp_1000.pcap.gz"
    gz.write_bytes(gzip.compress((reference_dir / "udp_1000.pcap").read_bytes()))
    m = Matcher(patterns, engine="window")
    got = count_pcap_streamed(m, gz, batch_packets=128)
    want = m.count_pcap(reference_dir / "udp_1000.pcap")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
