"""CLI surface: argv contracts, golden output, error paths (component L5).

The reference's only interface is argv + printf; locking this surface in
tests is the automated version of diffing against serial.c's output.
"""

import numpy as np
import pytest

from multithreading_string_matching.cli import main

GOLDEN_UDP = """Printing the number of appereances of each string throughout the entire pcap file:
http: 5 times!
Linux: 5 times!
NOTIFY: 5 times!
LOCATION: 5 times!
id: 7 times!
rpc: 7 times!
xml: 5 times!"""


def _run(capsys, *argv):
    code = main(list(argv))
    out = capsys.readouterr()
    return code, out.out, out.err


def test_serial_golden_output(reference_dir, capsys):
    code, out, _ = _run(
        capsys, "serial", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "udp",
    )
    assert code == 0
    lines = out.strip().splitlines()
    assert lines[:-1] == GOLDEN_UDP.splitlines()   # counts, in file order
    assert lines[-1].startswith("Elapsed time = ")


def test_usage_on_missing_args(capsys):
    code, out, _ = _run(capsys, "serial")
    assert code == 1
    assert "USAGE" in out


def test_unknown_command(capsys):
    code, out, _ = _run(capsys, "frobnicate")
    assert code == 1
    assert "unknown command" in out


def test_no_args_prints_usage(capsys):
    assert main([]) == 1


def test_bad_mode_token(reference_dir, capsys):
    with pytest.raises(SystemExit) as ei:
        main([
            "serial", str(reference_dir / "udp.pcap"),
            str(reference_dir / "strings.txt"), "sctp",
        ])
    assert "unknown packet type" in str(ei.value)


def test_missing_pcap(reference_dir, capsys):
    code, _, err = _run(
        capsys, "serial", "/nonexistent.pcap", str(reference_dir / "strings.txt")
    )
    assert code == 1
    assert "error opening file" in err


def test_not_a_pcap(reference_dir, tmp_path, capsys):
    bad = tmp_path / "junk.pcap"
    bad.write_bytes(b"this is not a capture file at all.......")
    code, _, err = _run(
        capsys, "serial", str(bad), str(reference_dir / "strings.txt")
    )
    assert code == 1
    assert "not a classic pcap" in err


def test_match_json_fields(reference_dir, capsys):
    import json

    code, out, _ = _run(
        capsys, "match", "--pcap", str(reference_dir / "tcp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "tcp", "--json",
    )
    assert code == 0
    d = json.loads(out)
    assert sum(d["counts"]) == 4
    assert d["counts"][d["patterns"].index("ubuntu")] == 4
    assert d["packets"] == 13
    assert set(d["phases"]) >= {"ingest", "extract", "scan"}


def test_match_offsets_consistent_with_counts(reference_dir, capsys):
    import json

    code, out, _ = _run(
        capsys, "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--offsets", "--json",
    )
    assert code == 0
    d = json.loads(out)
    assert len(d["offsets"]) == 39
    # each offset row's pattern really occurs at that position
    from multithreading_string_matching import read_pcap, extract_payloads

    batch = extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    for n, i, u in d["offsets"][:10]:
        pat = d["unique_patterns"][u].encode("latin-1")
        assert batch.payloads[n, i : i + len(pat)].tobytes() == pat


def test_match_sharded_offsets_equal_unsharded(reference_dir, capsys):
    """One-shot --sharded --offsets rides the sharded per-row summary and
    re-scans only the HIT rows for positions — results must equal the
    unsharded scan exactly (counts, offsets as a set, dump selection)."""
    import json

    args = (
        "match", "--pcap", str(reference_dir / "udp_1000.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--offsets", "--json",
    )
    code, out, _ = _run(capsys, *args)
    assert code == 0
    want = json.loads(out)
    code, out, _ = _run(capsys, *args, "--sharded")
    assert code == 0
    got = json.loads(out)
    assert got["counts"] == want["counts"]
    assert sorted(map(tuple, got["offsets"])) == sorted(
        map(tuple, want["offsets"])
    )


def test_match_offsets_single_scan(reference_dir, capsys, monkeypatch):
    """--offsets derives counts from the SAME find_matches pass (bincount of
    occurrence rows); a second count_batch pass would scan the corpus
    twice."""
    import json

    from multithreading_string_matching.api import Matcher

    def boom(self, *a, **k):
        raise AssertionError("count_batch must not run for --offsets")

    monkeypatch.setattr(Matcher, "count_batch", boom)
    code, out, _ = _run(
        capsys, "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--offsets", "--json",
    )
    assert code == 0
    d = json.loads(out)
    assert sum(d["counts"]) == 39 and len(d["offsets"]) == 39


def test_exact_counts_keeps_int64_past_int32():
    from multithreading_string_matching.cli import _exact_counts

    small = _exact_counts(np.array([1, 2], dtype=np.int64))
    assert small.dtype == np.int32
    big = _exact_counts(np.array([2**31 + 5, 1], dtype=np.int64))
    assert big.dtype == np.int64 and big[0] == 2**31 + 5


@pytest.mark.parametrize("cmd", ["serial", "data", "task", "mesh", "live"])
@pytest.mark.parametrize("fixture,mode,total", [
    ("udp.pcap", "udp", 39),
    ("tcp.pcap", "tcp", 4),
])
def test_all_subcommands_agree(reference_dir, capsys, cmd, fixture, mode, total):
    """Every execution mode prints identical counts for the same input —
    the reference's cross-program validation strategy (SURVEY §4), run as a
    matrix over subcommand x protocol."""
    argv = [cmd, str(reference_dir / fixture), str(reference_dir / "strings.txt")]
    if cmd in ("data", "task", "live"):
        argv.insert(3, "4")  # thread-count slot
    argv.append(mode)
    code = main(argv)
    out = capsys.readouterr().out
    assert code == 0
    got = sum(
        int(line.rsplit(": ", 1)[1].split()[0])
        for line in out.splitlines()
        if line.endswith(" times!")
    )
    assert got == total, out


def test_thread_count_arg_drives_host_pool(reference_dir, capsys):
    """The reference's positional thread count is a MEANINGFUL argument
    (openmp_data.c:2,38 -> num_threads at :128): here it sizes the host
    worker pool.  Counts must be identical at any thread count."""
    code, out, _ = _run(
        capsys, "data", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "16", "udp",
    )
    assert code == 0
    assert "http: 5 times!" in out


def test_task_thread_count_reaches_host_workers(reference_dir, capsys, monkeypatch):
    """`task big.pcap strings.txt 4` must run the streamed pipeline with
    host_workers=4 — not parse-and-discard the argument (round-3 verdict)."""
    import multithreading_string_matching.parallel.pipeline as pipeline

    seen = {}
    real = pipeline.count_pcap_pipelined

    def spy(matcher, path, mode, **kw):
        seen.update(kw)
        return real(matcher, path, mode, **kw)

    monkeypatch.setattr(pipeline, "count_pcap_pipelined", spy)
    code, out, _ = _run(
        capsys, "task", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "4", "udp",
    )
    assert code == 0 and "http: 5 times!" in out
    assert seen.get("host_workers") == 4
    # 1 thread = no parallelism = sequential host path (host_workers=0).
    seen.clear()
    code, out, _ = _run(
        capsys, "task", str(reference_dir / "udp.pcap"),
        str(reference_dir / "strings.txt"), "1", "udp",
    )
    assert code == 0 and seen.get("host_workers") == 0


def test_match_pattern_syntax_escaped(reference_dir, tmp_path, capsys):
    """`--pattern-syntax escaped` matches bytes fscanf patterns cannot hold:
    'NOTIFY\\x20*' (embedded space) hits the SSDP 'NOTIFY * HTTP' lines."""
    import json

    f = tmp_path / "p.txt"
    f.write_bytes(rb"NOTIFY\x20* NOTIFY")
    code, out, _ = _run(
        capsys, "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(f), "--mode", "udp", "--json",
        "--pattern-syntax", "escaped",
    )
    assert code == 0
    blob = json.loads(out)
    assert blob["patterns"] == ["NOTIFY *", "NOTIFY"]
    assert blob["counts"][1] == 5          # golden NOTIFY count
    assert 0 < blob["counts"][0] <= 5      # every 'NOTIFY *' is a NOTIFY


def test_match_json_execution_blob(reference_dir, capsys):
    import json

    code, out, _ = _run(
        capsys, "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--mode", "udp", "--json",
    )
    assert code == 0
    ex = json.loads(out)["execution"]
    assert ex["patterns"] == 97 and ex["unique_patterns"] == 87
    assert ex["engine_resolved"] in ("pallas", "window")
    assert ex["nul_patterns"] is False
    # Large and small sets alike resolve 'pallas' to the window engine;
    # the blob names the platform it resolved for.
    from multithreading_string_matching.api import Matcher

    big = Matcher([bytes([65 + i % 26, 66, 67, 68, 69, 70, 71, 72 + i % 8])
                   + str(i).encode() for i in range(400)])
    ex2 = big.explain()
    assert ex2["total_pattern_words"] > 512
    assert ex2["engine_resolved"] == "window"
    assert ex2["platform"] == "cpu"
    assert Matcher([b"http", b"xml"]).explain()["engine_resolved"] == "window"
