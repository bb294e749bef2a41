"""`--flows --sharded` composition (round-5 continuation): one-shot flow
scans ride the mesh (counts, pattern axis, offsets via the sharded
summary + hit-rows-only positions) and the streamed form shards the
flow-lane axis — all bit-identical to the unsharded runs."""

import json

import pytest

from multithreading_string_matching.cli import main
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap

FLOWS = [
    (("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGNATUREyy", [4, 5, 4]),
    (("10.0.0.3", "10.0.0.2", 2222, 80), b"SIGpqSIGr", [3, 3, 3]),
    (("10.0.0.4", "10.0.0.2", 3333, 80), b"no hits here", [6, 6]),
]


@pytest.fixture()
def capture(tmp_path):
    cap = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(cap, FLOWS, interleave_seed=11)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIGNATURE\nSIG\n")
    return cap, strings


def _run(capsys, cap, strings, *extra):
    code = main([
        "match", "--pcap", str(cap), "--patterns", str(strings),
        "--mode", "tcp", "--flows", "--json", *extra,
    ])
    out = capsys.readouterr().out
    return code, json.loads(out)


def test_sharded_counts_equal_unsharded(capture, capsys):
    cap, strings = capture
    _, want = _run(capsys, cap, strings)
    assert want["counts"] == [1, 3]
    for axis in ("packets", "patterns", "both"):
        code, got = _run(capsys, cap, strings, "--sharded",
                         "--shard-axis", axis)
        assert code == 0
        assert got["counts"] == want["counts"], axis
        assert got["flows"] == want["flows"] == 3


def test_sharded_offsets_equal_unsharded(capture, capsys):
    cap, strings = capture
    _, want = _run(capsys, cap, strings, "--offsets")
    for axis in ("packets", "patterns"):
        code, got = _run(capsys, cap, strings, "--offsets", "--sharded",
                         "--shard-axis", axis)
        assert code == 0
        assert got["counts"] == want["counts"]
        assert sorted(map(tuple, got["offsets"])) == sorted(
            map(tuple, want["offsets"])
        ), axis
        assert got["flow_keys"] == want["flow_keys"]


def test_streamed_sharded_counts(capture, capsys):
    cap, strings = capture
    code, got = _run(capsys, cap, strings, "--stream", "--sharded")
    assert code == 0
    assert got["counts"] == [1, 3] and got["flows"] == 3


def test_streamed_pattern_axis_rejected(capture, capsys):
    cap, strings = capture
    with pytest.raises(SystemExit, match="flow-lane axis"):
        main([
            "match", "--pcap", str(capture[0]), "--patterns", str(strings),
            "--mode", "tcp", "--flows", "--stream", "--json",
            "--sharded", "--shard-axis", "patterns",
        ])


def test_sharded_empty_capture(tmp_path, capsys):
    """A capture with zero decodable flows answers zeros without touching
    shard_batch (which needs >=1 row)."""
    cap = tmp_path / "empty.pcap"
    synth_tcp_flows_pcap(cap, [], noise_packets=4)
    strings = tmp_path / "strings.txt"
    strings.write_text("SIG\n")
    code, got = _run(capsys, cap, strings, "--sharded", "--offsets")
    assert code == 0
    assert got["counts"] == [0] and got["flows"] == 0
    assert got["offsets"] == []


def _dump_equal(cap, strings, tmp_path, capsys, *extra):
    from multithreading_string_matching.io.flows import extract_flows
    from multithreading_string_matching.io.pcap import read_pcap

    out = tmp_path / ("dump_" + "_".join(e.strip("-") for e in extra) or "d")
    out = out.with_suffix(".pcap")
    code, got = _run(capsys, cap, strings, "--dump-matches", str(out),
                     *extra)
    assert code == 0 and got["counts"] == [1, 3]
    # The dump holds EXACTLY the hit flows' conversations — every packet
    # of flows A and B (including segments without matches), none of the
    # clean flow C.
    dumped = extract_flows(read_pcap(out), "tcp")
    assert dumped.num_flows == 2
    streams = {dumped.key_tuple(f)[2]: dumped.stream(f) for f in range(2)}
    assert streams[1111] == FLOWS[0][1] and streams[2222] == FLOWS[1][1]
    return got


def test_dump_matches_hit_conversations(capture, tmp_path, capsys):
    """--flows --dump-matches re-emits the FULL conversation of every hit
    flow (the forensics shape), unsharded and sharded, with and without
    --offsets riding the same scan."""
    cap, strings = capture
    blob = _dump_equal(cap, strings, tmp_path, capsys)
    assert blob.get("dump_path", "").endswith(".pcap")
    assert "offsets" not in blob  # dump alone does not imply offsets
    with_off = _dump_equal(cap, strings, tmp_path, capsys, "--offsets")
    assert len(with_off["offsets"]) == 4
    for axis in ("packets", "patterns"):
        _dump_equal(cap, strings, tmp_path, capsys, "--sharded",
                    "--shard-axis", axis)


def test_dump_matches_stream_rejected(capture, capsys):
    cap, strings = capture
    with pytest.raises(SystemExit, match="one-shot"):
        main([
            "match", "--pcap", str(cap), "--patterns", str(strings),
            "--mode", "tcp", "--flows", "--stream", "--json",
            "--dump-matches", "x.pcap",
        ])
