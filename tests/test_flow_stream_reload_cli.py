"""SIGHUP rules reload on the streamed flow CLI (`match --flows --stream`
behind a pipe — the flow-monitor daemon idiom, mirroring the live
subcommand's).  Driven as a real subprocess reading a split capture from
stdin so the actual signal path (handler flag -> between-chunks
FlowStreamMatcher.reload -> per-epoch reports) runs."""

import os
import signal
import struct
import subprocess
import sys
import time

import pytest


def _split_capture(path, after_records: int) -> int:
    """Byte offset of the boundary after ``after_records`` packet records
    (24-byte classic global header + per-record 16-byte headers)."""
    raw = path.read_bytes()
    off = 24
    for _ in range(after_records):
        caplen = struct.unpack_from("<I", raw, off + 8)[0]
        off += 16 + caplen
    return off


def _wait_consumed(pid, timeout: float) -> None:
    """Wait until the process blocks reading its stdin pipe (wchan) — the
    cheap Linux-ism that tells us the first capture slice was consumed
    before we signal.  Falls through after the timeout (the assertions
    below hold under either ordering; this just makes the strong one
    overwhelmingly likely)."""
    deadline = time.monotonic() + timeout
    streak = 0
    while time.monotonic() < deadline:
        try:
            wchan = open(f"/proc/{pid}/wchan").read()
        except OSError:
            return
        streak = streak + 1 if "pipe" in wchan else 0
        if streak >= 3:
            return
        time.sleep(0.2)


@pytest.mark.skipif(not hasattr(signal, "SIGHUP"), reason="no SIGHUP")
def test_flow_stream_sighup_reload(tmp_path):
    from multithreading_string_matching.io.synth import (
        synth_tcp_flows_pcap,
    )

    cap = tmp_path / "flow.pcap"
    # One flow, two segments: "xxSIGyy" then "SIGNATUREzz" — the swap
    # lands between them.
    synth_tcp_flows_pcap(
        cap, [(("10.0.0.1", "10.0.0.2", 1111, 80),
               b"xxSIGyySIGNATUREzz", [7, 11])],
    )
    raw = cap.read_bytes()
    split = _split_capture(cap, 1)
    rules = tmp_path / "rules.txt"
    rules.write_text("SIG\n")
    out_f, err_f = tmp_path / "out.log", tmp_path / "err.log"
    env = dict(os.environ, MSM_PLATFORM="cpu", PYTHONUNBUFFERED="1",
               MSM_FLOW_BATCH="1")
    with open(out_f, "wb") as out, open(err_f, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m",
             "multithreading_string_matching", "match",
             "--pcap", "-", "--patterns", str(rules), "--mode", "tcp",
             "--flows", "--stream"],
            stdin=subprocess.PIPE, stdout=out, stderr=err, env=env,
        )
        try:
            proc.stdin.write(raw[:split])
            proc.stdin.flush()
            _wait_consumed(proc.pid, 120)
            rules.write_text("SIGNATURE\n")
            proc.send_signal(signal.SIGHUP)
            time.sleep(0.5)  # flag lands; swap happens on the next chunk
            proc.stdin.write(raw[split:])
            proc.stdin.close()
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
    err_text = err_f.read_text()
    out_text = out_f.read_text()
    assert "# rules reloaded" in err_text
    # Old-epoch report (stderr) covers the OLD set on the first segment;
    # the final report (stdout) is the NEW set only.
    assert "SIG: 1 times!" in err_text
    assert "SIGNATURE: 1 times!" in out_text
    assert "SIG: " not in out_text.replace("SIGNATURE: ", "")


@pytest.mark.skipif(not hasattr(signal, "SIGHUP"), reason="no SIGHUP")
def test_flow_stream_sighup_bad_rules_keeps_old(tmp_path):
    from multithreading_string_matching.io.synth import (
        synth_tcp_flows_pcap,
    )

    cap = tmp_path / "flow.pcap"
    synth_tcp_flows_pcap(
        cap, [(("10.0.0.1", "10.0.0.2", 1111, 80), b"xxSIGyySIGz",
               [7, 4])],
    )
    raw = cap.read_bytes()
    split = _split_capture(cap, 1)
    rules = tmp_path / "rules.txt"
    rules.write_text("SIG\n")
    out_f, err_f = tmp_path / "out.log", tmp_path / "err.log"
    env = dict(os.environ, MSM_PLATFORM="cpu", PYTHONUNBUFFERED="1",
               MSM_FLOW_BATCH="1")
    with open(out_f, "wb") as out, open(err_f, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m",
             "multithreading_string_matching", "match",
             "--pcap", "-", "--patterns", str(rules), "--mode", "tcp",
             "--flows", "--stream"],
            stdin=subprocess.PIPE, stdout=out, stderr=err, env=env,
        )
        try:
            proc.stdin.write(raw[:split])
            proc.stdin.flush()
            _wait_consumed(proc.pid, 120)
            os.unlink(rules)  # a bad rule push must not kill the monitor
            proc.send_signal(signal.SIGHUP)
            time.sleep(0.5)
            proc.stdin.write(raw[split:])
            proc.stdin.close()
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
    assert "# rules reload failed, keeping old set" in err_f.read_text()
    # The whole stream counted under the surviving old set.
    assert "SIG: 2 times!" in out_f.read_text()


@pytest.mark.skipif(not hasattr(signal, "SIGHUP"), reason="no SIGHUP")
def test_flow_stream_sighup_json_epochs(tmp_path):
    """Under --json the epoch record is a machine-readable stderr JSON
    line and the final blob says how many reloads happened (its counts
    cover only the last epoch)."""
    import json

    from multithreading_string_matching.io.synth import (
        synth_tcp_flows_pcap,
    )

    cap = tmp_path / "flow.pcap"
    synth_tcp_flows_pcap(
        cap, [(("10.0.0.1", "10.0.0.2", 1111, 80),
               b"xxSIGyySIGNATUREzz", [7, 11])],
    )
    raw = cap.read_bytes()
    split = _split_capture(cap, 1)
    rules = tmp_path / "rules.txt"
    rules.write_text("SIG\n")
    out_f, err_f = tmp_path / "out.log", tmp_path / "err.log"
    env = dict(os.environ, MSM_PLATFORM="cpu", PYTHONUNBUFFERED="1",
               MSM_FLOW_BATCH="1")
    with open(out_f, "wb") as out, open(err_f, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m",
             "multithreading_string_matching", "match",
             "--pcap", "-", "--patterns", str(rules), "--mode", "tcp",
             "--flows", "--stream", "--json"],
            stdin=subprocess.PIPE, stdout=out, stderr=err, env=env,
        )
        try:
            proc.stdin.write(raw[:split])
            proc.stdin.flush()
            _wait_consumed(proc.pid, 120)
            rules.write_text("SIGNATURE\n")
            proc.send_signal(signal.SIGHUP)
            time.sleep(0.5)
            proc.stdin.write(raw[split:])
            proc.stdin.close()
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
    epoch_lines = [json.loads(ln) for ln in err_f.read_text().splitlines()
                   if ln.startswith("{")]
    assert epoch_lines and epoch_lines[0]["reload"] == 1
    assert epoch_lines[0]["patterns"] == ["SIG"]
    assert epoch_lines[0]["counts"] == [1]
    blob = json.loads(out_f.read_text())
    assert blob["reloads"] == 1
    assert blob["patterns"] == ["SIGNATURE"] and blob["counts"] == [1]
