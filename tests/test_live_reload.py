"""SIGHUP rules reload on the live CLI (cli.cmd_live + StreamMatcher.reload).

The daemon idiom the reference lacks entirely: update the pattern set
without dropping the tap.  Driven as a real subprocess so the actual signal
path (handler flag -> between-batches swap -> per-epoch reports) runs.
"""

import os
import signal
import subprocess
import sys
import time

import pytest


def _wait_for(path, needle: str, timeout: float) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        text = path.read_text() if path.exists() else ""
        if needle in text:
            return text
        time.sleep(0.05)
    raise AssertionError(
        f"timed out waiting for {needle!r}; have:\n{path.read_text() if path.exists() else ''}"
    )


@pytest.mark.skipif(not hasattr(signal, "SIGHUP"), reason="no SIGHUP")
def test_live_sighup_reloads_rules(tmp_path):
    from multithreading_string_matching.io.synth import synth_udp_pcap

    cap = tmp_path / "replay.pcap"
    # Big enough that replay is still running when the signal lands (each
    # 10-packet batch is a host-side feed; 50k packets ≈ 5000 batches).
    synth_udp_pcap(cap, 50_000, payload_len=96, patterns=[b"alpha", b"beta"],
                   plant_rate=0.2, seed=9)
    rules = tmp_path / "rules.txt"
    rules.write_text("alpha\n")

    out_f = tmp_path / "out.log"
    err_f = tmp_path / "err.log"
    env = dict(os.environ, MSM_PLATFORM="cpu", PYTHONUNBUFFERED="1")
    with open(out_f, "wb") as out, open(err_f, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "multithreading_string_matching",
             "live", str(cap), str(rules), "4", "udp"],
            stdout=out, stderr=err, env=env,
        )
        try:
            _wait_for(out_f, "Work in progress", 120)
            rules.write_text("beta\n")
            proc.send_signal(signal.SIGHUP)
            _wait_for(err_f, "# rules reloaded", 120)
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
    err_text = err_f.read_text()
    out_text = out_f.read_text()
    # Interim (stderr) report covers the OLD set; final (stdout) the NEW one.
    assert "alpha" in err_text
    assert "beta" in out_text and "alpha: " not in out_text
    # The stream identity persisted across the swap: one sniffed total
    # covers both epochs (SIGINT stops the replay early by design, so the
    # exact number varies with timing).
    import re

    m = re.search(r"(\d+) packet sniffed", out_text)
    assert m and int(m.group(1)) > 0


@pytest.mark.skipif(not hasattr(signal, "SIGHUP"), reason="no SIGHUP")
def test_live_sighup_bad_rules_keeps_old_set(tmp_path):
    from multithreading_string_matching.io.synth import synth_udp_pcap

    cap = tmp_path / "replay.pcap"
    synth_udp_pcap(cap, 50_000, payload_len=96, patterns=[b"alpha"],
                   plant_rate=0.2, seed=11)
    rules = tmp_path / "rules.txt"
    rules.write_text("alpha\n")

    out_f = tmp_path / "out.log"
    err_f = tmp_path / "err.log"
    env = dict(os.environ, MSM_PLATFORM="cpu", PYTHONUNBUFFERED="1")
    with open(out_f, "wb") as out, open(err_f, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "multithreading_string_matching",
             "live", str(cap), str(rules), "4", "udp"],
            stdout=out, stderr=err, env=env,
        )
        try:
            _wait_for(out_f, "Work in progress", 120)
            os.unlink(rules)  # reload will fail: rules file gone
            proc.send_signal(signal.SIGHUP)
            _wait_for(err_f, "reload failed", 120)
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
    # Old rules still in force: the final report prints alpha counts.
    assert "alpha: " in out_f.read_text()
