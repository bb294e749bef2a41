"""Benchmark: multi-pattern payload scan throughput on one GPU.

Prints ONE JSON line:
  {"metric": "payload_bytes_per_sec", "value": N, "unit": "bytes/s",
   "vs_baseline": N / cpu_serial_bytes_per_sec, "device": {...}, ...}

Workload, made from seeds: a ~100 MB UDP capture (100k packets of
1 KB +- 256 B, io.synth.synth_udp_pcap) with a 97-entry mixed-length
(2-12 B) rule-file-shaped pattern set (io.synth.synth_patterns) planted in
it.  ``value`` is the matcher's default engine (the Pallas kernel on a GPU)
over the corpus staged on the device; ``end_to_end_bytes_per_sec`` is the
streamed serving path (count_pcap_streamed) from capture file to counts.

``vs_baseline`` compares against the reference's serial design point: a
-O2-compiled C KMP loop (per-pattern, per-payload — serial.c's hot-loop
structure, our own implementation in native/serial_baseline.c) over the
payload bytes of the corpus's first 2,000 packets on the host CPU.

Refuses to run without a GPU: a CPU number is not a device measurement.
"""

import json
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
REPS = 10


def cpu_serial_baseline(payload_list, patterns):
    """(bytes/s, total_matches) of the C serial KMP loop on this host."""
    src = REPO / "multithreading_string_matching" / "native" / "serial_baseline.c"
    exe = REPO / "build" / "serial_baseline"
    exe.parent.mkdir(exist_ok=True)
    if not exe.exists() or exe.stat().st_mtime < src.stat().st_mtime:
        tmp_exe = exe.with_name(f"{exe.name}.{os.getpid()}")
        subprocess.run(
            ["gcc", "-O2", "-o", str(tmp_exe), str(src)],
            check=True, capture_output=True,
        )
        os.replace(tmp_exe, exe)
    blob = b"".join(payload_list)
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(struct.pack("<qqq", len(payload_list), len(blob), len(patterns)))
        f.write(np.array([len(p) for p in payload_list], dtype="<i4").tobytes())
        f.write(blob)
        f.write(np.array([len(p) for p in patterns], dtype="<i4").tobytes())
        f.write(b"".join(patterns))
        f.flush()
        out = subprocess.run(
            [str(exe), f.name], check=True, capture_output=True, text=True
        ).stdout.split()
    elapsed, total_matches, nbytes = float(out[0]), int(out[1]), int(out[2])
    return nbytes / elapsed, total_matches


def main():
    import jax

    from multithreading_string_matching.utils.cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1

    from multithreading_string_matching import Matcher, extract_payloads, read_pcap
    from multithreading_string_matching.io.synth import (
        synth_patterns,
        synth_udp_pcap,
    )
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    patterns = synth_patterns(97, seed=1)
    matcher = Matcher(patterns)
    with tempfile.TemporaryDirectory() as d:
        corpus = pathlib.Path(d) / "udp.pcap"
        synth_udp_pcap(corpus, 100_000, payload_len=1024,
                       payload_len_jitter=256, patterns=patterns,
                       plant_rate=0.05, seed=1)
        batch = extract_payloads(read_pcap(corpus), "udp")
        payload_bytes = batch.total_payload_bytes

        t0 = time.perf_counter()
        prep = matcher.prepare_batch(batch, packed="auto", n_tile=8192)
        jax.block_until_ready([t for tile in prep.tiles for t in tile])
        h2d_s = time.perf_counter() - t0

        counts = np.asarray(matcher.count_prepared(prep))  # compile
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(matcher.count_prepared(prep, block=False))
            times.append(time.perf_counter() - t0)
        scan_s = float(np.median(times))

        count_pcap_streamed(matcher, corpus, "udp")  # compile
        stats = {}
        t0 = time.perf_counter()
        e2e = count_pcap_streamed(matcher, corpus, "udp", stats=stats)
        e2e_s = time.perf_counter() - t0
        if (np.asarray(e2e) != counts).any():
            raise AssertionError("streamed counts differ from the one-shot scan")

    n = min(2000, batch.num_payloads)
    payload_list = [
        batch.payloads[i, : batch.lengths[i]].tobytes() for i in range(n)
    ]
    cpu_bps, cpu_matches = cpu_serial_baseline(payload_list, patterns)
    want = matcher.count(batch.payloads[:n], batch.lengths[:n], engine="window")
    if cpu_matches != int(np.asarray(want).sum()):
        raise AssertionError((cpu_matches, int(np.asarray(want).sum())))

    bps = payload_bytes / scan_s
    print(json.dumps({
        "metric": "payload_bytes_per_sec",
        "value": bps,
        "unit": "bytes/s",
        "vs_baseline": bps / cpu_bps,
        "baseline_cpu_serial_bytes_per_sec": cpu_bps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "xla_flags": os.environ.get("XLA_FLAGS"),
        "engine": matcher.explain()["engine_resolved"],
        "payload_bytes": payload_bytes,
        "packets": int(batch.num_packets),
        "patterns": len(patterns),
        "total_matches": int(counts.sum()),
        "staging": "packed" if prep.packed else "bucketed",
        "scan_time_s": scan_s,
        "h2d_time_s": h2d_s,
        "end_to_end_bytes_per_sec": stats["payload_bytes"] / e2e_s,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
