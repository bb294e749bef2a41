"""Multi-PROCESS distributed path: 2 JAX processes on CPU, real collectives.

This is the closest single-machine analogue to the reference's Vagrant-VM
MPI testing (README.md:19): separate OS processes, a real coordinator, a
real psum across process boundaries.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + os.environ.get("MSM_TEST_DEVCOUNT", "4"))
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.parallel.distributed import count_pcap_distributed

ref = sys.argv[4]
m = Matcher(load_patterns(ref + "/strings.txt"))
res = count_pcap_distributed(m, ref + "/udp_1000.pcap", "udp", engine=sys.argv[6])
if int(sys.argv[3]) == 0:
    with open(sys.argv[5], "w") as f:
        json.dump({"counts": res.counts.tolist(),
                   "local_packets": res.local_packets}, f)
"""


FAIL_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.parallel.distributed import count_pcap_distributed

m = Matcher(load_patterns(sys.argv[4] + "/strings.txt"))
# Rank 1 gets a nonexistent pcap: BOTH ranks must abort cleanly (no hang),
# the mpi_dumping.c:137-142 flag-broadcast behavior.
path = sys.argv[4] + "/udp_1000.pcap" if sys.argv[3] == "0" else "/nonexistent.pcap"
try:
    count_pcap_distributed(m, path, "udp")
except RuntimeError as e:
    assert "at least one host" in str(e)
    sys.exit(42)
sys.exit(1)  # should not get here
"""


STREAM_WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.parallel.distributed import (
    count_pcap_streamed_distributed,
)

ref = sys.argv[4]
m = Matcher(load_patterns(ref + "/strings.txt"))
stats = {}
res = count_pcap_streamed_distributed(
    m, ref + "/udp_1000.pcap", "udp", batch_packets=100, tile_rows=64,
    stats=stats, host_workers=int(sys.argv[6]) if len(sys.argv) > 6 else 0,
)
if int(sys.argv[3]) == 0:
    with open(sys.argv[5], "w") as f:
        json.dump({"counts": res.counts.tolist(),
                   "local_packets": res.local_packets,
                   "stats": stats}, f)
"""


DEATH_WORKER = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
    heartbeat_timeout_seconds=10,
)
if sys.argv[3] == "1":
    os._exit(0)  # simulated mid-run crash (preemption/OOM-kill analogue)
from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.parallel.distributed import count_pcap_distributed

m = Matcher(load_patterns(sys.argv[4] + "/strings.txt"))
count_pcap_distributed(m, sys.argv[4] + "/udp_1000.pcap", "udp", engine="window")
print("SURVIVOR FINISHED", flush=True)  # must never be reached
"""


def _spawn_ranks(script, coord, n, extra, env, tail=()):
    return [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(n), str(i), *extra,
             *tail],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(n)
    ]


def test_four_process_distributed(reference_dir, tmp_path):
    """Four processes, ONE device each — a real (non-degenerate) collective
    topology, the closest this box gets to the reference's multi-VM MPI runs
    (/root/reference/README.md:19).  Counts equal the oracle; each rank
    ingested only its quarter."""
    out = tmp_path / "counts.json"
    script = tmp_path / "worker4.py"
    script.write_text(WORKER)
    port = 24865 + os.getpid() % 2000
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    env["MSM_TEST_DEVCOUNT"] = "1"
    procs = _spawn_ranks(
        script, f"localhost:{port}", 4,
        [str(reference_dir), str(out), "window"], env,
    )
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    import json

    import oracle

    from multithreading_string_matching import load_patterns

    data = json.loads(out.read_text())
    pats = load_patterns(reference_dir / "strings.txt")
    want = oracle.oracle_pcap_counts(reference_dir / "udp_1000.pcap", pats, "udp")
    assert data["counts"] == list(want)
    assert data["local_packets"] == 250  # rank 0's quarter


def test_rank_death_aborts_survivors(reference_dir, tmp_path):
    """Kill one rank after init: the surviving ranks must terminate with the
    coordination-service failure within the heartbeat window — NOT hang in
    the collective (the failure-detection half of the mpi_dumping story the
    error-flag test can't cover).  JAX surfaces peer death as a fatal
    process abort, so the pin is: nonzero exit, unhealthy-task diagnostics
    on stderr, completion well inside the subprocess timeout."""
    script = tmp_path / "death_worker.py"
    script.write_text(DEATH_WORKER)
    port = 25865 + os.getpid() % 2000
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    procs = _spawn_ranks(
        script, f"localhost:{port}", 4, [str(reference_dir)], env,
    )
    outs = [p.communicate(timeout=180) for p in procs]  # hang -> TimeoutExpired
    (so1, _) = outs[1]
    assert procs[1].returncode == 0  # the victim exits quietly
    for i in (0, 2, 3):
        p, (so, se) = procs[i], outs[i]
        assert p.returncode != 0, f"rank {i} finished despite peer death"
        assert b"SURVIVOR FINISHED" not in so
        text = se.decode()
        assert ("stopped sending heartbeats" in text
                or "detected fatal errors" in text), text[-2000:]


@pytest.mark.parametrize("host_workers", [0, 2])
def test_two_process_streamed_distributed(reference_dir, tmp_path, host_workers):
    """Streamed multi-host serving: round-robin chunks, local tiles, ONE
    end merge — counts equal the oracle, each rank streamed only its half.
    host_workers=2 runs each rank's ingest/extract on its own threads
    (ordering and the chunk→rank assignment must survive)."""
    out = tmp_path / "counts.json"
    script = tmp_path / "stream_worker.py"
    script.write_text(STREAM_WORKER)
    port = 23765 + os.getpid() % 2000 + host_workers
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, "2", str(i),
             str(reference_dir), str(out), str(host_workers)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    import json

    import oracle

    from multithreading_string_matching import load_patterns

    data = json.loads(out.read_text())
    pats = load_patterns(reference_dir / "strings.txt")
    want = oracle.oracle_pcap_counts(reference_dir / "udp_1000.pcap", pats, "udp")
    assert data["counts"] == list(want)
    # 10 chunks of 100 round-robin over 2 ranks -> 500 packets each;
    # stats are merged with the counts, so they describe the WHOLE capture.
    assert data["local_packets"] == 500
    assert data["stats"]["packets"] == 1000
    assert data["stats"]["engine_resolved"] in ("window", "ac")


def test_streamed_distributed_single_process(reference_dir):
    """Single-process degenerate case: equals the one-shot scan and the
    local streamed scan, for both packed (NUL-free) and per-chunk (NUL)
    modes."""
    from multithreading_string_matching import (
        Matcher,
        extract_payloads,
        load_patterns,
        read_pcap,
    )
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_streamed_distributed,
    )

    pats = load_patterns(reference_dir / "strings.txt")
    m = Matcher(pats, engine="window")
    batch = extract_payloads(read_pcap(reference_dir / "udp_1000.pcap"), "udp")
    want = m.count_batch(batch)
    stats = {}
    res = count_pcap_streamed_distributed(
        m, reference_dir / "udp_1000.pcap", "udp",
        batch_packets=130, tile_rows=64, stats=stats,
    )
    assert res.counts.tolist() == want.tolist()
    assert res.local_packets == 1000 == stats["packets"]
    assert stats["payload_bytes"] == batch.total_payload_bytes

    nul = Matcher([b"ab\x00c", b"http"], engine="window")
    res2 = count_pcap_streamed_distributed(
        nul, reference_dir / "udp.pcap", "udp", batch_packets=7
    )
    want2 = nul.count_batch(
        extract_payloads(read_pcap(reference_dir / "udp.pcap"), "udp")
    )
    assert res2.counts.tolist() == want2.tolist()

    # Threaded host stages: same counts, same stats (CLI --host-workers
    # composes with --distributed --stream).
    stats_w = {}
    res_w = count_pcap_streamed_distributed(
        m, reference_dir / "udp_1000.pcap", "udp",
        batch_packets=130, tile_rows=64, stats=stats_w, host_workers=2,
    )
    assert res_w.counts.tolist() == want.tolist()
    assert stats_w["packets"] == 1000


def test_streamed_distributed_missing_file_single(reference_dir):
    from multithreading_string_matching import Matcher
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_streamed_distributed,
    )

    m = Matcher([b"x"], engine="window")
    with pytest.raises((FileNotFoundError, OSError)):
        count_pcap_streamed_distributed(m, "/nonexistent.pcap", "udp")


def test_allgather_int64_halves_roundtrip():
    """The uint32 (lo, hi) split used for the exact int64 merge reassembles
    values past 2^31 (jnp would silently downcast int64 without x64)."""
    from multithreading_string_matching.parallel.distributed import (
        _allgather_int64,
    )

    vals = np.array([0, 1, 2**31 + 7, 2**40 + 123456789], dtype=np.int64)
    # Single process: allgather returns this process's halves only.
    assert _allgather_int64(vals).tolist() == vals.tolist()


def test_two_process_ingest_failure_aborts_all(reference_dir, tmp_path):
    """One host's pcap open fails -> every host raises cleanly instead of
    deadlocking in a later collective (mpi_dumping.c error-flag analogue)."""
    script = tmp_path / "fail_worker.py"
    script.write_text(FAIL_WORKER)
    port = 21765 + os.getpid() % 2000
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, "2", str(i), str(reference_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 42, se.decode()[-2000:]


@pytest.mark.parametrize("engine", ["window", "ac", "pallas"])
def test_two_process_distributed(reference_dir, tmp_path, engine):
    out = tmp_path / "counts.json"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = 19765 + (
        os.getpid() + {"window": 0, "ac": 1, "pallas": 2}[engine]
    ) % 2000
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, "2", str(i),
             str(reference_dir), str(out), engine],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    import json

    data = json.loads(out.read_text())
    # Conformance: same counts as the single-device oracle-checked totals.
    import oracle

    from multithreading_string_matching import load_patterns

    pats = load_patterns(reference_dir / "strings.txt")
    want = oracle.oracle_pcap_counts(reference_dir / "udp_1000.pcap", pats, "udp")
    assert data["counts"] == list(want)
    assert data["local_packets"] == 500  # this rank's shard, not the whole file


def test_distributed_empty_capture(tmp_path):
    """A header-only capture must return zero counts, not crash on sharding
    (extract_payloads emits one padded row even for zero packets)."""
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.pcap import classic_global_header
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_distributed,
    )

    src = tmp_path / "empty.pcap"
    src.write_bytes(classic_global_header())
    m = Matcher([b"http", b"xml"], engine="window")
    res = count_pcap_distributed(m, src, "udp")
    assert res.counts.tolist() == [0, 0]
    assert res.local_packets == 0


def test_distributed_rejects_unknown_engine(tmp_path, reference_dir):
    import pytest

    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_distributed,
    )

    m = Matcher([b"http"], engine="window")
    with pytest.raises(ValueError, match="engine"):
        count_pcap_distributed(
            m, reference_dir / "udp.pcap", "udp", engine="kmp"
        )


@pytest.mark.parametrize("engine", ["window", "ac", "pallas"])
def test_distributed_folds_case_insensitive(tmp_path, engine):
    """Case-insensitive matchers must fold payload bytes before staging on
    the distributed path too (the automata/kernels bake folded patterns;
    unfolded payloads silently undercount)."""
    import jax

    from multithreading_string_matching import Matcher
    from multithreading_string_matching.io.synth import synth_udp_pcap
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_distributed,
    )
    from multithreading_string_matching.parallel.mesh import make_mesh

    p = tmp_path / "case.pcap"
    synth_udp_pcap(
        p, 32, payload_len=64, patterns=[b"HTTP", b"Linux"],
        plant_rate=0.5, seed=3,
    )
    m = Matcher([b"http", b"lInUx"], case_insensitive=True)
    mesh = make_mesh(jax.devices("cpu")[:4])
    res = count_pcap_distributed(m, p, "udp", engine=engine, mesh=mesh)
    want = m.count_pcap(p, "udp")
    assert res.counts.tolist() == list(np.asarray(want))
    assert int(res.counts.sum()) > 0  # the planted uppercase DID match


@pytest.mark.parametrize("engine", ["pallas", "ac"])
def test_distributed_pallas_single_process(synth_udp, engine):
    """The distributed entry (single-process degenerate case over the
    8-device CPU mesh): counts bit-identical to the one-shot scan, through
    the window engine 'pallas' resolves to and through the AC engine."""
    import jax

    from multithreading_string_matching import (
        Matcher,
        extract_payloads,
        read_pcap,
    )
    from multithreading_string_matching.parallel.distributed import (
        count_pcap_distributed,
    )
    from multithreading_string_matching.parallel.mesh import make_mesh

    path, pats = synth_udp
    m = Matcher(pats)
    mesh = make_mesh(jax.devices("cpu")[:8])
    res = count_pcap_distributed(m, path, "udp", engine=engine, mesh=mesh)
    want = m.count_batch(
        extract_payloads(read_pcap(path), "udp"), engine="window",
    )
    assert res.counts.tolist() == want.tolist()
    assert int(res.counts.sum()) > 0
