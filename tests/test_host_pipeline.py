"""Host-side pipeline parallelism (parallel/host.py): the producer/worker
thread split of the reference's task program (openmp_task.c:126-186) applied
to the host stages.  Results must be IDENTICAL to the sequential schedule —
ordering is load-bearing for attribution — and the combinators must
propagate errors and never hang when the consumer leaves early.
"""

import os
import threading
import time

import numpy as np
import pytest

from multithreading_string_matching import Matcher, load_patterns
from multithreading_string_matching.parallel.host import (
    map_prefetch,
    prefetch_iter,
)
from multithreading_string_matching.parallel.pipeline import (
    count_pcap_streamed,
    scan_pcap_streamed,
)


def test_prefetch_iter_order_and_completeness():
    assert list(prefetch_iter(iter(range(100)), depth=3)) == list(range(100))
    assert list(prefetch_iter(iter([]), depth=1)) == []


def test_prefetch_iter_source_exception_propagates():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("source died")

    it = prefetch_iter(bad(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


def test_prefetch_iter_early_close_stops_producer():
    produced = []
    done = threading.Event()

    def src():
        try:
            for i in range(10_000):
                produced.append(i)
                yield i
        finally:
            done.set()

    it = prefetch_iter(src(), depth=2)
    assert next(it) == 0
    it.close()  # consumer leaves; producer must unblock and exit
    assert done.wait(timeout=5), "producer thread did not stop"
    assert len(produced) < 100  # bounded lookahead, not a full drain


def test_map_prefetch_ordered_results():
    def slow_square(x):
        # Reverse the completion order: earlier items finish later.
        time.sleep((9 - x) * 0.003)
        return x * x

    got = list(map_prefetch(slow_square, iter(range(10)), workers=4))
    assert got == [x * x for x in range(10)]


def test_map_prefetch_fn_exception_in_source_order():
    def fn(x):
        if x == 3:
            raise ValueError("item 3 bad")
        return x

    it = map_prefetch(fn, iter(range(10)), workers=4)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="item 3 bad"):
        next(it)


def test_map_prefetch_source_exception_propagates():
    def bad():
        yield 1
        raise OSError("read failed")

    it = map_prefetch(lambda x: x, bad(), workers=2)
    assert next(it) == 1
    with pytest.raises(OSError, match="read failed"):
        next(it)


def test_map_prefetch_early_close_no_hang():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    it = map_prefetch(fn, iter(range(10_000)), workers=2, depth=3)
    assert next(it) == 0
    it.close()
    time.sleep(0.2)  # let any stragglers run
    assert len(calls) < 200  # bounded in-flight work, not a full drain


def test_map_prefetch_bounded_inflight():
    """The scheduler must not race ahead of the consumer unboundedly."""
    submitted = []

    def fn(x):
        submitted.append(x)
        return x

    it = map_prefetch(fn, iter(range(1000)), workers=2, depth=4)
    next(it)
    time.sleep(0.3)
    # depth futures queued + a couple in flight; far from 1000.
    assert len(submitted) <= 16, len(submitted)
    it.close()


def _consume_with_watchdog(gen, slow_first_s: float, timeout_s: float = 30.0):
    """Consume ``gen`` (sleeping ``slow_first_s`` after the first item) on a
    daemon thread; returns (items, exception).  A regression that drops the
    terminal sentinel makes the consumer block forever — the join timeout
    turns that hang into an assertion failure instead of a stuck suite."""
    out: dict = {}

    def run():
        items = []
        try:
            for x in gen:
                items.append(x)
                if len(items) == 1:
                    time.sleep(slow_first_s)
            out["items"] = items
        except BaseException as e:
            out["items"] = items
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    assert not t.is_alive(), "consumer hung: terminal sentinel was dropped"
    return out.get("items"), out.get("exc")


def test_prefetch_iter_error_survives_slow_consumer():
    """The source error must reach a consumer that was stalled long enough
    for the queue to be full when the source raised (the one-shot timeout
    put would have dropped it and hung the consumer forever)."""
    def bad():
        yield 1
        yield 2
        yield 3
        raise RuntimeError("late source error")

    items, exc = _consume_with_watchdog(
        prefetch_iter(bad(), depth=1), slow_first_s=1.6
    )
    assert items == [1, 2, 3]
    assert isinstance(exc, RuntimeError) and "late source error" in str(exc)


def test_map_prefetch_source_error_survives_slow_consumer():
    def bad():
        yield 1
        yield 2
        raise OSError("late read failure")

    items, exc = _consume_with_watchdog(
        map_prefetch(lambda x: x, bad(), workers=1, depth=1),
        slow_first_s=1.6,
    )
    assert items == [1, 2]
    assert isinstance(exc, OSError) and "late read failure" in str(exc)


def test_prefetch_iter_done_survives_slow_consumer():
    """Same rule for the DONE sentinel: a stalled consumer must still see
    the end of a finite source, not block forever."""
    items, exc = _consume_with_watchdog(
        prefetch_iter(iter(range(4)), depth=1), slow_first_s=1.6
    )
    assert items == [0, 1, 2, 3] and exc is None


@pytest.mark.skipif(
    bool(os.environ.get("MSM_NO_NATIVE")),
    reason="native path disabled by MSM_NO_NATIVE",
)
def test_native_stale_library_rebuilds_or_falls_back(tmp_path, monkeypatch):
    """A pre-existing .so missing a newer symbol (binary-only install,
    clock-skewed mtime) must trigger one rebuild — or a clean numpy
    fallback — never an AttributeError out of native.available()."""
    import subprocess

    from multithreading_string_matching.io import native

    stub = tmp_path / "stub.cpp"
    stub.write_text("extern \"C\" int msm_nothing() { return 0; }\n")
    old_so = tmp_path / "libstale.so"
    subprocess.run(
        ["g++", "-O0", "-shared", "-fPIC", "-o", str(old_so), str(stub)],
        check=True, capture_output=True,
    )
    # Point the module at the stale .so with a REAL source next to it; make
    # the .so look fresh so the mtime check does not rebuild preemptively.
    real_src = native._SRC
    import os as _os
    import shutil

    src_copy = tmp_path / "pcap_ingest.cpp"
    shutil.copyfile(real_src, src_copy)
    past = old_so.stat().st_mtime
    _os.utime(src_copy, (past - 100, past - 100))
    monkeypatch.setattr(native, "_SO", old_so)
    monkeypatch.setattr(native, "_SRC", src_copy)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lib = native.get_lib()  # must not raise
    assert lib is not None  # source available: rebuilt and rebound
    assert hasattr(lib, "msm_parse_stream")
    # And the module-level cache must not leak into other tests.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


@pytest.mark.parametrize("workers", [1, 3])
def test_streamed_counts_with_host_workers(reference_dir, workers):
    """count_pcap_streamed(host_workers=N) is bit-identical to sequential."""
    matcher = Matcher(load_patterns(reference_dir / "strings.txt"))
    path = reference_dir / "big_udp.pcap"
    seq = count_pcap_streamed(matcher, path, "udp", batch_packets=512)
    stats = {}
    par = count_pcap_streamed(
        matcher, path, "udp", batch_packets=512,
        host_workers=workers, stats=stats,
    )
    assert (np.asarray(seq) == np.asarray(par)).all()
    assert stats["packets"] == 3580  # stats accumulate across threads too


def test_streamed_attribution_with_host_workers(reference_dir, tmp_path):
    """Attribution (offsets + dump) is order-dependent: the threaded host
    pipeline must preserve ORIGINAL capture packet numbering exactly."""
    from multithreading_string_matching.io.pcap import read_pcap

    matcher = Matcher(load_patterns(reference_dir / "strings.txt"))
    path = reference_dir / "udp_1000.pcap"
    c_seq, off_seq = scan_pcap_streamed(
        matcher, path, "udp", offsets=True, batch_packets=64
    )
    dump = tmp_path / "hits.pcap"
    c_par, off_par = scan_pcap_streamed(
        matcher, path, "udp", offsets=True, batch_packets=64,
        host_workers=2, dump_path=dump,
    )
    assert (np.asarray(c_seq) == np.asarray(c_par)).all()
    assert off_seq.shape == off_par.shape
    assert (off_seq == off_par).all()
    assert read_pcap(dump).num_packets > 0


def test_streamed_host_workers_ingest_error_propagates(tmp_path):
    """A corrupt capture raises the same error through the threaded path."""
    bad = tmp_path / "bad.pcap"
    bad.write_bytes(b"\x00" * 64)
    matcher = Matcher([b"x"])
    with pytest.raises(ValueError, match="not a classic pcap"):
        count_pcap_streamed(matcher, bad, "udp", host_workers=2)


def test_cli_host_workers_requires_stream(reference_dir, capsys):
    from multithreading_string_matching.cli import main

    with pytest.raises(SystemExit, match="--host-workers requires --stream"):
        main([
            "match", "--pcap", str(reference_dir / "udp.pcap"),
            "--patterns", str(reference_dir / "strings.txt"),
            "--host-workers", "2",
        ])


def test_cli_stream_host_workers_counts(reference_dir, capsys):
    import json

    from multithreading_string_matching.cli import main

    rc = main([
        "match", "--pcap", str(reference_dir / "udp.pcap"),
        "--patterns", str(reference_dir / "strings.txt"),
        "--stream", "--host-workers", "2", "--json",
    ])
    assert rc == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39  # BASELINE.md variant A, udp.pcap
