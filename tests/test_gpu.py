"""The engines as compiled for an NVIDIA GPU.

Marked ``gpu``: they skip unless JAX's device is a GPU.  Run them on the card
with ``MSM_TEST_GPU=1 python -m pytest -m gpu tests/`` (conftest.py pins the
CPU otherwise).
"""

import numpy as np
import pytest

import oracle

pytestmark = pytest.mark.gpu


def test_default_matcher_runs_the_window_engine(gpu, synth_udp):
    from multithreading_string_matching import Matcher
    from multithreading_string_matching.api import select_engine

    path, pats = synth_udp
    m = Matcher(pats)
    ex = m.explain()
    assert (ex["platform"], ex["engine_resolved"]) == ("gpu", "window")
    assert select_engine("pallas", gpu.platform) == "window"
    want = oracle.oracle_pcap_counts(path, pats)
    assert m.count_pcap(path).tolist() == want
    assert m.count_pcap(path, engine="ac").tolist() == want
    assert m.count_pcap(path, engine="kmp").tolist() == want


@pytest.mark.parametrize("engine", ["window", "ac"])
def test_counts_past_float_precision_are_exact(gpu, engine):
    """Totals past 2**24 and per-row counts past 2**11: a float32 (or TF32)
    contraction would round them; the engines' int32 paths must not."""
    from multithreading_string_matching import Matcher

    n, w = 4097, 4099
    payloads = np.full((n, w), ord("a"), np.uint8)
    lengths = np.full(n, w, np.int32)
    m = Matcher([b"a", b"aa", b"a"], engine=engine, bucketed=False)
    want = np.array([n * w, n * (w - 1), n * w])
    assert n * w > 2**24 and n * w % 2 == 1
    assert m.count(payloads, lengths).tolist() == want.tolist()
    rows = m.count(payloads[:64], lengths[:64], per_packet=True)
    assert (np.asarray(rows) == [w, w - 1, w]).all()


def test_flow_monitor_streams_through_the_window_engine(gpu, tmp_path):
    from multithreading_string_matching import Matcher
    from multithreading_string_matching.io.flows import extract_flows
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.synth import (
        synth_patterns,
        synth_tcp_flows_pcap,
    )
    from multithreading_string_matching.parallel.flow_stream import (
        FlowStreamMatcher,
    )

    pats = synth_patterns(24, max_len=9, seed=7)
    rng = np.random.default_rng(7)
    flows = []
    for i in range(24):
        body = rng.integers(0, 256, int(rng.integers(200, 3000)), np.uint8)
        for p in pats[i % 5:: 5]:
            off = int(rng.integers(0, body.size - len(p)))
            body[off: off + len(p)] = np.frombuffer(p, np.uint8)
        flows.append(((f"10.0.{i}.1", "10.9.9.9", 2000 + i, 80), body.tobytes()))
    path = tmp_path / "flows.pcap"
    synth_tcp_flows_pcap(path, flows, segment_len=300, interleave_seed=7,
                         reorder_seed=7, retransmit_rate=0.1, seed=7)
    pcap = read_pcap(path)
    fb = extract_flows(pcap, "tcp", reorder=True)
    want = oracle.oracle_counts([fb.stream(f) for f in range(fb.num_flows)], pats)

    m = Matcher(pats)
    assert m.flow_stream_engine() == "window"
    fs = FlowStreamMatcher(m, "tcp", engine=m.flow_stream_engine(),
                           reorder=True, scan_bytes=1 << 14)
    fs.feed_pcap_slice(pcap)
    fs.flush()
    assert fs.counts().tolist() == want
