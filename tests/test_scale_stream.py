"""Streamed conformance at scale (VERDICT r1 next-round #8).

The README/DESIGN throughput claims rest on bench scripts; this pins the
CORRECTNESS of the serving paths at a bench-like shape: a ~100 MB synthetic
corpus, the full strings.txt pattern set, packed streaming (sharded and
unsharded) vs the one-shot scan, with a sampled pure-Python oracle anchor
(the full oracle over 100 MB would take minutes — the one-shot engine is
itself oracle-pinned on every bundled fixture in test_conformance.py).
"""

import numpy as np
import pytest
import jax

from multithreading_string_matching import (
    Matcher,
    extract_payloads,
    load_patterns,
    read_pcap,
)
from multithreading_string_matching.io.synth import synth_udp_pcap
from multithreading_string_matching.parallel.mesh import make_mesh
from multithreading_string_matching.parallel.pipeline import (
    count_pcap_streamed,
)

from oracle import oracle_counts

NUM_PACKETS = 100_000  # ~100 MB at 1 KB +/- 256 B payloads


@pytest.fixture(scope="module")
def scale_corpus(tmp_path_factory, strings_path):
    pats = load_patterns(strings_path)
    path = tmp_path_factory.mktemp("scale") / "scale_100mb.pcap"
    total = synth_udp_pcap(
        path, NUM_PACKETS, payload_len=1024, payload_len_jitter=256,
        patterns=pats, plant_rate=0.05, invalid_rate=0.01, seed=9,
    )
    assert total > 90_000_000  # really ~100 MB of payload
    return path, pats


@pytest.mark.slow
def test_scale_streamed_conformance(scale_corpus):
    path, pats = scale_corpus
    m = Matcher(pats, engine="window")
    batch = extract_payloads(read_pcap(path), "udp")

    want = m.count(batch.payloads, batch.lengths)
    assert int(want.sum()) > NUM_PACKETS * 0.04  # the plants were found

    # Oracle anchor on a random packet sample: ground truth from bytes.find,
    # not from any engine.
    rng = np.random.default_rng(3)
    sample = rng.choice(batch.num_payloads, size=512, replace=False)
    sample_payloads = [
        batch.payloads[i, : batch.lengths[i]].tobytes() for i in sample
    ]
    want_sample = oracle_counts(sample_payloads, m.patterns)
    got_sample = m.count(batch.payloads[sample], batch.lengths[sample])
    assert got_sample.tolist() == want_sample

    stats = {}
    got = count_pcap_streamed(m, path, "udp", stats=stats)
    assert got.tolist() == want.tolist()
    assert stats["packets"] == NUM_PACKETS
    assert stats["payload_bytes"] == batch.total_payload_bytes

    mesh = make_mesh(jax.devices("cpu")[:8])
    got_sharded = count_pcap_streamed(m, path, "udp", sharded=True, mesh=mesh)
    assert got_sharded.tolist() == want.tolist()
