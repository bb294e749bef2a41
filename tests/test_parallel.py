"""Mesh sharding, pipeline, and streaming vs the one-shot scan.

The reference's correctness story for its parallel variants is "same printed
counts as serial" (SURVEY §4); these tests are that, executed on the 8-device
CPU mesh (the Vagrant-VM analogue, README.md:19).
"""

import numpy as np
import pytest
import jax

from multithreading_string_matching import (
    Matcher,
    extract_payloads,
    read_pcap,
)
from multithreading_string_matching.parallel.mesh import (
    count_matches_sharded,
    make_mesh,
    shard_batch,
)
from multithreading_string_matching.parallel.pipeline import (
    count_pcap_pipelined,
    iter_batches,
)
from multithreading_string_matching.parallel.stream import StreamMatcher
from multithreading_string_matching.io.live import FileReplaySource


@pytest.fixture(scope="module")
def matcher():
    """A seeded 97-entry rule-file-shaped set (2-12 B, duplicates kept)."""
    from multithreading_string_matching.io.synth import synth_patterns

    return Matcher(synth_patterns(96, seed=1) + [b"http"])


@pytest.fixture(scope="module")
def udp1000(tmp_path_factory, matcher):
    """A seeded 1000-packet UDP capture with the set planted in it."""
    from multithreading_string_matching.io.synth import synth_udp_pcap

    path = tmp_path_factory.mktemp("udp1000") / "udp_1000.pcap"
    synth_udp_pcap(path, 1000, payload_len=256, payload_len_jitter=192,
                   patterns=matcher.patterns, plant_rate=0.5, seed=1000)
    batch = extract_payloads(read_pcap(path), "udp")
    counts = matcher.count_batch(batch)
    assert int(counts.sum()) > 0
    return batch, counts


def test_sharded_equals_single(reference_dir, matcher, udp1000):
    batch, want = udp1000
    for ndev in (1, 2, 8):
        mesh = make_mesh(jax.devices("cpu")[:ndev])
        got = count_matches_sharded(
            matcher.cac, batch.payloads, batch.lengths, mesh,
            dup_map=matcher.ac.dup_map,
        )
        assert (got == want).all(), f"ndev={ndev}"


def test_sharded_pallas_table_build_order():
    """Per-shard counts come back in BUILD order under shard_map for a
    mixed-length set, window and AC engines alike."""
    # Mixed word counts (1..3 words) in deliberately non-sorted order, with
    # distinct per-pattern counts so any permutation is visible.
    patterns = [b"abcdefghi", b"xy", b"abcd", b"hello", b"zq"]
    m = Matcher(patterns)
    rng = np.random.default_rng(7)
    payloads = rng.integers(1, 255, size=(64, 128)).astype(np.uint8)
    for i, p in enumerate(patterns):
        for j in range(i + 1):  # pattern i appears in i+1 rows
            payloads[(3 * i + 5 * j) % 64, 8 * i : 8 * i + len(p)] = (
                np.frombuffer(p, np.uint8)
            )
    lengths = np.full(64, 128, np.int32)
    cols = np.arange(128)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    want = m.count(payloads, lengths, engine="window", bucketed=False)
    assert (want >= np.arange(1, 6)).all()
    for ndev in (2, 8):
        mesh = make_mesh(jax.devices("cpu")[:ndev])
        for engine, dup in (("window", m.window.dup_map),
                            ("ac", m.ac.dup_map)):
            got = count_matches_sharded(
                m.cac, payloads, lengths, mesh, dup_map=dup, engine=engine,
                window=m.window,
            )
            assert (got == want).all(), f"{engine} ndev={ndev}: {got}"


def test_count_rows_sharded_equals_per_packet(matcher, udp1000):
    """Row-sharded per-packet attribution: counts stay with their rows (no
    collective) and equal the single-device per-packet matrix."""
    from multithreading_string_matching.parallel.mesh import (
        count_rows_sharded,
    )

    batch, _ = udp1000
    want = np.asarray(
        matcher.count(batch.payloads, batch.lengths, per_packet=True,
                      engine="window", bucketed=False)
    )
    for ndev in (2, 8):
        mesh = make_mesh(jax.devices("cpu")[:ndev])
        got = count_rows_sharded(matcher, batch.payloads, batch.lengths, mesh)
        assert (got == want).all(), f"window ndev={ndev}"


def test_count_rows_summary_matches_matrix(matcher, udp1000):
    """The device-side attribution summary (unique totals + row-hit flags)
    must equal the reductions of the full per-packet matrix, across mesh
    sizes."""
    from multithreading_string_matching.parallel.mesh import (
        count_rows_summary,
    )

    batch, _ = udp1000
    per_row = np.asarray(
        matcher.count(batch.payloads, batch.lengths, per_packet=True,
                      engine="window", bucketed=False)
    )  # [N, P] expanded over the original pattern list
    dup = matcher.window.dup_map
    want_tot_exp = per_row.sum(axis=0).astype(np.int64)
    want_hits = per_row.sum(axis=1) > 0
    for ndev in (2, 8):
        mesh = make_mesh(jax.devices("cpu")[:ndev])
        tot, hits = count_rows_summary(
            matcher, batch.payloads, batch.lengths, mesh
        )
        assert tot.dtype == np.int64
        assert (tot[dup] == want_tot_exp).all(), f"window ndev={ndev}"
        assert (hits == want_hits).all(), f"window ndev={ndev}"


def test_count_rows_summary_slices_big_feeds(matcher, udp1000, monkeypatch):
    """Feeds that could wrap the device int32 totals are sliced internally
    (int64 host accumulation across slices) — results identical to the
    one-dispatch path."""
    from multithreading_string_matching.parallel import mesh as mesh_mod

    batch, _ = udp1000
    mesh = make_mesh(jax.devices("cpu")[:2])
    want_tot, want_hits = mesh_mod.count_rows_summary(
        matcher, batch.payloads, batch.lengths, mesh
    )
    # Force ~4 slices: bound just above 2 mesh-divisible rows' positions.
    monkeypatch.setattr(
        mesh_mod, "SUMMARY_MAX_POSITIONS",
        batch.payloads.shape[1] * 100,
    )
    tot, hits = mesh_mod.count_rows_summary(
        matcher, batch.payloads, batch.lengths, mesh
    )
    assert (tot == want_tot).all()
    assert (hits == want_hits).all()


def test_stream_checkpoint_restores_int64_exact(matcher, tmp_path):
    """Resuming from a checkpoint whose counts exceed int32 must not wrap:
    load() lands in the host int64 base, not a device int32 array."""
    big = np.zeros(len(matcher.patterns), dtype=np.int64)
    big[0] = np.int64(2**31) + 123
    s = StreamMatcher(matcher, packed=False)
    s._host_counts = big.copy()
    s.packets_seen = 7
    path = s.save(tmp_path / "ckpt")
    s2 = StreamMatcher(matcher, packed=False)
    s2.load(path)
    got = s2.counts()
    assert got.dtype == np.int64 and got[0] == big[0]
    assert s2.packets_seen == 7


def test_stream_engine_typo_raises(matcher):
    """StreamMatcher validates its engine like Matcher._resolve_engine — a
    typo must not silently run the window path."""
    with pytest.raises(ValueError, match="unknown stream engine"):
        StreamMatcher(matcher, engine="AC")


def test_packed_counter_oversized_totals_are_int64(matcher):
    """Oversized-row (can't-pack) counts accumulate host-side in int64 from
    the first feed — int32 across many feeds could wrap silently."""
    from multithreading_string_matching.parallel.pipeline import (
        PackedTileCounter,
    )

    c = PackedTileCounter(matcher, pack_width=128)
    big = np.zeros((1, 256), np.uint8)
    big[0, :4] = np.frombuffer(b"http", np.uint8)
    c.add(big, np.array([256]))
    assert c._over_total.dtype == np.int64
    assert c.totals()[list(matcher.patterns).index(b"http")] == 1


def test_sigint_stops_a_quiet_source(matcher):
    """The SIGINT handler must stop the SOURCE too: a blocking capture loop
    on a quiet interface never yields a batch, so the between-batches
    stopped check alone would hang the process on Ctrl-C."""
    import os
    import signal

    class FakeSource:
        stopped = False

        def stop(self):
            self.stopped = True

    src = FakeSource()
    s = StreamMatcher(matcher)
    s.install_sigint(on_stop=src.stop)
    try:
        os.kill(os.getpid(), signal.SIGINT)
        # Delivered synchronously to this (main) thread at the next check.
        assert s.stopped and src.stopped
    finally:
        s.uninstall_sigint()


def test_stream_load_replaces_all_accumulators(matcher, reference_dir, tmp_path):
    """load() is a ROLLBACK: restoring a checkpoint onto a used packed
    StreamMatcher must not add the tile accumulators (already included in
    the checkpoint) on top of the restored counts."""
    from multithreading_string_matching.io.pcap import read_pcap, slice_pcap

    pcap = read_pcap(reference_dir / "udp.pcap")
    s = StreamMatcher(matcher)  # packed='auto' -> tiles on this pattern set
    s.feed_pcap_slice(pcap, "udp")
    at_save = s.counts().copy()
    path = s.save(tmp_path / "roll")
    s.feed_pcap_slice(pcap, "udp")  # post-save work to roll back
    assert int(np.asarray(s.counts()).sum()) == 2 * at_save.sum()
    s.load(path)
    assert (np.asarray(s.counts()) == at_save).all()
    assert s.packets_seen == pcap.num_packets


def test_feed_pcap_slice_empty_with_bpf(matcher, reference_dir):
    """An empty pcap slice through the kernel-filter path is a no-op (the
    padded placeholder row must neither crash the mask nor count as a
    sniffed packet)."""
    from multithreading_string_matching.io.pcap import read_pcap, slice_pcap

    pcap = read_pcap(reference_dir / "udp.pcap")
    empty = slice_pcap(pcap, 0, 0)
    for bpf in (False, True):
        s = StreamMatcher(matcher)
        s.feed_pcap_slice(empty, "udp", bpf_filter=bpf)
        assert s.packets_seen == 0
        assert int(np.asarray(s.counts()).sum()) == 0


def test_shard_batch_pads_to_divisible():
    mesh = make_mesh(jax.devices("cpu")[:8])
    p = np.ones((13, 16), np.uint8)
    l = np.full(13, 16, np.int32)
    p2, l2 = shard_batch(p, l, mesh)
    assert p2.shape[0] % 8 == 0
    assert l2[13:].sum() == 0  # padding rows are length-0


def test_pipeline_equals_oneshot(reference_dir, matcher, udp1000):
    _, want = udp1000
    got = count_pcap_pipelined(matcher, reference_dir / "udp_1000.pcap", "udp")
    assert (got == want).all()
    # non-default batch size exercises the short-final-batch path
    got37 = count_pcap_pipelined(
        matcher, reference_dir / "udp_1000.pcap", "udp", batch_size=37
    )
    assert (got37 == want).all()


def test_iter_batches_shapes(reference_dir):
    pcap = read_pcap(reference_dir / "udp.pcap")
    batches = list(iter_batches(pcap, "udp", batch_size=8))
    assert len(batches) == 3  # 20 packets / 8
    for p, l in batches:
        assert p.shape[0] == 8
        assert p.shape[1] % 2 == 0


def test_stream_packed_tiles_amortize_dispatch(reference_dir, matcher, udp1000):
    """Live at kernel rate: the default StreamMatcher packs
    feeds into fixed tiles, so dispatches scale with TILES, not the 100
    10-packet batches — and counts stay bit-identical to offline."""
    _, want = udp1000
    stream = StreamMatcher(matcher, batch_size=10, tile_rows=256)
    assert stream._tiles is not None  # NUL-free set: auto-packed
    n_batches = 0
    for part in FileReplaySource(reference_dir / "udp_1000.pcap", batch_size=10):
        stream.feed_pcap_slice(part, "udp")
        n_batches += 1
    assert n_batches == 100
    assert (stream.counts() == want).all()  # flushes the partial tile
    assert stream.packets_seen == 1000
    assert 1 <= stream.tiles_dispatched < 10 < n_batches


def test_stream_packed_guards_and_fallback():
    """packed=True demands NUL-free patterns; 'auto' quietly falls back to
    the per-batch path for NUL sets (counts unchanged)."""
    nul = Matcher([b"a\x00b", b"zz"], engine="window")
    with pytest.raises(ValueError, match="NUL-free"):
        StreamMatcher(nul, packed=True)
    s = StreamMatcher(nul)
    assert s._tiles is None
    pay = np.zeros((2, 16), np.uint8)
    pay[0, 3:6] = np.frombuffer(b"a\x00b", np.uint8)
    pay[1, 0:2] = np.frombuffer(b"zz", np.uint8)
    lens = np.array([16, 8], np.int32)
    s.feed_batch(pay, lens)
    assert (s.counts() == nul.count(pay, lens)).all()


def test_stream_packed_oversized_payload(matcher):
    """Rows wider than pack_width detour through the bucketed one-shot
    engine inside the tile counter; totals still exact."""
    s = StreamMatcher(matcher, pack_width=128, tile_rows=64)
    assert s._tiles is not None
    rng = np.random.default_rng(7)
    pay = rng.integers(0, 256, size=(5, 400)).astype(np.uint8)
    pay[1, 200:204] = np.frombuffer(b"http", np.uint8)
    pay[4, 10:13] = np.frombuffer(b"rpc", np.uint8)
    lens = np.array([400, 400, 50, 0, 40], np.int32)
    want = matcher.count(pay, lens)
    s.feed_batch(pay, lens)
    assert (s.counts() == want).all()


def test_stream_packed_checkpoint_resume(reference_dir, matcher, udp1000):
    """Checkpoint mid-tile: save() flushes via counts(), a fresh stream
    resumes from the .npz and finishes with exact totals."""
    import tempfile, os

    _, want = udp1000
    batches = list(FileReplaySource(reference_dir / "udp_1000.pcap", batch_size=50))
    s1 = StreamMatcher(matcher, tile_rows=256)
    for b in batches[:10]:
        s1.feed_pcap_slice(b, "udp")
    with tempfile.TemporaryDirectory() as d:
        ck = s1.save(os.path.join(d, "ck"))
        s2 = StreamMatcher(matcher, tile_rows=256)
        s2.load(ck)
        for b in batches[10:]:
            s2.feed_pcap_slice(b, "udp")
        assert (s2.counts() == want).all()
        assert s2.packets_seen == 1000


def test_stream_packed_sharded_mesh(reference_dir, matcher, udp1000):
    """Live streaming on a multi-chip host: packed tiles shard over the
    mesh; counts bit-identical to offline.  sharded without packed raises."""
    _, want = udp1000
    mesh = make_mesh(jax.devices("cpu")[:8])
    stream = StreamMatcher(matcher, tile_rows=256, sharded=True, mesh=mesh)
    for part in FileReplaySource(reference_dir / "udp_1000.pcap", batch_size=25):
        stream.feed_pcap_slice(part, "udp")
    assert (stream.counts() == want).all()
    assert stream.packets_seen == 1000

    with pytest.raises(ValueError, match="packed"):
        StreamMatcher(matcher, packed=False, sharded=True)
    with pytest.raises(ValueError, match="mesh"):
        StreamMatcher(matcher, mesh=mesh)  # mesh without sharded


def test_stream_matches_oneshot(reference_dir, matcher, udp1000):
    _, want = udp1000
    stream = StreamMatcher(matcher, batch_size=10)
    for part in FileReplaySource(reference_dir / "udp_1000.pcap", batch_size=10):
        stream.feed_pcap_slice(part, "udp")
    assert stream.packets_seen == 1000
    assert (stream.counts() == want).all()


def test_stream_long_payload_chunked(matcher):
    """A payload longer than the stream window goes through the carried-state
    chunk path; straddling matches must count once."""
    stream = StreamMatcher(matcher, fixed_len=64, packed=False)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, size=(1, 300)).astype(np.uint8)
    payload[0, 60:64] = np.frombuffer(b"http", np.uint8)  # straddles 64-edge
    lengths = np.array([300], np.int32)
    stream.feed_batch(payload, lengths)
    want = matcher.count(payload, lengths)
    assert (stream.counts() == want).all()


def test_stream_sigint_flag(matcher):
    import os, signal

    stream = StreamMatcher(matcher)
    stream.install_sigint()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert stream.stopped
    finally:
        stream.uninstall_sigint()
