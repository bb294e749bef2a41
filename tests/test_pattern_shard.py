"""Pattern-axis sharding: bit-identity vs the single-device scan at every
shard count, for small sets and for large ones (more than
PATTERN_AXIS_MIN_WORDS pattern words), 1-D and 2-D meshes,
totals/rows/summary shapes.

parallel/mesh.py shards only packets; these tests pin that sharding the PATTERN tables over
the mesh (each device scanning all packets with 1/N of the rule set, counts
merged by concatenation) changes nothing about the counts.
"""

import numpy as np
import pytest

import jax

from multithreading_string_matching import Matcher
from multithreading_string_matching.parallel.pattern_shard import (
    build_pattern_shards,
    choose_shard_axis,
    count_matches_pattern_sharded,
    count_rows_pattern_sharded,
    PATTERN_AXIS_MIN_WORDS,
    count_rows_summary_pattern_sharded,
    make_pattern_mesh,
    make_2d_mesh,
)


def _mk_batch(rng, n=48, L=256, alphabet=(0x61, 0x67)):
    payloads = rng.integers(*alphabet, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    cols = np.arange(L)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


def _mk_patterns(rng, count, lens=(2, 9), alphabet=(0x61, 0x67)):
    return [
        bytes(rng.integers(*alphabet, size=rng.integers(*lens)).tolist())
        for _ in range(count)
    ]


def _set_of_size(rng, size, count):
    """``count`` mixed-length patterns, or for ``size='large'`` 140 patterns
    of 13-16 bytes (4 words each: 560 words, past PATTERN_AXIS_MIN_WORDS)."""
    if size == "large":
        pats = _mk_patterns(rng, 140, lens=(13, 17))
        assert Matcher(pats)._pattern_stats()[2] > PATTERN_AXIS_MIN_WORDS
        return pats
    return _mk_patterns(rng, count)


# Every engine request runs the window engine here ('pallas' included);
# "large" sets are past PATTERN_AXIS_MIN_WORDS.
CASES = [("window", "small"), ("pallas", "small"), ("window", "large")]
IDS = ["window", "pallas", "large"]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("engine, size", CASES, ids=IDS)
def test_totals_bit_identical(n_shards, engine, size):
    rng = np.random.default_rng(50 + n_shards)
    pats = _set_of_size(rng, size, 37) + [b"aa", b"aa"]  # duplicates expand
    m = Matcher(pats)
    payloads, lengths = _mk_batch(rng)
    want = m.count(payloads, lengths, engine="window")
    mesh = make_pattern_mesh(jax.devices()[:n_shards])
    got = count_matches_pattern_sharded(
        m, payloads, lengths, mesh, engine=engine
    )
    assert (got == want).all()


@pytest.mark.parametrize("engine, size", CASES, ids=IDS)
def test_rows_bit_identical(engine, size):
    rng = np.random.default_rng(60)
    pats = _set_of_size(rng, size, 21)
    m = Matcher(pats)
    payloads, lengths = _mk_batch(rng, n=24, L=128)
    want = m.count(payloads, lengths, engine="window", per_packet=True)
    mesh = make_pattern_mesh(jax.devices()[:4])
    got = count_rows_pattern_sharded(m, payloads, lengths, mesh, engine=engine)
    assert (got == want).all()


@pytest.mark.parametrize("engine, size", CASES, ids=IDS)
def test_2d_mesh_composes(engine, size):
    """packets x patterns: both axes sharded at once, counts unchanged."""
    rng = np.random.default_rng(61)
    pats = _set_of_size(rng, size, 19)
    m = Matcher(pats)
    payloads, lengths = _mk_batch(rng, n=40, L=128)
    want = m.count(payloads, lengths, engine="window")
    want_rows = m.count(payloads, lengths, engine="window", per_packet=True)
    mesh = make_2d_mesh(2, 4)
    got = count_matches_pattern_sharded(
        m, payloads, lengths, mesh, engine=engine
    )
    assert (got == want).all()
    got_rows = count_rows_pattern_sharded(
        m, payloads, lengths, mesh, engine=engine
    )
    assert (got_rows == want_rows).all()


@pytest.mark.parametrize("engine, size", CASES, ids=IDS)
def test_summary_matches_rows(engine, size):
    rng = np.random.default_rng(62)
    pats = _set_of_size(rng, size, 23)
    m = Matcher(pats)
    payloads, lengths = _mk_batch(rng, n=32, L=128)
    rows = m.count(payloads, lengths, engine="window", per_packet=True)
    mesh = make_pattern_mesh(jax.devices()[:4])
    tot, hits = count_rows_summary_pattern_sharded(
        m, payloads, lengths, mesh, engine=engine
    )
    uniq_rows = rows[:, np.sort(np.unique(m.window.dup_map,
                                          return_index=True)[1])]
    # Totals are BUILD-order unique counts; recompute from the expanded rows
    # via the dup_map's first occurrence of each unique index.
    first = np.zeros(len(m.window.unique_patterns), np.int64)
    for orig, u in enumerate(m.window.dup_map):
        first[u] = rows[:, orig].sum()
    assert (tot == first).all()
    assert (hits == (rows.sum(axis=1) > 0)).all()
    del uniq_rows


def test_nul_patterns_use_fit():
    """NUL-containing sets force exact fit masks; counts still identical."""
    rng = np.random.default_rng(63)
    pats = [b"a\x00b", b"\x00\x00", b"ab", b"ba"]
    m = Matcher(pats)
    payloads, lengths = _mk_batch(rng, n=16, L=64, alphabet=(0x61, 0x63))
    # Plant NULs INSIDE valid regions so the NUL patterns actually match.
    payloads[0, :4] = [0x61, 0x00, 0x62, 0x00]
    lengths[0] = max(lengths[0], 8)
    want = m.count(payloads, lengths, engine="window")
    mesh = make_pattern_mesh(jax.devices()[:4])
    for engine in ("window", "pallas"):
        got = count_matches_pattern_sharded(
            m, payloads, lengths, mesh, engine=engine
        )
        assert (got == want).all(), engine


def test_more_shards_than_patterns():
    rng = np.random.default_rng(64)
    m = Matcher([b"ab", b"cd", b"abc"])
    payloads, lengths = _mk_batch(rng, n=8, L=64, alphabet=(0x61, 0x65))
    want = m.count(payloads, lengths, engine="window")
    mesh = make_pattern_mesh(jax.devices()[:8])
    got = count_matches_pattern_sharded(m, payloads, lengths, mesh)
    assert (got == want).all()


def test_ac_kmp_remap_and_bad_engine():
    rng = np.random.default_rng(66)
    m = Matcher([b"ab", b"bc"])
    payloads, lengths = _mk_batch(rng, n=8, L=64)
    mesh = make_pattern_mesh(jax.devices()[:2])
    want = m.count(payloads, lengths, engine="ac")
    got = count_matches_pattern_sharded(
        m, payloads, lengths, mesh, engine="ac"
    )
    assert (got == want).all()
    with pytest.raises(ValueError, match="pattern-shard engine"):
        count_matches_pattern_sharded(
            m, payloads, lengths, mesh, engine="bogus"
        )


def test_nocase_folds():
    rng = np.random.default_rng(67)
    m = Matcher([b"AbC", b"xyz"], case_insensitive=True)
    payloads = np.zeros((4, 64), np.uint8)
    payloads[0, :6] = np.frombuffer(b"aBcXYZ", np.uint8)
    lengths = np.array([6, 0, 0, 0], np.int32)
    want = m.count(payloads, lengths, engine="window")
    mesh = make_pattern_mesh(jax.devices()[:2])
    got = count_matches_pattern_sharded(m, payloads, lengths, mesh)
    assert (got == want).all() and got[0] == 1 and got[1] == 1


def test_choose_shard_axis():
    rng = np.random.default_rng(68)
    small = Matcher([b"ab", b"cd"])
    assert choose_shard_axis(small, 8) == "packets"
    assert choose_shard_axis(small, 1) == "packets"
    big = Matcher(_mk_patterns(rng, 700, lens=(8, 9)))
    assert choose_shard_axis(big, 8) == "patterns"


def test_gather_roundtrip():
    """plan.gather inverts the shard layout exactly (identity counts)."""
    rng = np.random.default_rng(69)
    pats = _mk_patterns(rng, 13)
    wp = Matcher(pats).window
    plan = build_pattern_shards(wp, 4)
    U = wp.pat_words.shape[0]
    full = np.full(plan.n_shards * plan.S, -1, np.int64)
    for u in range(U):
        d, slot = plan.shard_of_unique(u)
        full[d * plan.S + slot] = 1000 + u
    got = plan.gather(full)
    assert (got == 1000 + np.arange(U)).all()


# -- streamed serving + attribution under pattern sharding -----------------


def test_streamed_pattern_sharded_matches(reference_dir):
    from multithreading_string_matching import load_patterns
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    path = reference_dir / "udp_1000.pcap"
    want = count_pcap_streamed(m, path, "udp")
    for axis in ("patterns", "both"):
        got = count_pcap_streamed(
            m, path, "udp", sharded=True, shard_axis=axis, tile_rows=256
        )
        assert (np.asarray(got) == np.asarray(want)).all(), axis


def test_streamed_pattern_sharded_nul_set(reference_dir):
    """NUL pattern sets route through the per-row scanner; the pattern axis
    must compose with that fallback too."""
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    m = Matcher([b"http", b"Li\x00", b"NOTIFY"])
    path = reference_dir / "udp.pcap"
    want = count_pcap_streamed(m, path, "udp")
    got = count_pcap_streamed(
        m, path, "udp", sharded=True, shard_axis="patterns"
    )
    assert (np.asarray(got) == np.asarray(want)).all()


def test_streamed_attribution_pattern_sharded(reference_dir):
    """--sharded --offsets with the pattern axis: counts, offsets, and the
    dumped selection all equal the unsharded run."""
    from multithreading_string_matching import load_patterns
    from multithreading_string_matching.parallel.pipeline import (
        scan_pcap_streamed,
    )

    m = Matcher(load_patterns(reference_dir / "strings.txt"))
    path = reference_dir / "udp.pcap"
    want, want_rows = scan_pcap_streamed(m, path, "udp", offsets=True)
    got, got_rows = scan_pcap_streamed(
        m, path, "udp", offsets=True, sharded=True, shard_axis="patterns"
    )
    assert (np.asarray(got) == np.asarray(want)).all()
    assert (got_rows == want_rows).all()


def test_bad_shard_axis_raises(reference_dir):
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    m = Matcher([b"http"])
    with pytest.raises(ValueError, match="shard_axis"):
        count_pcap_streamed(
            m, reference_dir / "udp.pcap", "udp", sharded=True,
            shard_axis="bogus",
        )


def test_cli_shard_axis(reference_dir):
    """match --sharded --shard-axis patterns: counts equal the variant-A
    totals; the json blob records the axis; --shard-axis without --sharded
    errors."""
    import json
    import subprocess
    import sys

    env = dict(__import__("os").environ)
    env["MSM_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match",
         "--pcap", str(reference_dir / "udp.pcap"),
         "--patterns", str(reference_dir / "strings.txt"),
         "--mode", "udp", "--sharded", "--shard-axis", "patterns", "--json"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    blob = json.loads(out.stdout)
    assert sum(blob["counts"]) == 39
    assert blob["execution"]["shard_axis"] == "patterns"
    bad = subprocess.run(
        [sys.executable, "-m", "multithreading_string_matching", "match",
         "--pcap", str(reference_dir / "udp.pcap"),
         "--patterns", str(reference_dir / "strings.txt"),
         "--shard-axis", "patterns"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert bad.returncode != 0
    assert "--shard-axis requires --sharded" in bad.stderr


def test_cli_shard_axis_offsets(reference_dir):
    """--sharded --shard-axis patterns --offsets equals the unsharded run."""
    import json
    import subprocess
    import sys

    env = dict(__import__("os").environ)
    env["MSM_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "multithreading_string_matching",
             "match", "--pcap", str(reference_dir / "udp.pcap"),
             "--patterns", str(reference_dir / "strings.txt"),
             "--mode", "udp", "--offsets", "--json", *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout)

    want = run()
    got = run("--sharded", "--shard-axis", "patterns")
    assert got["counts"] == want["counts"]
    assert got["offsets"] == want["offsets"]
