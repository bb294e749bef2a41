import numpy as np
import pytest

from multithreading_string_matching.utils.config import MatchConfig
from multithreading_string_matching.io.synth import synth_udp_pcap
from multithreading_string_matching.io.pcap import read_pcap
from multithreading_string_matching.io.decode import extract_payloads


def test_config_roundtrip(tmp_path):
    cfg = MatchConfig(pcap="x.pcap", patterns="s.txt", engine="ac", strict=True)
    path = tmp_path / "c.json"
    path.write_text(cfg.to_json())
    loaded = MatchConfig.load(path)
    assert loaded == cfg


def test_config_validation():
    with pytest.raises(ValueError):
        MatchConfig(mode="icmp").validate()
    with pytest.raises(ValueError):
        MatchConfig(engine="gpu").validate()
    with pytest.raises(ValueError):
        MatchConfig(batch_size=0).validate()
    with pytest.raises(ValueError):
        MatchConfig.from_json('{"nonsense": 1}')


def test_config_host_workers(tmp_path, reference_dir, capsys):
    """host_workers rides the config system: JSON round-trip, validation,
    and a config-file-driven streamed CLI run (no flag needed)."""
    import json

    cfg = MatchConfig(host_workers=2)
    assert MatchConfig.from_json(cfg.to_json()).host_workers == 2
    with pytest.raises(ValueError, match="host_workers"):
        MatchConfig(host_workers=-1).validate()

    from multithreading_string_matching.cli import main

    path = tmp_path / "c.json"
    path.write_text(MatchConfig(
        pcap=str(reference_dir / "udp.pcap"),
        patterns=str(reference_dir / "strings.txt"),
        host_workers=2,
    ).to_json())
    rc = main(["match", "--config", str(path), "--stream", "--json"])
    assert rc == 0
    blob = json.loads(capsys.readouterr().out)
    assert sum(blob["counts"]) == 39  # BASELINE.md variant A


def test_config_env_override(monkeypatch):
    monkeypatch.setenv("MSM_ENGINE", "kmp")
    monkeypatch.setenv("MSM_STRICT", "true")
    monkeypatch.setenv("MSM_N_TILE", "64")
    cfg = MatchConfig.from_env()
    assert cfg.engine == "kmp" and cfg.strict is True and cfg.n_tile == 64


def test_synth_corpus_counts(tmp_path, strings_path):
    from multithreading_string_matching import Matcher, load_patterns
    import oracle

    pats = load_patterns(strings_path)
    f = tmp_path / "synth.pcap"
    total = synth_udp_pcap(
        f, 200, payload_len=256, payload_len_jitter=64,
        patterns=pats, plant_rate=0.5, invalid_rate=0.1, seed=7,
    )
    pcap = read_pcap(f)
    assert pcap.num_packets == 200
    batch = extract_payloads(pcap, "udp")
    assert batch.total_payload_bytes == total
    # framework counts == oracle counts on synthetic traffic too
    m = Matcher(pats)
    got = m.count_batch(batch)
    want = np.array(oracle.oracle_pcap_counts(f, pats, "udp"))
    assert (got == want).all()
    assert got.sum() > 0  # planted patterns were found


def test_stream_checkpoint_resume(tmp_path, strings_path, reference_dir):
    from multithreading_string_matching import Matcher, load_patterns
    from multithreading_string_matching.parallel.stream import StreamMatcher
    from multithreading_string_matching.io.live import FileReplaySource

    m = Matcher(load_patterns(strings_path))
    full = StreamMatcher(m)
    batches = list(FileReplaySource(reference_dir / "udp.pcap", batch_size=5))
    for b in batches:
        full.feed_pcap_slice(b, "udp")

    # feed half, checkpoint, resume in a fresh stream, feed the rest
    s1 = StreamMatcher(m)
    for b in batches[:2]:
        s1.feed_pcap_slice(b, "udp")
    ckpt = tmp_path / "stream.npz"
    s1.save(ckpt)
    s2 = StreamMatcher(m)
    s2.load(ckpt)
    for b in batches[2:]:
        s2.feed_pcap_slice(b, "udp")
    assert (s2.counts() == full.counts()).all()
    assert s2.packets_seen == full.packets_seen

    # checkpoint from a different pattern list is rejected
    m2 = Matcher([b"zz"])
    s3 = StreamMatcher(m2)
    with pytest.raises(ValueError):
        s3.load(ckpt)
