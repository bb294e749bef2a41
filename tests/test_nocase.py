"""ASCII case-insensitive matching (Matcher(case_insensitive=True)).

The reference has no analogue (kmp_matcher is byte-exact, serial.c:190-215);
this is the IDS-style ``nocase`` option.  Spec: fold A-Z -> a-z (exactly
Python bytes.lower() semantics) on BOTH patterns and payloads, then count as
usual.  The oracle here is count_overlapping on folded bytes.
"""

import os

import numpy as np
import pytest

from oracle import count_overlapping
from multithreading_string_matching import Matcher

PATS = [b"HTTP", b"http", b"AbC", b"zz", b"HTTP", b"[X]"]


def _mixed_corpus(seed, n=24, L=96):
    rng = np.random.default_rng(seed)
    # Bytes straddling the alpha ranges plus brackets/punctuation.
    alphabet = np.frombuffer(b"aAbBcChHtTpPzZ[]{x@ ", np.uint8)
    payloads = alphabet[rng.integers(0, len(alphabet), size=(n, L))]
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    cols = np.arange(L)[None, :]
    payloads = np.where(cols < lengths[:, None], payloads, 0).astype(np.uint8)
    return payloads, lengths


def _oracle_nocase(payloads, lengths, pats):
    texts = [payloads[i, : lengths[i]].tobytes().lower() for i in range(len(lengths))]
    return np.array(
        [sum(count_overlapping(t, p.lower()) for t in texts) for p in pats]
    )


@pytest.mark.parametrize("engine", ["window", "ac", "kmp"])
def test_nocase_engines_match_folded_oracle(engine):
    payloads, lengths = _mixed_corpus(31)
    m = Matcher(PATS, engine=engine, case_insensitive=True)
    got = m.count(payloads, lengths)
    want = _oracle_nocase(payloads, lengths, PATS)
    assert (got == want).all()
    # Case-sensitive counts differ on this corpus (sanity that the flag acts).
    plain = Matcher(PATS, engine=engine).count(payloads, lengths)
    assert (plain <= got).all() and (plain != got).any()


def test_nocase_pallas_staged_paths():
    payloads, lengths = _mixed_corpus(32)
    want = _oracle_nocase(payloads, lengths, PATS)
    m = Matcher(PATS, case_insensitive=True)
    for packed in (True, False):
        got = np.asarray(m.count_prepared(m.prepare(payloads, lengths,
                                                    packed=packed)))
        assert (got == want).all(), packed
    pp = m.count(payloads, lengths, per_packet=True)
    assert (pp.sum(axis=0) == want).all()


def test_nocase_case_variants_fold_together():
    m = Matcher([b"HTTP", b"http", b"HttP"], engine="window", case_insensitive=True)
    pay = np.zeros((1, 16), np.uint8)
    pay[0, :4] = np.frombuffer(b"hTtP", np.uint8)
    got = m.count(pay, np.array([4], np.int32))
    assert got.tolist() == [1, 1, 1]  # every spelling reports the shared count


def test_nocase_streaming_and_pipeline(tmp_path):
    from multithreading_string_matching.io.synth import synth_udp_pcap
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_pipelined, count_pcap_streamed,
    )
    from multithreading_string_matching.parallel.stream import StreamMatcher

    pcap = tmp_path / "mix.pcap"
    synth_udp_pcap(
        pcap, 80, payload_len=120, payload_len_jitter=40,
        patterns=[b"HTTP", b"hTtP", b"abc"], plant_rate=0.6, seed=33,
    )
    batch = extract_payloads(read_pcap(pcap), "udp")
    m = Matcher([b"http", b"ABC"], engine="window", case_insensitive=True)
    want = _oracle_nocase(
        np.asarray(batch.payloads), np.asarray(batch.lengths), m.patterns
    )
    assert want.sum() > 0
    got_pipe = count_pcap_pipelined(m, pcap)
    assert (got_pipe == want).all()
    got_stream = count_pcap_streamed(m, pcap)
    assert (got_stream == want).all()
    sm = StreamMatcher(m)
    sm.feed_batch(np.asarray(batch.payloads), np.asarray(batch.lengths))
    assert (sm.counts() == want).all()
    # Long-payload carried-state path (chunked scan), both engines.
    for eng in ("window", "ac"):
        sm2 = StreamMatcher(m, fixed_len=32, engine=eng, packed=False)
        sm2.feed_batch(np.asarray(batch.payloads), np.asarray(batch.lengths))
        assert (sm2.counts() == want).all(), eng


def test_nocase_find_matches_and_cli(reference_dir, tmp_path, capsys):
    from multithreading_string_matching.cli import main

    payloads = np.zeros((2, 16), np.uint8)
    payloads[0, :4] = np.frombuffer(b"HtTp", np.uint8)
    payloads[1, 2:6] = np.frombuffer(b"hTTP", np.uint8)
    lengths = np.array([8, 8], np.int32)
    m = Matcher([b"http"], case_insensitive=True)
    rows = m.find_matches(payloads, lengths)
    assert rows.tolist() == [[0, 0, 0], [1, 2, 0]]

    # CLI --nocase end-to-end on a synthetic capture.
    from multithreading_string_matching.io.synth import synth_udp_pcap

    pcap = tmp_path / "cli.pcap"
    synth_udp_pcap(pcap, 30, payload_len=64, patterns=[b"NeEdLe"],
                   plant_rate=1.0, seed=34)
    strings = tmp_path / "strings.txt"
    strings.write_text("needle\n")
    rc = main(["match", "--pcap", str(pcap), "--patterns", str(strings),
               "--mode", "udp", "--nocase", "--json"])
    assert rc == 0
    import json

    out = json.loads(capsys.readouterr().out)
    nocase_total = sum(out["counts"])
    assert nocase_total > 0
    rc = main(["match", "--pcap", str(pcap), "--patterns", str(strings),
               "--mode", "udp", "--json"])
    assert rc == 0
    assert sum(json.loads(capsys.readouterr().out)["counts"]) == 0
