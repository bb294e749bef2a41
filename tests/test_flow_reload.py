"""FlowStreamMatcher.reload — mid-stream rule swap on the flow monitor
(StreamMatcher.reload's flow flavor): old counts returned, flows/coverage/
bases persist, window tails carry across the swap (trimmed to the new
halo), AC states restart (documented boundary contract)."""

import numpy as np
import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching.io.synth import synth_tcp_flows_pcap
from multithreading_string_matching.io.flows import key_tuple_bytes
from multithreading_string_matching.parallel.flow_stream import (
    FlowStreamMatcher,
)

KEY = ("10.0.0.1", "10.0.0.2", 1111, 80)


def _pcap(tmp_path, payload, seglens, name="r.pcap"):
    cap = tmp_path / name
    synth_tcp_flows_pcap(cap, [(KEY, payload, seglens)])
    return read_pcap(cap)


def test_reload_counts_and_state_carry_window(tmp_path):
    # Stream "..ALPHA.." under rules [ALPHA], swap to [BETA, AL] and
    # stream "..BETA..": old counts returned, new counts fresh.
    p1 = _pcap(tmp_path, b"xxALPHAyy", [3, 3, 3], "a.pcap")
    p2 = _pcap(tmp_path, b"qqBETAzz", [4, 4], "b.pcap")
    fs = FlowStreamMatcher(Matcher([b"ALPHA"]), "tcp", engine="window",
                           scan_bytes=4)
    fs.feed_pcap_slice(p1)
    old = fs.reload(Matcher([b"BETA", b"AL"]))
    assert old.tolist() == [1]
    fs.feed_pcap_slice(p2)
    fs.flush()
    assert fs.counts().tolist() == [1, 0]
    assert fs.flows_seen == 1  # the flow survived the swap


@pytest.mark.parametrize("engine,expect", [("window", 1), ("ac", 0)])
def test_swap_boundary_straddle(tmp_path, engine, expect):
    """A NEW-set pattern straddling the swap boundary: found by the
    window engine (byte tails carry), missed by AC (DFA restarts) — the
    documented contract for each."""
    p1 = _pcap(tmp_path, b"xxSPL", [5], "a.pcap")
    p2 = _pcap(tmp_path, b"ITxx", [4], "b.pcap")
    fs = FlowStreamMatcher(Matcher([b"nohit"]), "tcp", engine=engine,
                           scan_bytes=1)
    fs.feed_pcap_slice(p1)
    fs.flush()
    old = fs.reload(Matcher([b"SPLIT"]))
    assert old.tolist() == [0]
    fs.feed_pcap_slice(p2)
    fs.flush()
    assert fs.counts().tolist() == [expect]


def test_reload_trims_tail_to_new_halo(tmp_path):
    """New max_len SHORTER than the old: tails trim; matches within the
    new halo still straddle correctly."""
    p1 = _pcap(tmp_path, b"aaaaaaaaX", [9], "a.pcap")
    p2 = _pcap(tmp_path, b"Ybbb", [4], "b.pcap")
    fs = FlowStreamMatcher(Matcher([b"LONGPATTERN"]), "tcp",
                           engine="window", scan_bytes=1)
    fs.feed_pcap_slice(p1)
    fs.flush()
    fs.reload(Matcher([b"XY"]))
    k = next(iter(fs._states))
    tail, fl = fs._states[k]
    assert len(tail) == fl == 1 and tail == b"X"
    fs.feed_pcap_slice(p2)
    fs.flush()
    assert fs.counts().tolist() == [1]


def test_reload_offsets_drain_rule(tmp_path):
    p1 = _pcap(tmp_path, b"xxSIGyy", [3, 4], "a.pcap")
    p2 = _pcap(tmp_path, b"SIGNATURE!", [5, 5], "b.pcap")
    fs = FlowStreamMatcher(Matcher([b"SIG"]), "tcp", engine="window",
                           scan_bytes=1, collect_offsets=True)
    fs.feed_pcap_slice(p1)
    with pytest.raises(ValueError, match="drain_offsets"):
        fs.reload(Matcher([b"SIGNATURE"]))
    # The refusing reload already flushed — stream stays usable.
    hits = fs.drain_offsets()
    assert [(int(o), int(u)) for _, o, u in hits] == [(2, 0)]
    old = fs.reload(Matcher([b"SIGNATURE"]))
    assert old.tolist() == [1]
    fs.feed_pcap_slice(p2)
    fs.flush()
    # Stream bases persisted: the new-set match offset counts the bytes
    # scanned under the OLD rules too.
    (k, off, u), = fs.drain_offsets()
    assert off == 7 and fs.counts().tolist() == [1]
    assert key_tuple_bytes(k) == ("10.0.0.1", "10.0.0.2", 1111, 80)


def test_reload_with_reorder_coverage_persists(tmp_path):
    """Reorder coverage carries across the swap: a retransmission of
    bytes scanned under the OLD rules still drops under the new."""
    cap = tmp_path / "ro.pcap"
    synth_tcp_flows_pcap(cap, [(KEY, b"abcdefSIG", [3, 3, 3])])
    pcap = read_pcap(cap)
    fs = FlowStreamMatcher(Matcher([b"abc"]), "tcp", engine="window",
                           scan_bytes=1, reorder=True)
    fs.feed_pcap_slice(slice_pcap(pcap, 0, 2, copy=False))
    fs.flush()
    old = fs.reload(Matcher([b"SIG", b"abc"]))
    assert old.tolist() == [1]
    # Re-feed the first segment (pure retransmission of scanned bytes)
    # plus the tail: the retransmission must NOT recount under new rules.
    fs.feed_pcap_slice(slice_pcap(pcap, 0, 1, copy=False))
    fs.feed_pcap_slice(slice_pcap(pcap, 2, 3, copy=False))
    fs.flush()
    assert fs.counts().tolist() == [1, 0]
