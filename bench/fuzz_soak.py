"""Randomized differential soak: engines vs the oracle, unbounded case space.

tests/test_fuzz_engines.py pins six adversarial corners; this keeps rolling
fresh random cases (patterns with NULs/duplicates/extremes, binary payloads,
case folding, per-packet attribution) for a wall-clock budget and diffs
every engine against tests/oracle.py.  Sampled sub-checks per case:
per-packet count matrices against a naive per-text oracle (not just their
column sums), find_matches offset rows against a bytes.find position
oracle (every (packet, start, unique_pattern) triple, overlapping starts
included), and the counts<->rows bincount invariant.  A sampled fraction
of cases also round-trips through the FULL streamed pipeline: payloads
wrapped as real UDP frames in a random container (classic pcap / pcapng /
gzipped), walked by the native ingest, extracted, packed, and counted via
count_pcap_streamed at random batch sizes with and without threaded host
workers — or, when the sample lands on the attribution path, scanned via
scan_pcap_streamed(offsets=True) with the offset rows diffed against the
same position oracle and (half the time) --dump-matches verified to emit
exactly the original frames of the matched packets, in capture order.
Run it when touching engine, staging, or ingest code:

    MSM_PLATFORM=cpu python bench/fuzz_soak.py --minutes 10 [--seed 0]

Exits nonzero on the first divergence, printing a reproducer tuple.
"""

import argparse
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# Soak on the host CPU: correctness is platform-independent, and small
# random cases are dispatch-bound on any accelerator.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import oracle  # noqa: E402
from multithreading_string_matching import Matcher  # noqa: E402
from multithreading_string_matching.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def random_case(rng: np.random.Generator):
    num_pats = int(rng.integers(1, 24))
    pats = []
    for _ in range(num_pats):
        m = int(rng.integers(1, 33)) if rng.random() < 0.9 else int(rng.integers(33, 97))
        alpha = rng.choice([2, 3, 5, 256])
        p = rng.integers(0, alpha, size=m).astype(np.uint8)
        if rng.random() < 0.1:
            p[rng.integers(0, m)] = 0  # embedded NUL forces the exact-fit path
        pats.append(p.tobytes())
    if len(pats) > 1 and rng.random() < 0.3:
        pats.append(pats[int(rng.integers(0, len(pats)))])  # duplicate
    # Bucket the padded shape to powers of two so compiled executables get
    # reused across cases (lengths stay fully random — shape, not content,
    # is what the compiler sees).
    n = _pow2(int(rng.integers(1, 65)))
    lmax = _pow2(int(rng.integers(1, 301)))
    alpha = int(rng.choice([2, 3, 5, 17, 256]))
    payloads = rng.integers(0, alpha, size=(n, lmax)).astype(np.uint8)
    lengths = rng.integers(0, lmax + 1, size=n).astype(np.int32)
    # Plant some guaranteed hits so the all-zero case is rare.
    for _ in range(min(4, n)):
        i = int(rng.integers(0, n))
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= lengths[i]:
            off = int(rng.integers(0, lengths[i] - len(p) + 1))
            payloads[i, off : off + len(p)] = np.frombuffer(p, np.uint8)
    return pats, payloads, lengths


def _flow_case(pats, texts, crng):
    """Repackage the case's texts as TCP flows (one text = one stream,
    random segmentation + cross-flow interleave) and check BOTH flow scan
    shapes against the concatenated-per-flow oracle.  Returns (ok, detail)."""
    import tempfile

    from multithreading_string_matching.io.flows import extract_flows
    from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching.io.synth import (
        synth_tcp_flows_pcap,
    )
    from multithreading_string_matching.parallel.flow_stream import (
        FlowStreamMatcher,
    )

    # Round-5 axes fuzzed here too: v6 keys (mixed with v4 in one capture),
    # pathological wires (reorder/retransmit/overlap knobs + reorder=True
    # reassembly), the window flow engine's single-dispatch rounds, and
    # mid-stream checkpoint/resume.
    ipv6 = bool(crng.random() < 0.3)
    pathological = bool(crng.random() < 0.5)
    vlan = bool(crng.random() < 0.3)  # 802.1Q/QinQ tags on ~half the frames
    flows = []
    for i, t in enumerate(texts[:12]):
        if ipv6 and crng.random() < 0.5:
            key = (f"2001:db8::{i + 1:x}", "2001:db8::ffff", 1000 + i, 80)
        else:
            key = (f"10.9.{i // 200}.{i % 200 + 1}", "10.0.0.1", 1000 + i, 80)
        segs, left = [], len(t)
        while left > 0:
            s = int(crng.integers(1, left + 1))
            segs.append(s)
            left -= s
        flows.append((key, t, segs or [0]))
    want = list(oracle.oracle_counts([t for _, t, _ in flows], pats))
    knobs = {}
    if pathological:
        knobs = dict(
            reorder_seed=int(crng.integers(0, 10_000)),
            retransmit_rate=float(crng.random() * 0.5),
            overlap_rate=float(crng.random() * 0.5),
        )
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "f.pcap"
        synth_tcp_flows_pcap(
            p, flows, interleave_seed=int(crng.integers(0, 10_000)),
            seed=int(crng.integers(0, 10_000)),
            vlan_rate=0.5 if vlan else 0.0, **knobs,
        )
        pcap = read_pcap(p)
        fb = extract_flows(pcap, "tcp", ipv6=ipv6, reorder=pathological,
                           vlan=vlan)
        m = Matcher(pats, engine="window")
        got1 = (
            m.count(fb.payloads, fb.lengths).tolist()
            if fb.num_flows else [0] * len(pats)
        )
        if got1 != want:
            return False, (
                f"one-shot got={got1} want={want} "
                f"(ipv6={ipv6} pathological={pathological} vlan={vlan})"
            )
        fse = "window" if crng.random() < 0.4 else "ac"
        # Streamed attribution fuzzed on the window engine: triples must
        # equal the one-shot find_matches AND bincount to the counts.
        offsets_on = fse == "window" and bool(crng.random() < 0.7)
        mk_fs = lambda: FlowStreamMatcher(
            Matcher(pats, engine="ac"), "tcp", engine=fse,
            # Pathological captures need the whole capture in ONE scan
            # round (the documented streaming reorder window); in-order
            # captures fuzz small rounds.
            scan_bytes=(1 << 30) if pathological
            else int(crng.integers(1, 64)),
            width=int(crng.choice([8, 32, 128])), min_lanes=8,
            reorder=pathological, ipv6=ipv6, vlan=vlan,
            collect_offsets=offsets_on,
        )
        fs = mk_fs()
        step = int(crng.integers(1, 6))
        ckpt_at = (
            int(crng.integers(0, pcap.num_packets + 1))
            if crng.random() < 0.3 else None
        )
        # Mid-capture rule reload to an IDENTICAL pattern set: for the
        # window engine the tails carry, so old_epoch + new_epoch counts
        # must equal the uninterrupted oracle exactly, and offset triples
        # (bases persist across the swap) must equal the one-shot find.
        # (in-order captures only: a forced mid-capture round would
        # split a scrambled capture's reordering across rounds — the
        # documented one-round streaming bound, not a bug)
        reload_at = (
            int(crng.integers(0, pcap.num_packets + 1))
            if fse == "window" and not pathological
            and crng.random() < 0.25 else None
        )
        epoch_counts = np.zeros(len(pats), np.int64)
        collected = []
        for s0 in range(0, pcap.num_packets, step):
            if ckpt_at is not None and s0 >= ckpt_at:
                ck = fs.save(pathlib.Path(d) / "ck")
                fs = mk_fs()
                fs.load(ck)
                ckpt_at = None
            if reload_at is not None and s0 >= reload_at:
                fs.flush()
                if offsets_on:
                    collected.extend(fs.drain_offsets())
                epoch_counts += fs.reload(Matcher(pats, engine="ac"))
                reload_at = None
            fs.feed_pcap_slice(slice_pcap(pcap, s0, s0 + step, copy=False))
        fs.flush()
        total = (epoch_counts + fs.counts()).tolist()
        if total != want:
            return False, (
                f"stream got={total} want={want} "
                f"(ipv6={ipv6} pathological={pathological} vlan={vlan} engine={fse})"
            )
        if offsets_on:
            from multithreading_string_matching.io.flows import (
                key_tuple_bytes,
            )

            hits = collected + fs.drain_offsets()
            bc = np.bincount(
                [u for _, _, u in hits],
                minlength=len(m.window.unique_patterns),
            )[m.window.dup_map]
            rows = (
                np.asarray(m.find_matches(fb.payloads, fb.lengths))
                if fb.num_flows else np.zeros((0, 3), np.int64)
            )
            want_tr = sorted(
                (fb.key_tuple(int(f)), int(i), int(u)) for f, i, u in rows
            )
            got_tr = sorted(
                (key_tuple_bytes(k), int(o), int(u)) for k, o, u in hits
            )
            if got_tr != want_tr or bc.tolist() != want:
                return False, (
                    f"stream offsets diverge: got={got_tr[:8]} "
                    f"want={want_tr[:8]} bincount={bc.tolist()} "
                    f"counts_want={want} (ipv6={ipv6} "
                    f"pathological={pathological} vlan={vlan})"
                )
    return True, ""


def naive_rows(texts, uniq):
    """Position oracle: every (packet, start, unique_pattern) triple, with
    overlapping starts, sorted — the find_matches contract."""
    rows = []
    for n, t in enumerate(texts):
        for u, p in enumerate(uniq):
            start = 0
            while True:
                i = t.find(p, start)
                if i < 0:
                    break
                rows.append((n, i, u))
                start = i + 1
    rows.sort()
    return rows


def _streamed_case(m, texts, crng):
    """Round-trip the payloads through the real streamed pipeline: wrap as
    UDP frames in a random container, scan via count_pcap_streamed with
    random batch size / host threading — or scan_pcap_streamed(offsets=True)
    when the attribution sample hits.  Returns (counts, rows|None,
    dumped|None, shape_tag); rows carry original capture packet numbers,
    which equal the text index here because every synthesized frame is a
    valid UDP packet; dumped is the --dump-matches round-trip verdict."""
    import gzip
    import struct as st
    import tempfile

    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
        scan_pcap_streamed,
    )

    frames = []
    for pl in texts:
        ip = st.pack(
            ">BBHHHBBH4s4s", 0x45, 0, 28 + len(pl), 0, 0, 64, 17, 0,
            b"\x01\x02\x03\x04", b"\x05\x06\x07\x08",
        )
        udp = st.pack(">HHHH", 1111, 2222, 8 + len(pl), 0)
        frames.append(b"\xaa" * 12 + b"\x08\x00" + ip + udp + pl)
    fmt = int(crng.integers(0, 3))  # 0 classic, 1 pcapng, 2 classic.gz
    if fmt == 1:
        blob = bytearray()

        def block(btype, body):
            pad = (-len(body)) % 4
            blen = 12 + len(body) + pad
            blob.extend(
                st.pack("<II", btype, blen) + body + b"\x00" * pad
                + st.pack("<I", blen)
            )

        block(0x0A0D0D0A, st.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
        block(0x00000001, st.pack("<HHI", 1, 0, 65535))
        for fr in frames:
            block(
                0x00000006,
                st.pack("<IIIII", 0, 0, 0, len(fr), len(fr)) + fr,
            )
        raw = bytes(blob)
        suffix = ".pcapng"
    else:
        blob = bytearray(
            st.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
        )
        for fr in frames:
            blob.extend(st.pack("<IIII", 0, 0, len(fr), len(fr)) + fr)
        raw = bytes(blob)
        suffix = ".pcap"
    if fmt == 2:
        raw = gzip.compress(raw)
        suffix = ".pcap.gz"
    bp = int(crng.choice([3, 64, 8192]))
    hw = int(crng.choice([0, 2]))
    attribution = bool(crng.random() < 0.4)
    dump = attribution and bool(crng.random() < 0.5)
    rows = dumped = None
    dump_path = None
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
        tf.write(raw)
        path = tf.name
    try:
        if attribution:
            if dump:
                dump_path = path + ".dump.pcap"
            got, rows = scan_pcap_streamed(
                m, path, "udp", offsets=True, batch_packets=bp,
                host_workers=hw, dump_path=dump_path,
            )
            if dump_path is not None:
                # The dump must hold EXACTLY the original frames of the
                # packets that matched, in capture order.
                from multithreading_string_matching.io.pcap import (
                    read_pcap,
                )

                hit_pkts = sorted({int(r[0]) for r in np.asarray(rows)})
                want_frames = [frames[i] for i in hit_pkts]
                if os.path.exists(dump_path):
                    dp = read_pcap(dump_path)
                    got_frames = [
                        dp.buf[dp.offsets[i]:dp.offsets[i] + dp.caplens[i]]
                        .tobytes()
                        for i in range(dp.num_packets)
                    ]
                else:  # no matches -> writer may never have been opened
                    got_frames = []
                dumped = (got_frames == want_frames)
        else:
            got = count_pcap_streamed(
                m, path, "udp", batch_packets=bp, host_workers=hw
            )
    finally:
        os.unlink(path)
        if dump_path is not None and os.path.exists(dump_path):
            os.unlink(dump_path)
    return (
        got, rows, dumped,
        f"fmt={suffix} bp={bp} hw={hw} offsets={attribution} dump={dump}",
    )


def run(minutes: float, seed: int) -> int:
    rng = np.random.default_rng(seed)
    deadline = time.monotonic() + minutes * 60
    cases = 0
    while time.monotonic() < deadline:
        case_seed = int(rng.integers(0, 2**63))
        crng = np.random.default_rng(case_seed)
        pats, payloads, lengths = random_case(crng)
        nocase = bool(crng.random() < 0.2)
        texts = [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]
        if nocase:
            fold = bytes(range(65)) + bytes(range(97, 123)) + bytes(range(91, 256))
            folded_texts = [t.translate(fold) for t in texts]
            want = np.array(
                oracle.oracle_counts(folded_texts, [p.translate(fold) for p in pats])
            )
        else:
            folded_texts = texts
            want = np.array(oracle.oracle_counts(texts, pats))
        m = Matcher(pats, case_insensitive=nocase)
        for engine in ("window", "ac", "kmp"):
            got = np.asarray(m.count(payloads, lengths, engine=engine))
            if crng.random() < 0.3:
                pp = np.asarray(
                    m.count(payloads, lengths, engine=engine, per_packet=True)
                )
                assert (pp.sum(axis=0) == got).all(), "per-packet sum mismatch"
                # Full per-packet oracle, not just the column sums.
                want_pp = np.array(
                    [
                        oracle.oracle_counts(
                            [t],
                            [p.translate(fold) for p in pats]
                            if nocase else pats,
                        )
                        for t in folded_texts
                    ]
                )
                assert (pp == want_pp).all(), "per-packet matrix mismatch"
            if not (got == want).all():
                print(
                    f"DIVERGENCE engine={engine} nocase={nocase} "
                    f"case_seed={case_seed}\n pats={pats}\n got={got}\n want={want}"
                )
                return 1
        if crng.random() < 0.25:
            # Offset attribution differential: every (packet, start,
            # unique_pattern) triple against the bytes.find position
            # oracle, plus the rows->counts bincount invariant.
            uniq = [bytes(p) for p in m.window.unique_patterns]
            got_rows = sorted(
                map(tuple, np.asarray(m.find_matches(payloads, lengths)).tolist())
            )
            want_rows = naive_rows(folded_texts, uniq)
            if got_rows != want_rows:
                print(
                    f"DIVERGENCE find_matches nocase={nocase} "
                    f"case_seed={case_seed}\n pats={pats}\n"
                    f" got={got_rows[:20]}\n want={want_rows[:20]}"
                )
                return 1
            derived = m.counts_from_match_rows(np.array(got_rows).reshape(-1, 3))
            assert (derived == want).all(), "rows->counts invariant"
        if crng.random() < 0.25:
            got_s, rows_s, dumped_ok, shape = _streamed_case(m, texts, crng)
            if not (np.asarray(got_s) == want).all():
                print(
                    f"DIVERGENCE streamed {shape} nocase={nocase} "
                    f"case_seed={case_seed}\n pats={pats}\n"
                    f" got={np.asarray(got_s)}\n want={want}"
                )
                return 1
            if rows_s is not None:
                uniq = [bytes(p) for p in m.window.unique_patterns]
                got_rows = sorted(map(tuple, np.asarray(rows_s).tolist()))
                if got_rows != naive_rows(folded_texts, uniq):
                    print(
                        f"DIVERGENCE streamed offsets {shape} nocase={nocase} "
                        f"case_seed={case_seed}\n pats={pats}"
                    )
                    return 1
            if dumped_ok is False:
                print(
                    f"DIVERGENCE streamed dump {shape} nocase={nocase} "
                    f"case_seed={case_seed}\n pats={pats}"
                )
                return 1
        if crng.random() < 0.15:
            # Flow-aware differential (round 4): repackage the case's
            # texts as TCP segments of random flows with random
            # segmentation/interleave, and require BOTH the one-shot
            # reassembly scan and the carried-state flow stream (random
            # scan_bytes/width so splits land on round/chunk boundaries)
            # to equal the concatenated-per-flow oracle.
            ok, detail = _flow_case(pats, texts, crng)
            if not ok:
                print(
                    f"DIVERGENCE flows case_seed={case_seed}\n"
                    f" pats={pats}\n {detail}"
                )
                return 1
        cases += 1
        if cases % 50 == 0:
            print(f"{cases} cases clean, {deadline - time.monotonic():.0f}s left", flush=True)
        if cases % 200 == 0:
            # Every case compiles fresh executables (pattern tables are
            # baked into the jit); without this the accumulated JIT code
            # sections exhaust process memory around ~1k cases
            # ("LLVM ERROR: Unable to allocate section memory").
            jax.clear_caches()
    print(f"soak clean: {cases} cases, seed={seed}")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    raise SystemExit(run(a.minutes, a.seed))
