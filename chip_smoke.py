"""Smoke run of the matcher's main path on an NVIDIA GPU.

    python chip_smoke.py              # one card
    python chip_smoke.py --cards 4    # the multi-card phase only, on four

Phases (any failure exits non-zero; the last stdout line is a JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}`` only on success):

1. card and stack: the card's name and power limit (nvidia-smi), the JAX
   version and XLA_FLAGS; refuses to run unless JAX's device is a GPU;
2. data, made from seeds: a ~100 MB UDP capture (100k packets of
   1 KB +- 256 B) with a 97-entry mixed-length (2-12 B) rule-file-shaped
   pattern set planted in it, a 3,072-entry set, and a TCP flow capture of
   a few hundred interleaved, reordered flows with retransmissions;
3. engines: the repository has no hand-written GPU kernel (a Pallas one
   lost end to end — docs/DESIGN.md §1), so the main path's XLA programs
   (window-engine totals, per-row counts and flow-halo scan) are compiled
   at the corpus's widths with their memory analysis printed, and their
   counts compared exactly with the AC engine on the full corpus and with
   tests/oracle.py on a 2k-packet slice;
4. main path: Matcher.count_pcap, count_pcap_streamed, ``match --stream``,
   FlowStreamMatcher and ``match --flows --stream``, and the 3,072-pattern
   set through Matcher, every count equal to its reference, and
   Matcher.explain() naming the GPU choice;
5. informational wall times (not metrics), beside the card's name and
   power limit.

``--cards 4`` runs only the sharded paths (packet-axis mesh counting,
count_pcap_streamed(sharded=True), pattern-axis sharding of the 3,072-pattern
set, FlowStreamMatcher(sharded=True)) and compares each with the same
process's one-card result.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SEED = 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not (got == want).all():
        bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))[:5]
        fail(f"{name}: counts differ from the reference "
             f"(shape {got.shape} vs {want.shape}, first indices {bad})")
    print(f"  ok  {name}: {int(want.sum())} matches", flush=True)


def best_of(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that is not JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        fail("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_data(tmp: pathlib.Path):
    from multithreading_string_matching.io.synth import (
        synth_patterns,
        synth_tcp_flows_pcap,
        synth_udp_pcap,
    )

    pats = synth_patterns(97, seed=SEED)
    big = synth_patterns(3072, seed=SEED + 1)
    udp = tmp / "udp.pcap"
    synth_udp_pcap(udp, 100_000, payload_len=1024, payload_len_jitter=256,
                   patterns=pats, plant_rate=0.05, seed=SEED)
    pat_file = tmp / "patterns.txt"
    pat_file.write_bytes(b"\n".join(pats) + b"\n")
    rng = np.random.default_rng(SEED)
    flows = []
    for i in range(384):
        body = rng.integers(0, 256, int(rng.integers(512, 8192)), np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            p = pats[int(rng.integers(0, len(pats)))]
            off = int(rng.integers(0, body.size - len(p)))
            body[off: off + len(p)] = np.frombuffer(p, np.uint8)
        key = (f"10.{i // 250}.{i % 250}.1", "10.9.9.9", 1024 + i, 80)
        flows.append((key, body.tobytes()))
    flow_pcap = tmp / "flows.pcap"
    synth_tcp_flows_pcap(flow_pcap, flows, segment_len=700, interleave_seed=SEED,
                         reorder_seed=SEED, retransmit_rate=0.05, seed=SEED)
    return pats, big, udp, pat_file, flow_pcap


def run_cli(argv) -> dict:
    from multithreading_string_matching.cli import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        code = main(argv)
    if code != 0:
        fail(f"cli {' '.join(argv[:2])} exited {code}")
    return json.loads(buf.getvalue())


def one_card(pats, big, udp, pat_file, flow_pcap, card: str) -> None:
    import jax

    sys.path.insert(0, str(REPO / "tests"))
    import oracle
    from multithreading_string_matching import Matcher
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.io.flows import extract_flows
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.ops.window import (
        StreamHalo,
        _window_count_tiles,
        count_matches_window_tiles,
        window_stream_chunk,
    )
    from multithreading_string_matching.parallel.flow_stream import (
        FlowStreamMatcher,
    )
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    print("phase 3: engines", flush=True)
    batch = extract_payloads(read_pcap(udp), "udp")
    m = Matcher(pats)
    ex = m.explain()
    print(f"  explain: {ex}", flush=True)
    if (ex["platform"], ex["engine_resolved"]) != ("gpu", "window"):
        fail(f"explain() does not name the GPU choice: {ex}")
    prep = m.prepare_batch(batch, packed=False, n_tile=8192)
    shapes = sorted({tuple(p.shape) for p, _ in prep.tiles})
    print(f"  {len(prep.tiles)} resident tiles, shapes {shapes}", flush=True)
    wp = m.window
    tabs = tuple(jax.numpy.asarray(a)
                 for a in (wp.pat_words, wp.pat_masks, wp.pat_lens))
    for name, per_packet in (("totals", False), ("per-row", True)):
        mem = _window_count_tiles.lower(
            *tabs, prep.tiles, per_packet=per_packet).compile()
        print(f"  window {name} over the tiles: {mem.memory_analysis()}",
              flush=True)
    ref_u = np.asarray(count_matches_window_tiles(
        wp, prep.tiles, expand_duplicates=False))
    ref = ref_u[wp.dup_map]
    check("XLA window engine == AC engine (full corpus)", ref,
          m.count_batch(batch, engine="ac"))
    rows_w = count_matches_window_tiles(wp, prep.tiles, per_packet=True)
    merged = np.zeros((batch.num_payloads, len(pats)), np.int64)
    for idx, o in zip(prep.row_indices, rows_w):
        merged[idx] = np.asarray(o)[: len(idx)]
    check("window per-row, summed == totals (full corpus)",
          merged.sum(axis=0), ref)
    sl = slice(0, 2000)
    texts = [batch.payloads[i, : batch.lengths[i]].tobytes()
             for i in range(2000)]
    check("window per-row == oracle per packet (2k-packet slice)",
          merged[sl], [oracle.oracle_counts([t], pats) for t in texts])
    # The flow-round halo scan on a full-width round tile: corpus bytes
    # re-laid as [R, H + 2048] rows with random fills and start bounds,
    # against the same rows scanned whole with the oracle's rule.
    H, CW = max(int(wp.max_len) - 1, 1), 2048
    R = batch.payloads.size // (H + CW) // 64 * 64
    x = batch.payloads.reshape(-1)[: R * (H + CW)].reshape(R, H + CW)
    rng = np.random.default_rng(SEED)
    rel = rng.integers(0, CW + 1, R).astype(np.int32)
    fill = rng.integers(0, H + 1, R).astype(np.int32)
    x = np.where(np.arange(H + CW)[None] < (rel + H)[:, None], x, 0)
    x = x.astype(np.uint8)
    x[:, :H][np.arange(H)[None] < (H - fill)[:, None]] = 0
    xd = jax.device_put(x)
    halo = StreamHalo(xd[:, :H], jax.device_put(fill))
    got_h, _ = window_stream_chunk(wp, xd[:, H:], rel, halo)
    want_h = np.zeros(len(pats), np.int64)
    for i in range(0, R, max(1, R // 200)):  # ~200 rows through the oracle
        row = x[i, H - fill[i]: H + rel[i]].tobytes()
        full = oracle.oracle_counts([row], pats)
        head = oracle.oracle_counts([row[: fill[i]]], pats)
        want_h += np.asarray(full) - np.asarray(head)
    sub = np.arange(0, R, max(1, R // 200))
    got_sub, _ = window_stream_chunk(
        wp, xd[sub, H:], rel[sub], StreamHalo(xd[sub, :H], fill[sub]))
    check("window halo chunk scan == oracle (sampled flow-round rows)",
          got_sub, want_h)
    print(f"  halo scan over the full [{R}, {H + CW}] tile: "
          f"{int(np.asarray(got_h).sum())} matches", flush=True)

    print("phase 4: main path", flush=True)
    check("Matcher(patterns).count_pcap", Matcher(pats).count_pcap(udp), ref)
    stats = {}
    check("count_pcap_streamed",
          count_pcap_streamed(Matcher(pats), udp, "udp", stats=stats), ref)
    if stats["engine_resolved"] != "window":
        fail(f"streamed path ran {stats['engine_resolved']}")
    blob = run_cli(["match", "--pcap", str(udp), "--patterns", str(pat_file),
                    "--mode", "udp", "--stream", "--json"])
    if blob["execution"]["engine_resolved"] != "window":
        fail(f"match --stream ran {blob['execution']}")
    check("match --stream", blob["counts"], ref)

    fpcap = read_pcap(flow_pcap)
    for reorder in (True, False):
        fb = extract_flows(fpcap, "tcp", reorder=reorder)
        fwant = oracle.oracle_counts(
            [fb.stream(f) for f in range(fb.num_flows)], pats)
        fm = Matcher(pats)
        eng = fm.flow_stream_engine()
        if eng != "window":
            fail(f"flow stream engine on the GPU is {eng}, not window")
        for engine in ("window", "ac"):
            fs = FlowStreamMatcher(fm, "tcp", engine=engine, reorder=reorder,
                                   scan_bytes=64 << 20)
            fs.feed_pcap_slice(fpcap)
            fs.flush()
            check(f"FlowStreamMatcher(engine={engine}, reorder={reorder})",
                  fs.counts(), fwant)
    fb = extract_flows(fpcap, "tcp")
    fwant = oracle.oracle_counts([fb.stream(f) for f in range(fb.num_flows)],
                                 pats)
    blob = run_cli(["match", "--pcap", str(flow_pcap), "--patterns",
                    str(pat_file), "--mode", "tcp", "--flows", "--stream",
                    "--json"])
    check("match --flows --stream", blob["counts"], fwant)

    mb = Matcher(big)
    exb = mb.explain()
    print(f"  3072-pattern explain: {exb}", flush=True)
    if exb["engine_resolved"] != "window":
        fail(f"3072-pattern set resolved to {exb['engine_resolved']}")
    got_big = mb.count_pcap(udp, l_quant=1280)
    check("3072 patterns: Matcher == AC engine (full corpus)", got_big,
          mb.count_batch(batch, engine="ac"))
    sl = slice(0, 300)
    check("3072 patterns: Matcher == oracle (300-packet slice)",
          mb.count(batch.payloads[sl], batch.lengths[sl]),
          oracle.oracle_counts(texts[:300], big))

    print(f"phase 5: wall times, informational only ({card})", flush=True)
    nb = batch.total_payload_bytes
    t_t = best_of(lambda: count_matches_window_tiles(
        wp, prep.tiles, expand_duplicates=False))
    t_r = best_of(lambda: count_matches_window_tiles(
        wp, prep.tiles, per_packet=True, expand_duplicates=False))
    t_h = best_of(lambda: window_stream_chunk(
        wp, xd[:, H:], rel, halo, expand_duplicates=False)[0])
    print(f"  resident XLA window engine, {nb} payload bytes: totals "
          f"{t_t:.6f} s, per-row {t_r:.6f} s; halo tile {x.shape} "
          f"{t_h:.6f} s", flush=True)
    mm = Matcher(pats)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(count_pcap_streamed(mm, udp, "udp"))
        ts.append(time.perf_counter() - t0)
    print(f"  count_pcap_streamed end to end: {ts} s", flush=True)


def multi_card(pats, big, udp, flow_pcap, n_cards: int) -> None:
    import jax

    from multithreading_string_matching import Matcher
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.parallel.flow_stream import (
        FlowStreamMatcher,
    )
    from multithreading_string_matching.parallel.mesh import (
        count_matches_sharded,
        make_mesh,
    )
    from multithreading_string_matching.parallel.pipeline import (
        count_pcap_streamed,
    )

    print(f"phase 6: {n_cards} cards vs one", flush=True)
    devs = jax.devices()[:n_cards]
    mesh = make_mesh(devs)
    batch = extract_payloads(read_pcap(udp), "udp")
    m = Matcher(pats)
    one = m.count_batch(batch)
    got = count_matches_sharded(
        m.cac, batch.payloads, batch.lengths, mesh,
        dup_map=m.window.dup_map, engine="window", window=m.window,
    )
    check(f"count_matches_sharded over Mesh(('packets',)) x{n_cards}",
          got, one)
    one_s = count_pcap_streamed(m, udp, "udp")
    check("count_pcap_streamed(sharded=True)",
          count_pcap_streamed(m, udp, "udp", sharded=True, mesh=mesh), one_s)
    mb = Matcher(big)
    one_b = count_pcap_streamed(mb, udp, "udp")
    check("3072 patterns, --shard-axis patterns",
          count_pcap_streamed(mb, udp, "udp", sharded=True,
                              shard_axis="patterns"), one_b)
    fpcap = read_pcap(flow_pcap)
    res = []
    for sharded in (False, True):
        fs = FlowStreamMatcher(Matcher(pats), "tcp",
                               engine=m.flow_stream_engine(), reorder=True,
                               scan_bytes=64 << 20, sharded=sharded,
                               mesh=mesh if sharded else None)
        fs.feed_pcap_slice(fpcap)
        fs.flush()
        res.append(fs.counts())
    check("FlowStreamMatcher(sharded=True)", res[1], res[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase, on four cards")
    args = ap.parse_args()
    if not (REPO / "tests" / "oracle.py").exists():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import jax

    from multithreading_string_matching.utils.cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < args.cards:
        fail(f"--cards {args.cards} needs {args.cards} GPUs, "
             f"JAX sees {len(devs)}")
    print("phase 1: card and stack", flush=True)
    card = card_line()
    print(f"  jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}, "
          f"{len(devs)} x {devs[0].device_kind}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        print("phase 2: data", flush=True)
        pats, big, udp, pat_file, flow_pcap = make_data(pathlib.Path(d))
        print(f"  made in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.cards == 1:
            one_card(pats, big, udp, pat_file, flow_pcap, card)
        else:
            multi_card(pats, big, udp, flow_pcap, args.cards)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
