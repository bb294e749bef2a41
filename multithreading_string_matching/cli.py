"""Unified CLI — the five reference programs as subcommands (layer L5).

Reference argv contracts (SURVEY §5 config row):
  serial.c:            ./serial  <file.pcap> <strings.txt> [udp/tcp]
  openmp_data.c:       ./omp     <file.pcap> <strings.txt> <threads> [udp/tcp]
  openmp_task.c:       ./task    <file.pcap> <strings.txt> <threads> [udp/tcp]
  live_openmp_task.c:  ./live    <interface> <strings.txt> <threads> [udp/tcp]
  mpi_dumping.c:       mpirun ./mpi <file.pcap> <strings.txt> [udp/tcp]

Here::

  python -m multithreading_string_matching serial <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching data   <file.pcap> <strings.txt> [threads] [udp/tcp]
  python -m multithreading_string_matching task   <file.pcap> <strings.txt> [threads] [udp/tcp]
  python -m multithreading_string_matching live   <interface> <strings.txt> [threads] [udp/tcp]
  python -m multithreading_string_matching mesh   <file.pcap> <strings.txt> [udp/tcp]
  python -m multithreading_string_matching match  --pcap ... --patterns ... [options]

The thread-count argument sizes the HOST-side thread pool (parallel/host.py
threaded ingest/extract — the genuine analogue of ``num_threads``,
openmp_data.c:128): ``data`` extracts contiguous packet ranges on a pool,
``task`` threads the streamed read/extract stages, ``live`` prefetches tap
batches.  The device-side parallelism is unaffected — the packet axis is
vectorized on-chip and sharded across the device mesh (pass ``mesh`` to use
every device) — and counts are identical at any thread count (tested).
Output is byte-compatible with the reference's report (utils/report.py), so
``diff`` against serial.c's output validates parity.

Default packet type is UDP, as in serial.c:31.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def _mode_arg(tokens: List[str], default: str = "udp") -> str:
    """Parse the trailing [udp/tcp] token with the reference's strictness
    (anything else prints usage and exits 1, serial.c:42-45)."""
    if not tokens:
        return default
    if tokens[0] in ("udp", "tcp"):
        return tokens[0]
    raise SystemExit(f"unknown packet type {tokens[0]!r}: expected udp or tcp")


def _build(
    args_patterns: str,
    engine: str = "pallas",
    nocase: bool = False,
    syntax: str = "plain",
    bucketed: bool = True,
):
    from multithreading_string_matching.api import Matcher
    from multithreading_string_matching.io.patterns import load_patterns

    return Matcher(
        load_patterns(args_patterns, syntax=syntax),
        engine=engine, case_insensitive=nocase, bucketed=bucketed,
    )


def _execution_blob(
    matcher, sharded: bool, attribution: bool = False,
    actual: "str | None" = None, shard_axis: "str | None" = None,
) -> dict:
    """matcher.explain(), corrected for CLI-level remaps.

    ``actual`` (when the pipeline reported the engine it really resolved,
    via its stats dict) is authoritative — no rule re-derivation.  Without
    it, mirror the pipeline rules: the sharded counts paths have no
    per-pattern-DFA reducer and run kmp rule sets through AC; sharded
    ATTRIBUTION (per-row) is window-family only, so ac/kmp remap to window
    there, and PATTERN-axis sharding runs the window engine whatever was
    asked (identical counts either way)."""
    ex = matcher.explain()
    pattern_axis = shard_axis in ("patterns", "both")
    if actual is not None:
        if actual != ex["engine_resolved"]:
            ex["sharded_remap" if sharded else "streamed_remap"] = (
                f"{ex['engine_resolved']}->{actual}"
            )
            ex["engine_resolved"] = actual
        return ex
    if sharded and (
        (attribution and ex["engine_resolved"] in ("ac", "kmp"))
        or (pattern_axis and ex["engine_resolved"] != "window")
    ):
        ex["sharded_remap"] = f"{ex['engine_resolved']}->window"
        ex["engine_resolved"] = "window"
    elif sharded and ex["engine_resolved"] == "kmp":
        ex["engine_resolved"] = "ac"
        ex["sharded_remap"] = "kmp->ac"
    return ex


def _exact_counts(total) -> np.ndarray:
    """int32 counts unless the exact totals exceed it — then int64 (the
    same rule as the streamed paths; the reference's ``int string_count[]``
    wraps here, serial.c:163-169)."""
    total = np.asarray(total, dtype=np.int64)
    if total.size and total.max() > np.iinfo(np.int32).max:
        return total
    return total.astype(np.int32)


def _report(matcher, counts, elapsed, **kw):
    from multithreading_string_matching.utils.report import format_report

    print(format_report(matcher.patterns, counts, elapsed, **kw))


def cmd_serial(argv: List[str]) -> int:
    """serial.c analogue: one-shot scan of the whole file.

    Timing spans ingest + extract + match, matching serial.c:111-160 (the
    only reference program that times its pcap read)."""
    if len(argv) < 2:
        print("USAGE: serial <file.pcap> <strings.txt> [tcp/udp]")
        return 1
    mode = _mode_arg(argv[2:])
    matcher = _build(argv[1])
    start = time.perf_counter()
    counts = matcher.count_pcap(argv[0], mode)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


def _take_threads(argv: List[str]):
    """Parse the reference's positional thread-count argument.

    Returns ``(host_workers, rest)``: the count drives the framework's real
    host-parallelism knob (parallel/host.py threaded ingest/extract stages —
    the analogue of ``num_threads(thread_count)``, openmp_data.c:128).  A
    count of 0/1 or an absent argument maps to host_workers=0 (sequential:
    one OpenMP thread is no parallelism, and a 1-worker pool only adds
    handoff overhead — measured, CLAUDE.md)."""
    if argv and argv[0].isdigit():
        n = int(argv[0])
        return (n if n > 1 else 0), argv[1:]
    return 0, argv


def cmd_data(argv: List[str]) -> int:
    """openmp_data.c analogue: whole file in RAM, data-parallel on device.

    Timing excludes the pcap read (openmp_data.c:126 starts after ingest)."""
    if len(argv) < 2:
        print("USAGE: data <file.pcap> <strings.txt> [threads] [tcp/udp]")
        return 1
    from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
    from multithreading_string_matching.io.decode import extract_payloads

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    pcap = read_pcap(argv[0])
    start = time.perf_counter()
    if threads and pcap.num_packets:
        # The thread count sizes a real pool: contiguous packet ranges
        # extract on host worker threads (the native decode releases the
        # GIL), counts sum exactly — the host-side analogue of
        # openmp_data.c's packet-parallel region (:128-146).
        from multithreading_string_matching.parallel.host import map_prefetch

        per = -(-pcap.num_packets // threads)
        slices = [
            slice_pcap(pcap, s, min(s + per, pcap.num_packets), copy=False)
            for s in range(0, pcap.num_packets, per)
        ]
        batches = list(map_prefetch(
            lambda p: extract_payloads(
                p, mode, keep_invalid=True, pad_n_to=128, pad_len_to=8
            ),
            iter(slices), workers=threads,
        ))
        counts = np.sum(
            [matcher.count_batch(b) for b in batches], axis=0
        ).astype(np.int64)
    else:
        batch = extract_payloads(
            pcap, mode, keep_invalid=True, pad_n_to=128, pad_len_to=8
        )
        counts = matcher.count_batch(batch)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


def cmd_task(argv: List[str]) -> int:
    """openmp_task.c analogue: batched producer/consumer pipeline (batch=100)."""
    if len(argv) < 2:
        print("USAGE: task <file.pcap> <strings.txt> [threads] [tcp/udp]")
        return 1
    from multithreading_string_matching.parallel.pipeline import count_pcap_pipelined

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    start = time.perf_counter()
    counts = count_pcap_pipelined(matcher, argv[0], mode, host_workers=threads)
    elapsed = time.perf_counter() - start
    _report(matcher, counts, elapsed)
    return 0


def cmd_mesh(argv: List[str]) -> int:
    """mpi_dumping.c analogue: packet-sharded SPMD over the device mesh with
    a psum count merge (no Scatterv, no rank-0 funnel).

    Multi-host: set MSM_COORDINATOR / MSM_NUM_PROCESSES / MSM_PROCESS_ID on
    every host; each host ingests only its own packet range.  Rank 0 prints,
    as in mpi_dumping.c:208-215."""
    if len(argv) < 2:
        print("USAGE: mesh <file.pcap> <strings.txt> [tcp/udp]")
        return 1
    import jax

    from multithreading_string_matching.parallel.distributed import (
        count_pcap_distributed,
        initialize_from_env,
    )

    initialize_from_env()
    mode = _mode_arg(argv[2:])
    matcher = _build(argv[1])
    # Run the matcher's resolved engine per shard, exactly as every
    # reference rank runs its full-speed matcher (mpi_dumping.c:198-200).
    eng = matcher._resolve_engine(None)
    res = count_pcap_distributed(
        matcher, argv[0], mode, engine=eng if eng == "ac" else "window",
    )
    if jax.process_index() == 0:
        _report(matcher, res.counts, res.elapsed_max_s)
    return 0


def cmd_live(argv: List[str]) -> int:
    """live_openmp_task.c analogue: stream batches of 10 until SIGINT, then
    drain and report (prints sniffed-packet total and the "Oops!" line)."""
    dump_path = None
    if "--dump-matches" in argv:
        i = argv.index("--dump-matches")
        if i + 1 >= len(argv):
            print("USAGE: live ... --dump-matches <out.pcap>")
            return 1
        dump_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    if len(argv) < 2:
        print("USAGE: live <interface> <strings.txt> [threads] [tcp/udp] "
              "[--dump-matches out.pcap]")
        return 1
    from multithreading_string_matching.io.live import LiveSource, FileReplaySource
    from multithreading_string_matching.io.pcap import PcapWriter
    from multithreading_string_matching.parallel.stream import StreamMatcher
    import os

    threads, rest = _take_threads(argv[2:])
    mode = _mode_arg(rest)
    matcher = _build(argv[1])
    # An existing file path replays offline (testing hook); otherwise open
    # the named interface for real capture.  The source comes first: a
    # source-open failure must not leave a truncated dump file behind.
    # Real interfaces get the reference's capture setup: the kernel-level
    # "udp"/"tcp" BPF filter (pcap_setfilter, live_openmp_task.c:127-136)
    # and promiscuous mode (pcap_open_live promisc=1, :111-112; opt out
    # with MSM_LIVE_PROMISC=0).
    source = (
        FileReplaySource(argv[0])
        if os.path.exists(argv[0])
        else LiveSource(
            argv[0], filter_mode=mode,
            promiscuous=os.environ.get("MSM_LIVE_PROMISC", "1") != "0",
            # MSM_LIVE_RING=1 swaps the recv loop for the TPACKET_V3 mmap
            # ring (libpcap's own fast path): one poll per block instead
            # of one syscall per packet, kernel timestamps on every frame.
            ring=os.environ.get("MSM_LIVE_RING", "0") == "1",
        )
    )
    writer = PcapWriter(dump_path) if dump_path else None
    # Stream tuning comes from MSM_STREAM_BATCH / MSM_STREAM_WINDOW env vars
    # (the compat argv contract has no room for flags).
    from multithreading_string_matching.utils.config import MatchConfig

    env_cfg = MatchConfig.from_env()
    stream = StreamMatcher(
        matcher, batch_size=env_cfg.stream_batch,
        fixed_len=env_cfg.stream_window, dump_writer=writer,
        # Packed tiles (default 'auto': on for NUL-free pattern sets) keep
        # live throughput at the scan rate — one dispatch per full tile
        # instead of one per 10-packet batch.
        packed={"0": False, "1": True}.get(
            env_cfg.stream_packed, env_cfg.stream_packed
        ),
        tile_rows=env_cfg.stream_tile_rows,
    )
    # The handler must ALSO stop the source: on a quiet interface the recv
    # loop never yields a batch, so the between-batches stopped check below
    # would never run and Ctrl-C would hang the process (losing the report
    # the reference's signalHandler drain exists to save).
    stream.install_sigint(
        on_stop=source.stop if hasattr(source, "stop") else None
    )
    # SIGHUP = reload the rules file without dropping the tap (the daemon
    # idiom; the reference must be killed and restarted to change rules).
    # The handler only sets a flag — the swap happens between batches, and
    # a bad rules file is reported and IGNORED (a monitor must not die on a
    # bad rule push).
    import signal as _signal

    reload_flag = {"hup": False}
    old_hup = None
    if hasattr(_signal, "SIGHUP"):
        old_hup = _signal.signal(
            _signal.SIGHUP, lambda s, f: reload_flag.__setitem__("hup", True)
        )
    # Byte-exact start banner (live_openmp_task.c:152-153).
    print("\nWork in progress...\nPress ctrl+c to stop sniffing procedure")
    print(
        "You can stop the procedure only if at least one "
        f"{mode} packet has been read"
    )
    # The thread count sizes the live host pipeline: a prefetch thread pulls
    # batches off the tap while the main thread decodes/dispatches (the
    # reference's producer/worker split, live_openmp_task.c:162-227).  The
    # prefetch iterator is early-close safe, so SIGINT/stop still drains.
    if threads:
        from multithreading_string_matching.parallel.host import prefetch_iter

        batches = prefetch_iter(iter(source), depth=max(2, threads))
    else:
        batches = source
    try:
        for batch in batches:
            # bpf_filter: only protocol-matching packets count as sniffed,
            # like the reference's pcap_setfilter("udp"/"tcp") capture path.
            stream.feed_pcap_slice(batch, mode, bpf_filter=True)
            if stream.stopped:
                if hasattr(source, "stop"):
                    source.stop()
                break
            # The swap follows the feed, so the batch in hand when SIGHUP
            # lands is counted under the rules it arrived under.
            if reload_flag["hup"]:
                reload_flag["hup"] = False
                try:
                    new_matcher = _build(argv[1])
                    prev = stream.reload(new_matcher)
                except Exception as e:  # keep sniffing under the old rules
                    print(f"# rules reload failed, keeping old set: {e}",
                          file=sys.stderr)
                else:
                    from multithreading_string_matching.utils.report import (
                        format_report,
                    )

                    print("# rules reloaded; counts under the previous set:",
                          file=sys.stderr)
                    print(format_report(matcher.patterns, prev, None),
                          file=sys.stderr)
                    matcher = new_matcher
    except KeyboardInterrupt:
        pass
    finally:
        stream.uninstall_sigint()
        if old_hup is not None:
            _signal.signal(_signal.SIGHUP, old_hup)
        stream.flush()  # pending dump scan + partial tile, BEFORE close
        if writer is not None:
            writer.close()
    _report(
        matcher,
        stream.counts(),
        None,
        sniffed=stream.packets_seen,
        oops_line=True,
    )
    if writer is not None:
        # stderr keeps stdout byte-compatible with the reference's report.
        print(
            f"# wrote {writer.packets_written} matching packets to {dump_path}",
            file=sys.stderr,
        )
    return 0


def cmd_match(argv: List[str]) -> int:
    """Modern interface with explicit flags (non-compat)."""
    p = argparse.ArgumentParser(prog="match")
    p.add_argument(
        "--pcap", action="append",
        help="capture file; repeatable — multiple captures (e.g. rotated "
             "files) scan as one corpus, packets numbered in input order",
    )
    # Not argparse-required: a --config file may provide it (validated
    # after the merge, like --pcap).
    p.add_argument("--patterns")
    p.add_argument("--mode", choices=["udp", "tcp"], default=None)
    p.add_argument(
        "--engine",
        choices=["auto", "pallas", "window", "ac", "kmp"],
        default=None,
    )
    p.add_argument("--strict", action="store_true", help="enable the protocol checks the reference omits")
    p.add_argument(
        "--nocase", action="store_true",
        help="ASCII case-insensitive matching (patterns and payloads folded)",
    )
    p.add_argument(
        "--pattern-syntax", choices=["plain", "escaped"], default="plain",
        help="'escaped' decodes \\xNN / \\\\ per token, allowing binary "
             "patterns the reference's fscanf loader cannot express",
    )
    p.add_argument("--vlan", action="store_true", help="skip 802.1Q/802.1ad VLAN tags (up to two)")
    p.add_argument("--ipv6", action="store_true", help="also decode IPv6 frames (ethertype 0x86dd)")
    p.add_argument("--per-packet", action="store_true")
    p.add_argument(
        "--flows", action="store_true",
        help="reassemble TCP/UDP 5-tuple flows and scan the concatenated "
             "streams: signatures split across segments count (one-shot "
             "counts only; the reference's per-packet model misses these)",
    )
    p.add_argument(
        "--reorder", action="store_true",
        help="with --flows: order each TCP flow's segments by sequence "
             "number and drop retransmitted/overlapping bytes (first bytes "
             "win) before scanning — required for captures from real "
             "networks, which reorder and retransmit",
    )
    p.add_argument(
        "--offsets", action="store_true",
        help="also emit (packet, start, pattern) match positions",
    )
    p.add_argument(
        "--dump-matches", metavar="OUT.pcap",
        help="write the packets that contained at least one match to a new "
             "classic pcap (original bytes and timestamps preserved)",
    )
    p.add_argument("--sharded", action="store_true", help="use every device via the mesh")
    p.add_argument(
        "--shard-axis", choices=["auto", "packets", "patterns", "both"],
        default="auto",
        help="with --sharded: which axis to shard over the mesh — packets "
             "(classic data parallel), patterns (each device carries 1/N of "
             "the rule set; the large-rule-set form, ~N-fold on the ~1/U "
             "wall), both (2-D mesh), or auto (patterns for rule sets of "
             "more than 512 pattern words)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="with --stream: multi-host streamed counting "
             "(count_pcap_streamed_distributed; set MSM_COORDINATOR etc. "
             "on every host — single-process runs degenerate locally)",
    )
    p.add_argument(
        "--host-workers", type=int, default=0, metavar="N",
        help="with --stream: thread the host stages (prefetched ingest + "
             "N parallel extract workers); identical counts, faster wall "
             "clock on multi-core hosts",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="bounded-memory streaming scan (fixed packed tiles; any-size captures)",
    )
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR", help="write a jax.profiler trace")
    p.add_argument("--config", metavar="FILE", help="load a MatchConfig JSON (flags override)")
    a = p.parse_args(argv)

    from multithreading_string_matching.utils.config import MatchConfig

    cfg = MatchConfig.load(a.config) if a.config else MatchConfig()
    # Flags override the config ONLY when explicitly given (mode/engine parse
    # with default=None; the boolean flags can only turn features on, so an
    # unset flag never clobbers a config-file True).
    pcap_paths = a.pcap or ([cfg.pcap] if cfg.pcap else [])
    if not pcap_paths:
        raise SystemExit("match: --pcap is required (flag or config file)")
    cfg.pcap = pcap_paths[0]
    cfg.patterns = a.patterns or cfg.patterns
    if not cfg.patterns:
        raise SystemExit("match: --patterns is required (flag or config file)")
    cfg.mode = a.mode or cfg.mode
    cfg.engine = a.engine or cfg.engine
    cfg.strict = a.strict or cfg.strict
    cfg.per_packet = a.per_packet or cfg.per_packet
    cfg.flows = a.flows or cfg.flows
    cfg.reorder = a.reorder or cfg.reorder
    cfg.profile_dir = a.profile or cfg.profile_dir
    cfg.host_workers = a.host_workers or cfg.host_workers
    cfg.validate()
    if cfg.per_packet and not a.json:
        raise SystemExit("--per-packet produces an [N, P] matrix: use --json")

    import contextlib

    profiler_cm = contextlib.nullcontext()
    if cfg.profile_dir:
        import jax

        profiler_cm = jax.profiler.trace(cfg.profile_dir)
    # A real with-block: the trace closes on ANY exit path (errors included),
    # so a failed run still flushes a usable profile.
    with profiler_cm:
        return _run_match(a, cfg, pcap_paths)


def _run_match(a, cfg, pcap_paths) -> int:
    from multithreading_string_matching.io.pcap import read_pcap
    from multithreading_string_matching.io.decode import extract_payloads
    from multithreading_string_matching.utils.timing import PhaseTimer

    matcher = _build(
        cfg.patterns, engine=cfg.engine, nocase=a.nocase,
        syntax=a.pattern_syntax, bucketed=cfg.bucketed,
    )
    timer = PhaseTimer()
    shard_axis = a.shard_axis
    if a.sharded:
        if shard_axis == "auto":
            import jax

            from multithreading_string_matching.parallel.pattern_shard import (
                choose_shard_axis,
            )

            shard_axis = choose_shard_axis(matcher, len(jax.devices()))
    elif a.shard_axis != "auto":
        raise SystemExit("--shard-axis requires --sharded")
    if a.distributed and not a.stream:
        raise SystemExit("--distributed requires --stream (the one-shot "
                         "multi-host path is the `mesh` subcommand)")
    if cfg.host_workers and not a.stream:
        raise SystemExit("--host-workers requires --stream (the one-shot "
                         "path reads the capture in one pass)")
    if a.host_workers < 0:
        raise SystemExit("--host-workers must be >= 0")
    if cfg.flows and cfg.per_packet:
        raise SystemExit(
            "--flows does not compose with --per-packet (per-flow rows "
            "ARE the attribution unit; use --offsets for positions)"
        )
    if cfg.flows and a.dump_matches and a.stream:
        raise SystemExit(
            "--flows --dump-matches is one-shot only (the streamed flow "
            "monitor does not retain packets): drop --stream"
        )
    if cfg.flows and a.stream and a.distributed:
        # A silent single-host run would be worse than the error: per-flow
        # carried state cannot split across the coordinator's processes.
        raise SystemExit(
            "--flows --stream does not compose with --distributed "
            "(per-flow carried state is single-host; use --sharded for "
            "multi-device lanes)"
        )
    if cfg.reorder and not cfg.flows:
        raise SystemExit("--reorder requires --flows")
    if cfg.reorder and cfg.mode != "tcp":
        raise SystemExit("--reorder applies to TCP flows only")
    if cfg.flows and a.stream:
        # Bounded-memory flow serving: iter_pcap chunks feed the per-flow
        # carried-DFA stream matcher; pending bytes bounded by scan_bytes,
        # one int32 state per idle flow (parallel/flow_stream.py).
        from multithreading_string_matching.io.pcap import iter_pcap
        from multithreading_string_matching.parallel.flow_stream import (
            FlowStreamMatcher,
        )

        fse = matcher.flow_stream_engine()
        if a.offsets:
            # Streamed attribution needs the per-flow byte tail only the
            # window layout carries (the per-round find pass reads it);
            # counts are engine-identical, so the remap is free.
            # --sharded composes: the find pass is host-driven and
            # independent of how the count rounds shard their lanes.
            fse = "window"
        if a.sharded and a.shard_axis in ("patterns", "both"):
            # auto resolves to the lane axis here; only an EXPLICIT
            # pattern-axis request errors (per-flow carried state pins
            # each lane to its shard — the pattern axis cannot shard it).
            raise SystemExit(
                "--flows --stream shards the flow-lane axis only: drop "
                "--shard-axis or use --shard-axis packets"
            )
        fs = FlowStreamMatcher(matcher, cfg.mode, engine=fse,
                               reorder=cfg.reorder, ipv6=a.ipv6,
                               vlan=a.vlan, sharded=a.sharded,
                               collect_offsets=a.offsets)
        # SIGHUP = reload the rules file without dropping the stream (the
        # daemon idiom, same as the live subcommand; `--pcap - --stream
        # --flows` behind a tcpdump pipe IS the flow-monitor daemon).
        # Counts-only mode: with --offsets the old and new pattern index
        # spaces cannot share one report, so the handler stays default.
        import signal as _signal

        reload_flag = {"hup": False}
        old_hup = None
        if hasattr(_signal, "SIGHUP") and not a.offsets:
            old_hup = _signal.signal(
                _signal.SIGHUP,
                lambda s, f: reload_flag.__setitem__("hup", True),
            )
        # Chunk granularity = the reload/feed latency on a pipe: iter_pcap
        # yields only on a full batch or EOF, so a daemon that wants
        # responsive SIGHUP swaps on a slow tap lowers MSM_FLOW_BATCH
        # (scan rounds are still gated by scan_bytes, not batch size).
        import os

        flow_batch = int(os.environ.get("MSM_FLOW_BATCH", "8192"))
        from multithreading_string_matching.io.flows import (
            key_tuple_bytes,
        )

        # Attribution memory model: text mode emits each drained triple
        # as soon as its scan round completes (bounded — the daemon
        # shape); --json must hold them for the single final blob, the
        # same accumulate-for-one-report contract as the packet path's
        # streamed offsets.
        hits = [] if a.offsets else None
        json_hits = a.offsets and a.json

        def _emit_hits():
            if hits is None:
                return
            drained = fs.drain_offsets()
            if json_hits:
                hits.extend(drained)
                return
            uniq = fs.matcher.window.unique_patterns
            for k, o, u in drained:
                src, dst, sp, dp = key_tuple_bytes(k)
                print(f"flow {src}:{sp}->{dst}:{dp} @ {o}: "
                      f"{uniq[u].decode('latin-1')}")

        reloads = 0
        try:
            with timer.phase("scan"):
                for path in pcap_paths:
                    chunks = iter_pcap(path, batch_packets=flow_batch)
                    if cfg.host_workers:
                        # Threaded host stage: the next chunk parses on a
                        # background thread while this one decodes/feeds
                        # (ordered — flow reassembly needs capture order).
                        from multithreading_string_matching.parallel.host import (
                            prefetch_iter,
                        )

                        chunks = prefetch_iter(
                            iter(chunks), depth=max(2, cfg.host_workers)
                        )
                    for chunk in chunks:
                        if reload_flag["hup"]:
                            reload_flag["hup"] = False
                            try:
                                new_matcher = _build(
                                    cfg.patterns, engine=cfg.engine,
                                    nocase=a.nocase,
                                    syntax=a.pattern_syntax,
                                    bucketed=cfg.bucketed,
                                )
                                prev = fs.reload(new_matcher)
                            except Exception as e:  # keep the old rules
                                print(
                                    "# rules reload failed, keeping old "
                                    f"set: {e}", file=sys.stderr,
                                )
                            else:
                                reloads += 1
                                if a.json:
                                    import json as _json

                                    # Machine-readable epoch record: the
                                    # final blob's counts cover only the
                                    # LAST epoch (reload resets them).
                                    print(_json.dumps({
                                        "reload": reloads,
                                        "patterns": [
                                            pt.decode("latin-1")
                                            for pt in matcher.patterns
                                        ],
                                        "counts": prev.tolist(),
                                    }), file=sys.stderr)
                                else:
                                    from multithreading_string_matching.utils.report import (
                                        format_report,
                                    )

                                    print(
                                        "# rules reloaded; counts under "
                                        "the previous set:",
                                        file=sys.stderr,
                                    )
                                    print(
                                        format_report(
                                            matcher.patterns, prev, None
                                        ),
                                        file=sys.stderr,
                                    )
                                matcher = new_matcher
                        fs.feed_pcap_slice(chunk)
                        _emit_hits()
                fs.flush()
                _emit_hits()
        finally:
            if old_hup is not None:
                _signal.signal(_signal.SIGHUP, old_hup)
        counts = fs.counts()
        if a.json:
            import json

            blob = {
                "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
                "counts": counts.tolist(),
                "flows": fs.flows_seen,
                "flow_packets": fs.packets_seen,
                "stream_bytes": fs.bytes_seen,
                "phases": timer.phases,
                "execution": _execution_blob(matcher, False, actual=fse),
            }
            if reloads:
                # Epoch details went to stderr as JSON lines; the final
                # counts cover only the last epoch.
                blob["reloads"] = reloads
            if hits is not None:
                # Streamed attribution: keys ride inline (the flow set is
                # unbounded, there is no index table); offsets are byte
                # positions in the flow's REASSEMBLED stream.
                blob["offsets"] = [
                    [*key_tuple_bytes(k), int(o), int(u)]
                    for k, o, u in hits
                ]
                blob["unique_patterns"] = [
                    pt.decode("latin-1")
                    for pt in matcher.window.unique_patterns
                ]
            print(json.dumps(blob))
        else:
            # Text-mode offset triples were emitted incrementally above
            # (bounded memory for the daemon shape).
            _report(matcher, _exact_counts(counts), timer.total)
        return 0
    if cfg.flows:
        from multithreading_string_matching.io.flows import extract_flows
        from multithreading_string_matching.io.pcap import concat_pcaps

        with timer.phase("ingest"):
            pcap = concat_pcaps([read_pcap(p_) for p_ in pcap_paths])
        with timer.phase("extract"):
            fb = extract_flows(pcap, cfg.mode, reorder=cfg.reorder,
                               ipv6=a.ipv6, vlan=a.vlan)
        with timer.phase("scan"):
            flow_rows = None
            hit_flows = None
            if a.sharded and fb.num_flows == 0:
                # shard_batch needs at least one row; an empty capture's
                # answer is known anyway.
                counts = np.zeros(len(matcher.patterns), np.int64)
                if a.offsets:
                    flow_rows = np.zeros((0, 3), np.int64)
            elif a.sharded and (a.offsets or a.dump_matches):
                # Sharded flow attribution mirrors the packet path's rule:
                # ONE summary pass on the mesh (unique totals + hit-flow
                # flags reduced on device), then positions from the sparse
                # HIT flows only — never an unsharded full re-scan.
                if shard_axis in ("patterns", "both"):
                    from multithreading_string_matching.parallel.pattern_shard import (
                        count_rows_summary_pattern_sharded,
                        resolve_shard_mesh,
                    )

                    tot, hits = count_rows_summary_pattern_sharded(
                        matcher, fb.payloads, fb.lengths,
                        resolve_shard_mesh(shard_axis),
                    )
                else:
                    from multithreading_string_matching.parallel.mesh import (
                        count_rows_summary,
                        make_mesh,
                    )

                    tot, hits = count_rows_summary(
                        matcher, fb.payloads, fb.lengths, make_mesh(),
                    )
                counts = _exact_counts(tot[matcher.window.dup_map])
                hit = np.flatnonzero(hits)
                hit = hit[hit < fb.num_flows]  # padding rows cannot hit
                hit_flows = hit
                if a.offsets:
                    flow_rows = np.asarray(matcher.find_matches(
                        fb.payloads[hit], fb.lengths[hit]
                    ))
                    if flow_rows.size:
                        flow_rows = flow_rows.copy()
                        flow_rows[:, 0] = hit[flow_rows[:, 0]]
            elif a.sharded:
                if shard_axis in ("patterns", "both"):
                    from multithreading_string_matching.parallel.pattern_shard import (
                        count_matches_pattern_sharded,
                        resolve_shard_mesh,
                    )

                    counts = count_matches_pattern_sharded(
                        matcher, fb.payloads, fb.lengths,
                        resolve_shard_mesh(shard_axis), engine=cfg.engine,
                    )
                else:
                    from multithreading_string_matching.parallel.mesh import (
                        count_matches_sharded,
                        make_mesh,
                    )

                    eng = matcher._resolve_engine(cfg.engine)
                    if eng == "kmp":
                        eng = "ac"
                    counts = count_matches_sharded(
                        matcher.cac, matcher._maybe_fold(fb.payloads),
                        fb.lengths, make_mesh(),
                        dup_map=(matcher.ac.dup_map if eng == "ac"
                                 else matcher.window.dup_map),
                        engine=eng, window=matcher.window,
                    )
            elif a.offsets or a.dump_matches:
                # One find_matches pass serves counts AND positions (the
                # same one-scan rule as the packet path); positions are
                # byte offsets INTO THE REASSEMBLED STREAM, with the flow
                # 5-tuple alongside — and the hit-flow set when dumping.
                flow_rows = matcher.find_matches(fb.payloads, fb.lengths)
                counts = matcher.counts_from_match_rows(flow_rows)
            else:
                counts = matcher.count(fb.payloads, fb.lengths)
        if a.dump_matches:
            # Forensics shape: re-emit EVERY packet of every hit flow —
            # the full conversation around each alert, original bytes and
            # timestamps preserved (non-flow packets and clean flows
            # stay out).
            if hit_flows is None:
                rows_a = np.asarray(flow_rows) if flow_rows is not None \
                    else np.zeros((0, 3), np.int64)
                hit_flows = (
                    np.unique(rows_a[:, 0]) if rows_a.size
                    else np.zeros(0, np.int64)
                )
            hit_b = np.zeros(max(fb.num_flows, 1), bool)
            hit_b[np.asarray(hit_flows, np.int64)] = True
            fop = fb.flow_of_packet
            mask = (fop >= 0) & hit_b[np.clip(fop, 0, hit_b.size - 1)]
            from multithreading_string_matching.io.pcap import write_pcap

            write_pcap(a.dump_matches, pcap, mask)
        if a.json:
            import json

            blob = {
                "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
                "counts": np.asarray(counts).tolist(),
                "flows": fb.num_flows,
                "flow_packets": int((fb.flow_of_packet >= 0).sum()),
                "packets": fb.num_packets,
                "stream_bytes": fb.total_payload_bytes,
                "phases": timer.phases,
                "execution": _execution_blob(
                    matcher, a.sharded, attribution=a.offsets,
                    shard_axis=shard_axis if a.sharded else None,
                ),
            }
            if a.dump_matches:
                blob["dump_path"] = a.dump_matches
            if a.offsets and flow_rows is not None:
                # Each offset row carries the CAPTURE PACKET whose segment
                # holds the match's first byte — attribution back from the
                # reassembled stream to the wire (FlowBatch.packet_of_offset).
                blob["offsets"] = [
                    [int(f), int(i), int(u), fb.packet_of_offset(int(f), int(i))]
                    for f, i, u in np.asarray(flow_rows)
                ]
                blob["flow_keys"] = [
                    list(fb.key_tuple(f)) for f in range(fb.num_flows)
                ]
                blob["unique_patterns"] = [
                    pt.decode("latin-1")
                    for pt in matcher.window.unique_patterns
                ]
            print(json.dumps(blob))
        else:
            _report(matcher, _exact_counts(counts), timer.total)
            if a.offsets and flow_rows is not None:
                uniq = matcher.window.unique_patterns
                for f, i, u in np.asarray(flow_rows):
                    src, dst, sp, dp = fb.key_tuple(int(f))
                    pkt = fb.packet_of_offset(int(f), int(i))
                    print(f"flow {src}:{sp}->{dst}:{dp} @ {i} "
                          f"(packet {pkt}): {uniq[u].decode('latin-1')}")
        return 0
    if a.stream:
        if cfg.per_packet:
            raise SystemExit("--stream is incompatible with --per-packet")
        from multithreading_string_matching.parallel.pipeline import (
            count_pcap_streamed,
            scan_pcap_streamed,
        )

        if a.distributed and (a.dump_matches or a.offsets or a.sharded):
            raise SystemExit(
                "--distributed streaming is counts-only (per-host tiles, "
                "one end-of-run merge); drop --sharded/--offsets/"
                "--dump-matches"
            )
        stream_stats = {}
        stream_offsets = None
        with timer.phase("scan"):
            if a.distributed:
                from multithreading_string_matching.parallel.distributed import (
                    count_pcap_streamed_distributed,
                    initialize_from_env,
                )

                initialize_from_env()
                res = count_pcap_streamed_distributed(
                    matcher, pcap_paths, cfg.mode,
                    strict=cfg.strict, vlan=a.vlan, ipv6=a.ipv6,
                    engine=cfg.engine, stats=stream_stats,
                    host_workers=cfg.host_workers,
                )
                counts = res.counts
                import jax

                if jax.process_index() != 0:
                    # Rank-0 print parity with `mesh` / mpi_dumping.c:208.
                    return 0
            elif a.dump_matches or a.offsets:
                # Attribution wanted: the per-row streamed scanner
                # (sharded=True shards each chunk's rows over the mesh).
                res = scan_pcap_streamed(
                    matcher, pcap_paths, cfg.mode,
                    dump_path=a.dump_matches, offsets=a.offsets,
                    strict=cfg.strict, vlan=a.vlan, ipv6=a.ipv6,
                    stats=stream_stats, sharded=a.sharded,
                    shard_axis=shard_axis if a.sharded else "packets",
                    host_workers=cfg.host_workers,
                )
                counts, stream_offsets = res if a.offsets else (res, None)
            else:
                counts = count_pcap_streamed(
                    matcher, pcap_paths, cfg.mode,
                    strict=cfg.strict, vlan=a.vlan, ipv6=a.ipv6,
                    engine=cfg.engine, stats=stream_stats,
                    sharded=a.sharded,
                    shard_axis=shard_axis if a.sharded else "packets",
                    host_workers=cfg.host_workers,
                )
        # The pipeline reports the engine it ACTUALLY resolved through the
        # stats dict — authoritative over the blob's re-derived rules.
        actual_engine = stream_stats.pop("engine_resolved", None)
        if a.json:
            import json

            blob = {
                "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
                "counts": np.asarray(counts).tolist(),
                **stream_stats,  # packets / valid_payloads / payload_bytes
                "phases": timer.phases,
            }
            blob["execution"] = _execution_blob(
                matcher, a.sharded,
                attribution=bool(a.dump_matches or a.offsets),
                actual=actual_engine,
            )
            if a.sharded:
                blob["execution"]["shard_axis"] = shard_axis
            if a.dump_matches:
                blob["dump_path"] = a.dump_matches
            if stream_offsets is not None:
                blob["offsets"] = stream_offsets.tolist()
                blob["unique_patterns"] = [
                    pt.decode("latin-1") for pt in matcher.window.unique_patterns
                ]
            print(json.dumps(blob))
        else:
            _report(matcher, counts, timer.total)
            if stream_offsets is not None:
                uniq = matcher.window.unique_patterns
                for n, i, u in stream_offsets:
                    print(f"packet {n} @ {i}: {uniq[u].decode('latin-1')}")
            if a.dump_matches:
                print(
                    f"# wrote {stream_stats.get('dumped_packets', 0)} "
                    f"matching packets to {a.dump_matches}",
                    file=sys.stderr,
                )
        return 0
    with timer.phase("ingest"):
        from multithreading_string_matching.io.pcap import concat_pcaps

        pcap = concat_pcaps([read_pcap(p_) for p_ in pcap_paths])
    with timer.phase("extract"):
        batch = extract_payloads(
            pcap, cfg.mode, strict=cfg.strict, vlan=a.vlan, ipv6=a.ipv6,
            pad_n_to=128, pad_len_to=8,
        )
    with timer.phase("scan"):
        offsets = None
        hit_rows = None
        sharded_attr = a.sharded and (
            cfg.per_packet or a.dump_matches or a.offsets
        )
        if a.sharded and not sharded_attr:
            if shard_axis in ("patterns", "both"):
                # Pattern-axis sharding: each device scans all packets with
                # 1/N of the rule set (parallel.pattern_shard) — the
                # large-rule-set form the ~1/U law rewards ~N-fold.
                from multithreading_string_matching.parallel.pattern_shard import (
                    count_matches_pattern_sharded,
                    resolve_shard_mesh,
                )

                counts = count_matches_pattern_sharded(
                    matcher, batch.payloads, batch.lengths,
                    resolve_shard_mesh(shard_axis), engine=cfg.engine,
                )
            else:
                from multithreading_string_matching.parallel.mesh import (
                    make_mesh,
                    count_matches_sharded,
                )

                eng = matcher._resolve_engine(cfg.engine)
                if eng == "kmp":
                    eng = "ac"
                counts = count_matches_sharded(
                    matcher.cac, matcher._maybe_fold(batch.payloads),
                    batch.lengths, make_mesh(),
                    dup_map=matcher.ac.dup_map if eng == "ac" else matcher.window.dup_map,
                    engine=eng, window=matcher.window,
                )
        elif sharded_attr:
            # Attribution under the mesh: ONE sharded per-row pass serves
            # --per-packet / --dump-matches / --offsets (rows keep their
            # identity — no collective).  Without --per-packet the matrix
            # never leaves the devices (count_rows_summary); positions are
            # then extracted from the sparse HIT rows only, so --sharded
            # never degrades to an unsharded full-corpus re-scan.
            if shard_axis in ("patterns", "both"):
                from multithreading_string_matching.parallel.pattern_shard import (
                    count_rows_pattern_sharded,
                    count_rows_summary_pattern_sharded,
                    resolve_shard_mesh,
                )

                mesh = resolve_shard_mesh(shard_axis)
                if cfg.per_packet:
                    per_row = count_rows_pattern_sharded(
                        matcher, batch.payloads, batch.lengths, mesh,
                    )
                    counts = per_row
                    hit_rows = np.flatnonzero(per_row.sum(axis=1) > 0)
                else:
                    tot, hits = count_rows_summary_pattern_sharded(
                        matcher, batch.payloads, batch.lengths, mesh,
                    )
                    counts = _exact_counts(tot[matcher.window.dup_map])
                    hit_rows = np.flatnonzero(hits)
            else:
                from multithreading_string_matching.parallel.mesh import (
                    count_rows_sharded,
                    count_rows_summary,
                    make_mesh,
                )

                mesh = make_mesh()
                if cfg.per_packet:
                    per_row = count_rows_sharded(
                        matcher, batch.payloads, batch.lengths, mesh,
                    )
                    counts = per_row
                    hit_rows = np.flatnonzero(per_row.sum(axis=1) > 0)
                else:
                    tot, hits = count_rows_summary(
                        matcher, batch.payloads, batch.lengths, mesh,
                    )
                    counts = _exact_counts(tot[matcher.window.dup_map])
                    hit_rows = np.flatnonzero(hits)
            # Padding rows (length 0) cannot hit, but keep the row->packet
            # map defensive: only rows that correspond to valid packets.
            hit_rows = hit_rows[hit_rows < int(batch.valid.sum())]
            if a.offsets:
                rows = np.asarray(matcher.find_matches(
                    batch.payloads[hit_rows], batch.lengths[hit_rows]
                ))
                if rows.size:
                    rows = rows.copy()
                    rows[:, 0] = hit_rows[rows[:, 0]]
                offsets = rows
        if a.sharded:
            pass  # counts/offsets/hit_rows computed above — the unsharded
            # chain below must not clobber them
        elif a.offsets and not cfg.per_packet:
            # One find_matches scan yields ALL the outputs: the occurrence
            # rows ARE the counts (bincount over unique patterns, dup_map
            # expanded), the offsets, and the dump selection (rows with any
            # hit) — a separate count_batch pass would scan the corpus twice.
            rows = np.asarray(
                matcher.find_matches(batch.payloads, batch.lengths)
            )
            counts = _exact_counts(matcher.counts_from_match_rows(rows))
            hit_rows = (
                np.unique(rows[:, 0]) if rows.size else np.zeros(0, np.int64)
            )
            offsets = rows
        elif a.dump_matches and not cfg.per_packet:
            # The dump needs row-level attribution; the aggregate counts are
            # the exact column sums of the per-row matrix (tested invariant),
            # so one per-row scan serves both outputs.
            per_row = np.asarray(matcher.count_batch(
                batch, per_packet=True, n_tile=cfg.n_tile, l_quant=cfg.l_quant,
            ))
            counts = _exact_counts(per_row.sum(axis=0, dtype=np.int64))
        else:
            counts = matcher.count_batch(
                batch, per_packet=cfg.per_packet,
                n_tile=cfg.n_tile, l_quant=cfg.l_quant,
            )
            if cfg.per_packet:
                per_row = np.asarray(counts)
        if a.offsets and offsets is None:
            offsets = np.asarray(
                matcher.find_matches(batch.payloads, batch.lengths)
            )
    valid_idx = np.flatnonzero(batch.valid)
    if offsets is not None and len(offsets):
        # Report ORIGINAL capture packet numbers (find_matches rows index the
        # valid payload rows): consistent with --dump-matches and with what a
        # user sees in wireshark on a mixed-protocol capture.
        offsets = np.asarray(offsets).copy()
        offsets[:, 0] = valid_idx[offsets[:, 0]]
    dumped = None
    if a.dump_matches:
        from multithreading_string_matching.io.pcap import write_pcap

        # Payload rows are the valid packets in file order (padding rows are
        # zero-length and cannot match); map matched rows back to original
        # packet indices and re-emit those records verbatim.
        if hit_rows is None:
            hit_rows = np.flatnonzero(per_row[: valid_idx.size].sum(axis=1) > 0)
        dumped = write_pcap(a.dump_matches, pcap, valid_idx[hit_rows])
    if a.json:
        import json

        blob = {
            "patterns": [pt.decode("latin-1") for pt in matcher.patterns],
            "counts": np.asarray(counts).tolist(),
            "packets": batch.num_packets,
            "valid_payloads": int(batch.valid.sum()),
            "payload_bytes": batch.total_payload_bytes,
            "phases": timer.phases,
            "execution": _execution_blob(
                matcher, a.sharded, attribution=sharded_attr,
                shard_axis=shard_axis if a.sharded else None,
            ),
        }
        if a.sharded:
            blob["execution"]["shard_axis"] = shard_axis
        if offsets is not None:
            blob["offsets"] = offsets.tolist()  # (packet, start, unique_pattern)
            blob["unique_patterns"] = [
                pt.decode("latin-1") for pt in matcher.window.unique_patterns
            ]
        if dumped is not None:
            blob["dump_path"] = a.dump_matches
            blob["dumped_packets"] = dumped
        print(json.dumps(blob))
    else:
        _report(matcher, counts, timer.total)
        if offsets is not None:
            uniq = matcher.window.unique_patterns
            for n, i, u in offsets:
                print(f"packet {n} @ {i}: {uniq[u].decode('latin-1')}")
        if dumped is not None:
            print(
                f"# wrote {dumped} matching packets to {a.dump_matches}",
                file=sys.stderr,
            )
        print(f"# {timer.summary()}", file=sys.stderr)
    return 0


def cmd_synth(argv: List[str]) -> int:
    """Generate a synthetic UDP capture (mega_udp.pcap stand-in).

    USAGE: synth <out.pcap> <num_packets> [payload_len] [strings.txt]
    """
    if len(argv) < 2:
        print("USAGE: synth <out.pcap> <num_packets> [payload_len] [strings.txt]")
        return 1
    from multithreading_string_matching.io.synth import synth_udp_pcap
    from multithreading_string_matching.io.patterns import load_patterns

    payload_len = int(argv[2]) if len(argv) > 2 else 1024
    patterns = load_patterns(argv[3]) if len(argv) > 3 else None
    total = synth_udp_pcap(
        argv[0],
        int(argv[1]),
        payload_len=payload_len,
        payload_len_jitter=payload_len // 4,
        patterns=patterns,
        plant_rate=0.05,
        invalid_rate=0.02,
    )
    print(f"wrote {argv[0]}: {argv[1]} packets, {total} payload bytes")
    return 0


COMMANDS = {
    "serial": cmd_serial,
    "data": cmd_data,
    "task": cmd_task,
    "live": cmd_live,
    "mesh": cmd_mesh,
    "mpi": cmd_mesh,  # alias: the MPI program's role
    "match": cmd_match,
    "synth": cmd_synth,
}


def main(argv: Optional[List[str]] = None) -> int:
    import os

    import jax

    from multithreading_string_matching.utils.cache import (
        enable_compile_cache,
    )

    # MSM_PLATFORM=cpu|gpu forces the JAX backend in-process.
    platform = os.environ.get("MSM_PLATFORM")
    if platform:
        if platform not in ("cpu", "gpu"):
            print(f"MSM_PLATFORM must be cpu or gpu, got {platform!r}",
                  file=sys.stderr)
            return 1
        jax.config.update("jax_platforms", platform)
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r}; one of {sorted(COMMANDS)}")
        return 1
    try:
        return cmd(argv[1:])
    except FileNotFoundError as e:
        # Reference behavior: perror + exit(1) on fopen/pcap_open failure
        # (serial.c:60-63,92-95).
        print(f"error opening file: {e.filename or e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
