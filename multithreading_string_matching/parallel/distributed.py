"""Multi-host distributed matching — the full mpi_dumping.c replacement.

Reference shape (mpi_dumping.c): MPI_Init (:29), rank 0 reads the WHOLE pcap
(:107-134), MPI_Scatterv ships fixed 65,539-byte packet records to every
rank (:161), ranks match their shard (:173-200), MPI_Reduce(SUM) merges
counts at rank 0 (:202), MPI_Reduce(MAX) merges elapsed (:206).

Shape of this module:

1. ``jax.distributed.initialize()`` replaces MPI_Init — one JAX process per
   host, driving every card of that host; the cards of all hosts form one
   global device mesh.  (One process per host, never one per card: a JAX
   process reserves most of each card's memory when it starts, so two
   processes on one card fail.)
2. NO Scatterv and NO rank-0 I/O funnel: every host reads only ITS packet
   range of the capture directly (``read_pcap_range``), so ingest bandwidth
   scales with hosts instead of being serialized through rank 0 (the
   reference's scalability ceiling — rank 0 must hold all packets at 64 KiB
   each).
3. The pattern program is replicated per host, exactly as every MPI rank
   re-reads strings.txt and rebuilds its prefix tables (mpi_dumping.c:75-97).
4. Per-host shards become ONE global array via
   ``jax.make_array_from_process_local_data``; the count merge is a single
   ``psum`` (NCCL; mesh.py), replicated to every host — no
   root-rank asymmetry.
5. Elapsed time is max-reduced across hosts (``process_allgather`` + max),
   the MPI_Reduce(MAX) analogue (mpi_dumping.c:203-206).

Single-process runs degenerate to the local mesh path, so the same code
serves one card to many hosts.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from multithreading_string_matching.io.pcap import read_pcap, slice_pcap
from multithreading_string_matching.io.decode import extract_payloads
from multithreading_string_matching.parallel.mesh import (
    PACKET_AXIS,
    _sharded_count,
    _sharded_count_window,
    make_mesh,
)


def initialize_from_env() -> bool:
    """Join the process group if coordinator env vars are present.

    Set ``MSM_COORDINATOR`` (host:port), ``MSM_NUM_PROCESSES``, and
    ``MSM_PROCESS_ID`` on every host — the mrahtz/mpi-vagrant analogue
    (README.md:19) without mpirun.  Run ONE process per host: it drives all
    of that host's cards (see the module docstring).  Returns True if
    distributed mode is on.
    """
    coord = os.environ.get("MSM_COORDINATOR")
    if not coord:
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["MSM_NUM_PROCESSES"]),
        process_id=int(os.environ["MSM_PROCESS_ID"]),
    )
    return True


@dataclass
class DistributedResult:
    counts: np.ndarray          # over the original (duplicated) pattern list
    elapsed_max_s: float        # slowest host's extract+scan time (MPI_Wtime analogue)
    local_packets: int
    local_payload_bytes: int


def count_pcap_distributed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    strict: bool = False,
    engine: str = "window",
    mesh=None,
) -> DistributedResult:
    """Count patterns over a pcap sharded across all participating hosts.

    Every shard runs the same engine, exactly as each reference MPI rank
    runs the same KMP hot loop as serial (mpi_dumping.c:198-200):
    'window' (default) or 'ac'; 'pallas' resolves through
    api.select_engine (to 'window').
    """
    if engine not in ("window", "ac", "pallas"):
        raise ValueError(
            f"count_pcap_distributed supports engine 'pallas', 'window' or "
            f"'ac', got {engine!r}"
        )
    engine = matcher._resolve_engine(engine)
    procs = jax.process_count()
    rank = jax.process_index()
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    # --- per-host ingest of this host's packet range (no rank-0 funnel) ---
    # Each host walks the record chain (cheap native walk) and keeps only its
    # contiguous range.
    #
    # Failure detection (the reference's one distributed error path,
    # mpi_dumping.c:105-142: rank 0 broadcasts flag=-1 on pcap-open failure so
    # every rank finalizes cleanly): the ingest-error flag is allgathered as
    # the FIRST collective, so a host whose open failed never leaves peers
    # hanging in a later collective — every host raises, none deadlocks.
    exc: Optional[BaseException] = None
    full = None
    try:
        full = read_pcap(pcap_path)
        total_packets = full.num_packets
    except (FileNotFoundError, ValueError, OSError) as e:
        exc, total_packets = e, 0
    if procs > 1:
        from jax.experimental import multihost_utils

        flags = multihost_utils.process_allgather(
            jnp.asarray([0 if exc is None else 1])
        )
        if int(np.asarray(flags).sum()):
            raise RuntimeError(
                "pcap ingest failed on at least one host; all hosts aborting"
            ) from exc
    elif exc is not None:
        raise exc
    share = -(-total_packets // procs)
    start, stop = rank * share, min(total_packets, (rank + 1) * share)
    pcap = slice_pcap(full, start, stop)
    del full  # keep only this host's byte range resident

    t0 = time.perf_counter()
    batch = extract_payloads(pcap, mode, strict=strict, keep_invalid=True)

    # --- agree on a global padded width (hosts may differ) ---
    local_l = batch.payloads.shape[1]
    if procs > 1:
        from jax.experimental import multihost_utils

        all_l = multihost_utils.process_allgather(jnp.asarray([local_l]))
        global_l = int(np.max(np.asarray(all_l)))
    else:
        global_l = local_l
    global_l = -(-global_l // 128) * 128

    # Pad this host's rows to exactly `share` and width to global_l; padding
    # rows are length-0 (masked by the scan).  Case-insensitive matchers
    # fold bytes BEFORE staging (idempotent) — the automata/kernels bake
    # folded patterns, so unfolded payloads would silently undercount
    # (every other parallel path folds here too).
    payloads = matcher._maybe_fold(batch.payloads)
    lengths = batch.lengths
    if payloads.shape[1] < global_l:
        payloads = np.pad(payloads, ((0, 0), (0, global_l - payloads.shape[1])))
    # Row count must cover the ACTUAL local rows (extract_payloads returns at
    # least one padded row even for an empty range) and be a multiple of the
    # per-process device count so the global array shards evenly; guard
    # against more processes than devices.
    dev_per_proc = max(1, n_dev // procs)
    need = max(share, payloads.shape[0])
    rows = max(-(-need // dev_per_proc), 1) * dev_per_proc
    if payloads.shape[0] < rows:
        pad = rows - payloads.shape[0]
        payloads = np.pad(payloads, ((0, pad), (0, 0)))
        lengths = np.pad(lengths, (0, pad))

    # --- assemble the global sharded array from per-host shards ---
    sharding = NamedSharding(mesh, P(axis))
    if procs > 1:
        g_pay = jax.make_array_from_process_local_data(
            sharding, payloads, (rows * procs, global_l)
        )
        g_len = jax.make_array_from_process_local_data(
            sharding, lengths, (rows * procs,)
        )
    else:
        g_pay = jax.device_put(jnp.asarray(payloads, jnp.uint8), sharding)
        g_len = jax.device_put(jnp.asarray(lengths, jnp.int32), sharding)

    # --- SPMD scan + psum merge ---
    if engine == "window":
        w = matcher.window
        counts_u = _sharded_count_window(
            jnp.asarray(w.pat_words), jnp.asarray(w.pat_masks),
            jnp.asarray(w.pat_lens), g_pay, g_len, mesh=mesh, axis=axis,
        )
    else:
        cac = matcher.cac
        counts_u = _sharded_count(
            cac.goto_flat, cac.emit_ids, cac.emit_sub,
            g_pay, g_len, dead=cac.dead, mesh=mesh, axis=axis,
        )
    dup = matcher.ac.dup_map if engine == "ac" else matcher.window.dup_map
    counts = np.asarray(counts_u)[dup]
    elapsed = time.perf_counter() - t0

    # --- elapsed = max over hosts (MPI_Reduce MAX analogue) ---
    if procs > 1:
        from jax.experimental import multihost_utils

        all_e = multihost_utils.process_allgather(jnp.asarray([elapsed]))
        elapsed = float(np.max(np.asarray(all_e)))

    return DistributedResult(
        counts=counts,
        elapsed_max_s=elapsed,
        local_packets=pcap.num_packets,
        local_payload_bytes=int(batch.lengths.sum()),
    )


def _allgather_int64(local: np.ndarray) -> np.ndarray:
    """SUM of an int64 vector across processes, exactly.

    ``process_allgather`` goes through jnp, which silently downcasts int64
    to int32 without the x64 flag — so ship (lo, hi) uint32 halves and
    reassemble host-side."""
    from jax.experimental import multihost_utils

    lo = (local & 0xFFFFFFFF).astype(np.uint32)
    hi = (local >> 32).astype(np.uint32)
    g = np.asarray(
        multihost_utils.process_allgather(
            jnp.stack([jnp.asarray(lo), jnp.asarray(hi)])
        )
    ).reshape(-1, 2, local.shape[0])  # [procs, 2, P]
    return (
        g[:, 0].astype(np.int64) + (g[:, 1].astype(np.int64) << 32)
    ).sum(axis=0)


def count_pcap_streamed_distributed(
    matcher,
    pcap_path,
    mode: str = "udp",
    *,
    batch_packets: int = 8192,
    tile_rows: int = 4096,
    pack_width: int = 2048,
    strict: bool = False,
    vlan: bool = False,
    ipv6: bool = False,
    engine: Optional[str] = None,
    stats: Optional[dict] = None,
    host_workers: int = 0,
) -> DistributedResult:
    """Bounded-memory multi-host streaming scan — the serving shape of
    :func:`count_pcap_distributed` for captures larger than any host's RAM.

    ``host_workers >= 1`` threads EACH host's ingest/extract stages
    (parallel.host combinators — per-host, no cross-host interaction);
    chunk→rank assignment and counts are identical either way.

    Where the one-shot path materializes the whole capture per host before
    sharding, here every host streams it (``iter_pcap``) and scans only the
    chunks whose index ≡ its rank (mod processes) — deterministic
    round-robin needs no up-front packet count and balances heavy-tailed
    captures.  Each host's chunks pack into fixed tiles on ITS OWN devices
    (``PackedTileCounter``) with NO per-tile collective: hosts may process unequal tile
    counts, so the collective schedule must not depend on them.  The whole
    run has exactly three collectives, all at the end — error flag, count
    merge, MAX-elapsed — the streaming analogue of mpi_dumping.c's single
    MPI_Reduce(SUM)+Reduce(MAX) (:202-206), with the error-flag-first
    discipline of the one-shot path (no host can deadlock a peer).

    NUL-containing pattern sets (sequence packing inexact) scan per-chunk
    through the bucketed one-shot engine instead — still bounded-memory,
    still local-only until the final merge.  Counts are exact int64
    host-side (int32 on return when they fit); single-process runs
    degenerate to the local streamed scan.
    """
    from multithreading_string_matching.parallel.pipeline import (
        PackedTileCounter,
        _iter_pcap_paths,
    )

    procs = jax.process_count()
    rank = jax.process_index()
    t0 = time.perf_counter()
    exc: Optional[BaseException] = None
    local = np.zeros(len(matcher.patterns), dtype=np.int64)
    n_pkts = n_valid = n_bytes = 0
    nul = any(0 in p for p in matcher.window.unique_patterns)
    # Multi-chip hosts shard each tile over THEIR OWN devices (a
    # local-devices mesh — its psum never crosses hosts, so per-host tile
    # imbalance still cannot desynchronize anything); single-chip hosts
    # run the plain counter.
    local_devs = jax.local_devices()
    counter = None if nul else PackedTileCounter(
        matcher, engine=engine, tile_rows=tile_rows, pack_width=pack_width,
        sharded=len(local_devs) > 1,
        mesh=make_mesh(local_devs) if len(local_devs) > 1 else None,
    )
    if stats is not None:
        # The engine the run ACTUALLY uses (incl. the counter's sharded
        # kmp->ac remap; NUL sets scan per-chunk with the resolved engine).
        stats["engine_resolved"] = (
            counter.engine if counter is not None
            else matcher._resolve_engine(engine)
        )
    def _my_batches():
        # Round-robin chunk selection happens on the INGEST side of the
        # thread boundary: every host walks the capture, extracts only its
        # own chunks.
        src = (
            c
            for i, c in enumerate(_iter_pcap_paths(pcap_path, batch_packets))
            if i % procs == rank
        )

        def ex(chunk):
            return extract_payloads(
                chunk, mode, strict=strict, vlan=vlan, ipv6=ipv6
            )

        if host_workers:
            from multithreading_string_matching.parallel.host import (
                map_prefetch,
                prefetch_iter,
            )

            yield from map_prefetch(
                ex, prefetch_iter(src, depth=max(2, host_workers)),
                workers=host_workers,
            )
            return
        for chunk in src:
            yield ex(chunk)

    try:
        for batch in _my_batches():
            n_pkts += batch.num_packets
            n_valid += int(batch.valid.sum())
            n_bytes += batch.total_payload_bytes
            if counter is not None:
                counter.add(batch.payloads, batch.lengths)
            else:
                local += np.asarray(
                    matcher.count(batch.payloads, batch.lengths, engine=engine)
                ).astype(np.int64)
        if counter is not None:
            local += counter.totals()
    except (FileNotFoundError, ValueError, OSError) as e:
        exc = e
    elapsed = time.perf_counter() - t0

    if procs > 1:
        from jax.experimental import multihost_utils

        flags = multihost_utils.process_allgather(
            jnp.asarray([0 if exc is None else 1])
        )
        if int(np.asarray(flags).sum()):
            raise RuntimeError(
                "pcap ingest failed on at least one host; all hosts aborting"
            ) from exc
        # Merge counts AND the ingest stats in the same exact-int64
        # collective (each host streamed only its chunks; the caller's
        # stats must describe the whole capture, not one rank's share).
        merged = _allgather_int64(np.concatenate([
            local, np.array([n_pkts, n_valid, n_bytes], dtype=np.int64),
        ]))
        counts, (g_pkts, g_valid, g_bytes) = merged[:-3], merged[-3:]
        all_e = multihost_utils.process_allgather(jnp.asarray([elapsed]))
        elapsed = float(np.max(np.asarray(all_e)))
    else:
        if exc is not None:
            raise exc
        counts = local
        g_pkts, g_valid, g_bytes = n_pkts, n_valid, n_bytes
    if stats is not None:
        stats.update(
            packets=int(g_pkts), valid_payloads=int(g_valid),
            payload_bytes=int(g_bytes),
        )
    if not (counts.size and counts.max() > np.iinfo(np.int32).max):
        counts = counts.astype(np.int32)
    return DistributedResult(
        counts=counts,
        elapsed_max_s=elapsed,
        local_packets=n_pkts,
        local_payload_bytes=n_bytes,
    )
