"""Configuration dataclasses (the reference's positional-argv contract,
made explicit and serializable).

The reference's only "config system" is positional argv —
``<file.pcap> <strings.txt> [thread_count] [udp/tcp]`` (serial.c:3,
openmp_data.c:33-49) with UDP as the default (serial.c:31).  This module is
the framework-wide structured equivalent; every CLI subcommand and the
library API can be driven from one :class:`MatchConfig`, which round-trips
through JSON for reproducible runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class MatchConfig:
    # Consumers: [match] = the `match` subcommand, [live] = the `live`
    # subcommand (env vars only — its argv is the compat contract),
    # [lib] = library callers passing the field explicitly.
    pcap: str = ""                    # [match] capture file (or interface for live)
    patterns: str = ""                # [match] strings.txt-style pattern file
    mode: str = "udp"                 # [match] 'udp' | 'tcp' (serial.c default: udp)
    engine: str = "pallas"            # [match] 'pallas' (= 'window') | 'window' | 'ac' | 'kmp'
    strict: bool = False              # [match] enable the checks the reference omits
    bucketed: bool = True             # [match] length-bucketed execution
    per_packet: bool = False          # [match]
    batch_size: int = 100             # [lib] pipeline batch (openmp_task.c:113)
    stream_batch: int = 10            # [live] live batch (live_openmp_task.c:142)
    stream_window: int = 2048         # [live] streaming chunk width (bytes)
    stream_packed: str = "auto"       # [live] packed-tile dispatch: auto|0|1
    stream_tile_rows: int = 1024      # [live] packed-tile rows per dispatch
    host_workers: int = 0             # [match] threaded host stages for --stream
                                      #         (0 = sequential)
    flows: bool = False               # [match] 5-tuple flow reassembly
                                      #         (--flows; round-4 surface)
    reorder: bool = False             # [match] seq-aware TCP reassembly
                                      #         (--flows --reorder; round 5)
    n_tile: int = 2048                # [match] bucket tile rows
    l_quant: int = 128                # [match] bucket byte-length quantum (lanes)
    compat_output: bool = True        # [lib] byte-compatible report format
    profile_dir: Optional[str] = None # [match] jax.profiler trace output

    def validate(self) -> "MatchConfig":
        if self.mode not in ("udp", "tcp"):
            raise ValueError(f"mode must be udp or tcp, got {self.mode!r}")
        if self.engine not in ("auto", "pallas", "window", "ac", "kmp"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.stream_packed not in ("auto", "0", "1"):
            raise ValueError(
                f"stream_packed must be auto, 0 or 1, got {self.stream_packed!r}"
            )
        for f_ in ("batch_size", "stream_batch", "stream_window", "n_tile",
                   "l_quant", "stream_tile_rows"):
            if getattr(self, f_) <= 0:
                raise ValueError(f"{f_} must be positive")
        if self.host_workers < 0:
            raise ValueError("host_workers must be >= 0")
        return self

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "MatchConfig":
        data = json.loads(text)
        known = {f_.name for f_ in dataclasses.fields(MatchConfig)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return MatchConfig(**data).validate()

    @staticmethod
    def load(path: str) -> "MatchConfig":
        with open(path) as f:
            return MatchConfig.from_json(f.read())

    @staticmethod
    def from_env(base: Optional["MatchConfig"] = None) -> "MatchConfig":
        """Environment overrides: MSM_<FIELD> (upper-case field name).

        Returns a NEW config; ``base`` is never mutated (and is left intact
        if an override fails validation)."""
        cfg = dataclasses.replace(base) if base is not None else MatchConfig()
        for f_ in dataclasses.fields(MatchConfig):
            v = os.environ.get(f"MSM_{f_.name.upper()}")
            if v is None:
                continue
            if f_.type in ("bool", bool):
                val = v.lower() in ("1", "true", "yes")
            elif f_.type in ("int", int):
                val = int(v)
            else:
                val = v
            setattr(cfg, f_.name, val)
        return cfg.validate()
