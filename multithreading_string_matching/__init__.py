"""multithreading_string_matching — a packet-payload string-matching framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
suite Lemnon95/multithreading_string_matching (five C programs: serial.c,
openmp_data.c, openmp_task.c, live_openmp_task.c, mpi_dumping.c), built for
an accelerator (an NVIDIA GPU; every path also runs on the CPU):

- ``io``       — pcap ingest, vectorized protocol decode, pattern loading,
                 live/streaming sources (reference L0-L2).
- ``models``   — pattern-matching automata compiled on the host into dense
                 tensor form: per-pattern KMP counting DFAs and a single
                 multi-pattern Aho-Corasick automaton (reference L3,
                 serial.c:190-238 semantics).
- ``ops``      — device engines: branch-free DFA byte scans as lax.scan and
                 the shifted-window compare matcher, vectorized across
                 packets (reference hot loops).
- ``parallel`` — mesh sharding, psum count reduction, batched pipelines and
                 carried-state streaming (reference L4: OpenMP/MPI analogues).
- ``utils``    — phase timers, compat reporting, configuration.

Counting semantics are the explicit-payload-length reading of serial.c
(variant A in BASELINE.md): every overlapping occurrence of every pattern
(duplicates included, file order preserved) within exactly ``payload_len``
bytes of each valid payload.
"""

__version__ = "0.1.0"

from multithreading_string_matching.io.patterns import load_patterns
from multithreading_string_matching.io.pcap import read_pcap, iter_pcap, write_pcap, concat_pcaps, open_capture
from multithreading_string_matching.io.decode import extract_payloads, PayloadBatch
from multithreading_string_matching.models.kmp import lps_table, kmp_dfa, stack_kmp_dfas
from multithreading_string_matching.models.aho_corasick import AhoCorasick
from multithreading_string_matching.ops.scan import count_matches_kmp, count_matches_ac
from multithreading_string_matching.api import Matcher

__all__ = [
    "load_patterns",
    "read_pcap",
    "iter_pcap",
    "open_capture",
    "write_pcap",
    "concat_pcaps",
    "extract_payloads",
    "PayloadBatch",
    "lps_table",
    "kmp_dfa",
    "stack_kmp_dfas",
    "AhoCorasick",
    "count_matches_kmp",
    "count_matches_ac",
    "Matcher",
    "__version__",
]
