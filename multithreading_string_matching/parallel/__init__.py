from multithreading_string_matching.parallel.mesh import (
    make_mesh,
    count_matches_sharded,
    shard_batch,
)
from multithreading_string_matching.parallel.pattern_shard import (
    count_matches_pattern_sharded,
    count_rows_pattern_sharded,
    make_pattern_mesh,
    make_2d_mesh,
)
from multithreading_string_matching.parallel.pipeline import count_pcap_pipelined
from multithreading_string_matching.parallel.stream import StreamMatcher
from multithreading_string_matching.parallel.flow_stream import FlowStreamMatcher

__all__ = [
    "FlowStreamMatcher",
    "count_matches_pattern_sharded",
    "count_rows_pattern_sharded",
    "make_pattern_mesh",
    "make_2d_mesh",
    "make_mesh",
    "count_matches_sharded",
    "shard_batch",
    "count_pcap_pipelined",
    "StreamMatcher",
]
