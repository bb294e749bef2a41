from multithreading_string_matching.ops.scan import (
    count_matches_ac,
    count_matches_kmp,
    ac_scan_chunk,
)

__all__ = ["count_matches_ac", "count_matches_kmp", "ac_scan_chunk"]
