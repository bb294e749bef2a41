from multithreading_string_matching.io.patterns import load_patterns
from multithreading_string_matching.io.pcap import read_pcap, iter_pcap, write_pcap, concat_pcaps, open_capture, PcapFile
from multithreading_string_matching.io.decode import extract_payloads, PayloadBatch
from multithreading_string_matching.io.flows import (
    FlowBatch,
    count_flows_chunked,
    extract_flows,
)

__all__ = [
    "FlowBatch",
    "extract_flows",
    "count_flows_chunked",
    "load_patterns",
    "read_pcap",
    "iter_pcap",
    "open_capture",
    "write_pcap",
    "concat_pcaps",
    "PcapFile",
    "extract_payloads",
    "PayloadBatch",
]
