"""Parser robustness fuzz: arbitrary bytes must never crash the readers with
anything but ValueError (the contract CLI error handling and the distributed
all-host abort dispatch on).
"""

import numpy as np
import pytest

from multithreading_string_matching import extract_payloads, read_pcap


def _try(path):
    try:
        pc = read_pcap(path)
        # decode must also hold up on whatever parsed
        extract_payloads(pc, "udp")
        extract_payloads(pc, "tcp")
    except ValueError:
        pass  # the one allowed failure mode


@pytest.mark.parametrize("seed", range(8))
def test_random_bytes_never_crash(tmp_path, seed):
    rng = np.random.default_rng(seed)
    p = tmp_path / "junk.bin"
    p.write_bytes(rng.integers(0, 256, size=int(rng.integers(0, 4000)),
                               dtype=np.uint8).tobytes())
    _try(p)


@pytest.mark.parametrize("seed", range(8))
def test_bitflipped_pcap_never_crashes(reference_dir, tmp_path, seed):
    """Flip random bytes of a real capture — truncation, bogus lengths and
    corrupt headers must surface as ValueError or parse-what-you-can."""
    raw = bytearray((reference_dir / "udp.pcap").read_bytes())
    rng = np.random.default_rng(seed)
    for _ in range(20):
        raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
    p = tmp_path / "flipped.pcap"
    p.write_bytes(bytes(raw))
    _try(p)


@pytest.mark.parametrize("seed", range(8))
def test_bitflipped_pcapng_never_crashes(reference_dir, tmp_path, seed):
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_pcapng import _pcapng_from

    blob = bytearray(_pcapng_from(read_pcap(reference_dir / "udp.pcap")))
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
    p = tmp_path / "flipped.pcapng"
    p.write_bytes(bytes(blob))
    _try(p)
    # non-strict must also never crash
    try:
        read_pcap(p, strict=False)
    except ValueError:
        pass
