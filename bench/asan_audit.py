"""Memory-safety audit of the native ingest path (pcap_ingest.cpp).

The C++ walkers parse UNTRUSTED capture bytes — the classic C parsing
vulnerability surface.  This builds the library with
``-fsanitize=address,undefined -fno-sanitize-recover=all``, swaps it into
``io.native`` in-process, and drives it with:

1. the three generative native-vs-Python differentials from
   tests/test_pcap_stream.py (structured adversarial captures);
2. a raw-garbage fuzz — unstructured bytes, magic-prefixed garbage, and
   bit-flipped valid captures — through read_pcap AND iter_pcap at random
   batch/read sizes (the walkers must never read out of bounds regardless
   of content; Python-level ValueError/OverflowError are the only accepted
   outcomes);
3. random-geometry decode/fill/pack calls, including origlens that lie
   about the wire length (caplens stay in-buffer — the PcapFile parser
   guarantees that invariant to decode()).

Any ASan/UBSan finding aborts the process (nonzero exit).  Run it when
touching native/pcap_ingest.cpp:

    python bench/asan_audit.py [--seed N] [--garbage-cases N]
    # re-execs itself under LD_PRELOAD

Audit history: clean at round 3 (differentials + 4000 garbage cases +
500 geometry cases at seed 5, plus a 20000-case pass at seed 6).
"""

import argparse
import ctypes
import os
import pathlib
import struct
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "multithreading_string_matching" / "native" / "pcap_ingest.cpp"
ASAN_SO = pathlib.Path(tempfile.gettempdir()) / f"libmsm_ingest_asan.{os.getuid()}.so"


def _build() -> None:
    subprocess.run(
        [
            "g++", "-O1", "-g", "-shared", "-fPIC",
            "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
            "-o", str(ASAN_SO), str(SRC),
        ],
        check=True,
    )


def _reexec_with_asan() -> None:
    """ASan must be loaded before libc initializes: re-exec with LD_PRELOAD
    (the python binary itself is uninstrumented)."""
    libasan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    env = dict(os.environ)
    env["LD_PRELOAD"] = libasan
    env.setdefault("ASAN_OPTIONS", "detect_leaks=0:abort_on_error=1")
    env["MSM_ASAN_AUDIT_CHILD"] = "1"
    os.execve(sys.executable, [sys.executable, __file__] + sys.argv[1:], env)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--garbage-cases", type=int, default=4000)
    args = ap.parse_args()
    if not os.environ.get("MSM_ASAN_AUDIT_CHILD"):
        _build()
        _reexec_with_asan()  # never returns; child reuses the built .so

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import numpy as np

    from multithreading_string_matching.io import native

    lib = ctypes.CDLL(str(ASAN_SO))
    native._bind(lib)
    native._lib = lib
    native._tried = True
    assert native.available()

    import test_pcap_stream as t

    tmp = pathlib.Path(tempfile.mkdtemp())
    t.test_stream_native_walk_matches_python_walk(tmp)
    print("classic differential clean under ASan", flush=True)
    t.test_stream_pcapng_native_walk_matches_python_walk(tmp)
    print("pcapng differential clean under ASan", flush=True)
    t.test_pcapng_timestamp_extremes_native_equals_python(tmp)
    print("timestamp extremes clean under ASan", flush=True)

    rng = np.random.default_rng(args.seed)
    from multithreading_string_matching.io.pcap import iter_pcap, read_pcap

    def valid_classic(end="<"):
        out = bytearray(
            struct.pack(end + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
        )
        for _ in range(30):
            n = int(rng.integers(0, 200))
            out += struct.pack(end + "IIII", 1, 2, n, n)
            out += rng.integers(0, 256, n).astype(np.uint8).tobytes()
        return out

    def valid_pcapng(end="<"):
        def block(btype, body):
            pad = (-len(body)) % 4
            blen = 12 + len(body) + pad
            return (struct.pack(end + "II", btype, blen) + body
                    + b"\x00" * pad + struct.pack(end + "I", blen))

        out = bytearray()
        out += block(0x0A0D0D0A, struct.pack(end + "IHHq", 0x1A2B3C4D, 1, 0, -1))
        out += block(0x00000001, struct.pack(end + "HHI", 1, 0, 65535))
        for _ in range(30):
            n = int(rng.integers(0, 150))
            d = rng.integers(0, 256, n).astype(np.uint8).tobytes()
            out += block(
                0x00000006, struct.pack(end + "IIIII", 0, 0, 0, n, n) + d
            )
        return out

    cases = 0
    for trial in range(args.garbage_cases):
        kind = trial % 4
        # Random endianness per case: the native walkers have separate
        # byte-swap branches that the all-little default never exercised.
        end = "<" if rng.integers(2) else ">"
        if kind == 0:  # pure garbage, classic magic prepended half the time
            blob = rng.integers(
                0, 256, int(rng.integers(0, 400))
            ).astype(np.uint8).tobytes()
            if rng.integers(2):
                blob = struct.pack(
                    end + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1
                ) + blob
        elif kind == 1:  # garbage behind a valid pcapng SHB
            blob = rng.integers(
                0, 256, int(rng.integers(0, 400))
            ).astype(np.uint8).tobytes()
            shb = (struct.pack("<II", 0x0A0D0D0A, 28)
                   + struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1)
                   + struct.pack("<I", 28))
            blob = shb + blob
        elif kind == 2:  # bit-flipped valid classic
            b = bytearray(valid_classic(end))
            for _ in range(int(rng.integers(1, 20))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            blob = bytes(b)
        else:  # bit-flipped valid pcapng
            b = bytearray(valid_pcapng(end))
            for _ in range(int(rng.integers(1, 20))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            blob = bytes(b)
        p = tmp / "fuzz.bin"
        p.write_bytes(blob)
        for strict in (False, True):
            try:
                read_pcap(p, strict=strict)
            except (ValueError, OverflowError):
                pass
            try:
                for _ in iter_pcap(
                    p, batch_packets=int(rng.choice([1, 7, 1000])),
                    read_size=int(rng.choice([32, 4096])), strict=strict,
                ):
                    pass
            except (ValueError, OverflowError):
                pass
        cases += 1
    print(f"raw-garbage fuzz clean under ASan: {cases} cases", flush=True)

    for trial in range(500):
        nbytes = int(rng.integers(0, 3000))
        buf = rng.integers(0, 256, nbytes).astype(np.uint8)
        n = int(rng.integers(0, 40))
        z = np.zeros(0, np.int64)
        offsets = rng.integers(0, max(1, nbytes), n).astype(np.int64) if n else z
        caplens = rng.integers(0, 4000, n).astype(np.int64) if n else z
        caplens = np.minimum(caplens, np.maximum(nbytes - offsets, 0))
        origlens = rng.integers(0, 70000, n).astype(np.int64) if n else z
        for mode in ("udp", "tcp"):
            for strict in (False, True):
                v, po, pl = native.decode(
                    buf, offsets, caplens, origlens, mode, strict
                )
                assert v.shape == (n,)
        lens = np.minimum(caplens, 128)
        out = native.fill_padded(buf, offsets, lens, 128)
        assert out.shape == (n, 128)
        if n:
            native.pack(out, lens, 256)
        # scatter_segments (the flow fill): contract-valid random geometry
        # (src/len within buf, row/off within out) — ASan checks the copies.
        rows_n = int(rng.integers(1, 8))
        stride = int(rng.integers(1, 300))
        out2 = np.zeros((rows_n, stride), np.uint8)
        s_len = np.minimum(lens, stride).astype(np.int64)
        s_src = np.minimum(offsets, max(0, nbytes - 1)).astype(np.int64)
        s_len = np.minimum(s_len, np.maximum(nbytes - s_src, 0))
        s_row = rng.integers(0, rows_n, n).astype(np.int64) if n else z
        s_off = (rng.integers(0, stride, n).astype(np.int64) if n else z)
        s_off = np.minimum(s_off, stride - s_len)
        if n:
            native.scatter_segments(buf, s_src, s_len, s_row, s_off, out2)
    print("decode/fill/pack/scatter fuzz clean under ASan", flush=True)
    print("ASAN AUDIT CLEAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())
