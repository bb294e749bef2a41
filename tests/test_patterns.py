import pytest

from multithreading_string_matching.io.patterns import load_patterns, split_c_tokens


def test_strings_txt(strings_path):
    pats = load_patterns(strings_path)
    assert len(pats) == 97           # BASELINE.md: 97 tokens
    assert len(set(pats)) == 87      # duplicates kept as separate entries
    assert pats.count(b"ack") == 3
    assert pats.count(b"content") == 2
    assert all(2 <= len(p) <= 12 for p in pats)


def test_c_whitespace_splitting(tmp_path):
    f = tmp_path / "p.txt"
    f.write_bytes(b"  foo\tbar\r\nbaz\x0b\x0cqux  foo\n")
    assert load_patterns(f) == [b"foo", b"bar", b"baz", b"qux", b"foo"]


def test_split_c_tokens_empty():
    assert split_c_tokens(b" \t\n ") == []


def test_long_pattern_rejected(tmp_path):
    f = tmp_path / "p.txt"
    f.write_bytes(b"a" * 100)
    with pytest.raises(ValueError):
        load_patterns(f)


def test_empty_file_rejected(tmp_path):
    f = tmp_path / "p.txt"
    f.write_bytes(b"")
    with pytest.raises(ValueError):
        load_patterns(f)


# -- escaped syntax (\xNN / \\) — binary patterns fscanf cannot express ----

def test_escaped_syntax_decodes(tmp_path):
    from multithreading_string_matching.io.patterns import unescape_token

    f = tmp_path / "p.txt"
    f.write_bytes(rb"GET\x20/ \x00\x01\xff back\\slash plain")
    assert load_patterns(f, syntax="escaped") == [
        b"GET /", b"\x00\x01\xff", b"back\\slash", b"plain",
    ]
    # plain syntax leaves the bytes verbatim (reference-exact)
    assert load_patterns(f)[0] == rb"GET\x20/"
    assert unescape_token(b"no-escapes") == b"no-escapes"


def test_escaped_syntax_bad_escape(tmp_path):
    f = tmp_path / "p.txt"
    for bad in (rb"tr\q", rb"trunc\x4", rb"bad\xZZ", rb"sign\x+1", rb"sign\x-1"):
        f.write_bytes(bad)
        with pytest.raises(ValueError, match="escape"):
            load_patterns(f, syntax="escaped")
    with pytest.raises(ValueError, match="syntax"):
        load_patterns(f, syntax="snort")


def test_escaped_binary_pattern_end_to_end(tmp_path):
    """A NUL/space-containing pattern planted in payloads is found by every
    engine when loaded via the escaped syntax."""
    import numpy as np
    from multithreading_string_matching.api import Matcher

    pat = b"\x00\xde\xad \xbe"
    f = tmp_path / "p.txt"
    f.write_bytes(rb"\x00\xde\xad\x20\xbe http")
    pats = load_patterns(f, syntax="escaped")
    assert pats == [pat, b"http"]

    rng = np.random.default_rng(7)
    payloads = rng.integers(1, 256, size=(64, 96)).astype(np.uint8)
    lengths = np.full((64,), 96, dtype=np.int32)
    payloads[3, 10:15] = np.frombuffer(pat, np.uint8)
    payloads[9, 0:5] = np.frombuffer(pat, np.uint8)
    payloads[9, 91:96] = np.frombuffer(pat, np.uint8)  # at the very end
    payloads[11, 40:44] = np.frombuffer(b"http", np.uint8)

    m = Matcher(pats)
    want = None
    for eng in ("window", "ac", "kmp", "pallas"):
        got = m.count(payloads, lengths, engine=eng)
        if want is None:
            want = got.tolist()
        assert got.tolist() == want, eng
    assert want[0] >= 3 and want[1] >= 1
