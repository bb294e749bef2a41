"""Pattern-file loading (reference component C1).

The reference reads whitespace-separated tokens with a ``fscanf(fp, "%s", str)``
loop into a growable array (serial.c:53-88 and its four copies), preserving
file order *including duplicate tokens* — the pattern list is a list, not a
set, and every entry is reported independently (serial.c:163-166).

This loader replicates that contract exactly: ``%s`` skips any run of
whitespace (space, tab, newline, vertical tab, form feed, carriage return)
and consumes a maximal run of non-whitespace bytes.  Patterns are returned
as ``bytes`` because payloads are raw bytes, not text.
"""

from __future__ import annotations

import os
from typing import List, Union

# The whitespace set of C's isspace() in the "C" locale, which is what
# fscanf %s uses to delimit tokens.
_C_WHITESPACE = b" \t\n\v\f\r"

# serial.c:64 reads each token into `char str[100]`; a longer token would
# overflow the buffer (UB).  We therefore treat >99-byte tokens as a hard
# error instead of silently reproducing undefined behavior.
MAX_PATTERN_LEN = 99


def split_c_tokens(data: bytes) -> List[bytes]:
    """Split raw bytes exactly as a ``fscanf("%s")`` loop would."""
    return bytes(data).split()  # bytes.split() with no sep == C-whitespace runs


def unescape_token(tok: bytes) -> bytes:
    """Decode ``\\xNN`` hex escapes (and ``\\\\``) in one pattern token.

    The reference reads patterns with ``fscanf("%s")`` (serial.c:69), which
    can never express whitespace or NUL bytes — yet its own matcher would
    accept them (payloads are binary).  The escaped syntax closes that gap:
    ``GET\\x20/`` matches a space, ``\\x00\\x01`` matches raw bytes.  The
    matching engines already handle NUL-containing patterns (the window
    engine's exact-fit masks, and packing disables itself).
    """
    if b"\\" not in tok:
        return tok
    out = bytearray()
    i, n = 0, len(tok)
    while i < n:
        b = tok[i]
        if b != 0x5C:  # '\'
            out.append(b)
            i += 1
            continue
        nxt = tok[i + 1 : i + 2]
        if nxt == b"\\":
            out.append(0x5C)
            i += 2
        elif nxt == b"x" and i + 4 <= n:
            hexpair = tok[i + 2 : i + 4]
            # int(.., 16) alone would accept a sign character ('\x+1' -> 1);
            # require two actual hex digits.
            if not all(c in b"0123456789abcdefABCDEF" for c in hexpair):
                raise ValueError(
                    f"bad \\x escape in pattern token {tok[:20]!r}"
                )
            out.append(int(hexpair, 16))
            i += 4
        else:
            raise ValueError(
                f"bad escape in pattern token {tok[:20]!r} "
                "(only \\xNN and \\\\ are recognized)"
            )
    return bytes(out)


def load_patterns(
    path: Union[str, os.PathLike], *, syntax: str = "plain"
) -> List[bytes]:
    """Read a strings.txt-style pattern file into an ordered list of bytes.

    Duplicates are preserved (strings.txt contains e.g. ``ack`` three times
    and each copy gets its own output line in the reference programs).

    ``syntax="escaped"`` additionally decodes ``\\xNN`` / ``\\\\`` escapes
    per token (see :func:`unescape_token`), allowing binary patterns the
    reference's ``fscanf("%s")`` loader cannot express.  ``"plain"`` is the
    reference-exact behavior: bytes are taken verbatim.
    """
    if syntax not in ("plain", "escaped"):
        raise ValueError(f"unknown pattern syntax {syntax!r}")
    with open(path, "rb") as f:
        data = f.read()
    patterns = split_c_tokens(data)
    if syntax == "escaped":
        patterns = [unescape_token(p) for p in patterns]
    for p in patterns:
        if len(p) > MAX_PATTERN_LEN:
            raise ValueError(
                f"pattern {p[:20]!r}... is {len(p)} bytes; the reference's "
                f"fixed 100-byte token buffer caps patterns at {MAX_PATTERN_LEN}"
            )
        if not p:
            raise ValueError("empty pattern")
    if not patterns:
        raise ValueError(f"no patterns found in {path!r}")
    return patterns
