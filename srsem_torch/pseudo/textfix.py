"""ftfy-equivalent text fixing for caption tokenization.

The reference's CLIP tokenizer cleans text with ``ftfy.fix_text`` before
BPE (reference: additional_approaches/src/slip/tokenizer.py:13-14,59-61).
ftfy is not in this environment, so this module reimplements the fixes
that matter for the caption domain, in ftfy's default pipeline order:

* HTML entity unescape;
* mojibake repair — text that was UTF-8 but got decoded as
  Windows-1252/Latin-1 (possibly twice) is re-encoded and decoded back,
  accepted only when it round-trips cleanly AND reduces a badness score,
  iterated to a fixpoint like ``ftfy.fix_encoding``;
* Latin ligature expansion (U+FB01 -> "fi") and fullwidth -> ASCII width
  folding;
* curly quotes -> straight quotes (ftfy ``uncurl_quotes`` — this one
  changes tokenization: U+2019 "s" must become ASCII 's to hit the
  contraction rule in the BPE pattern);
* control-character removal + line-break normalization;
* Unicode NFC normalization.

Pure stdlib; deterministic; golden-pinned in tests/test_tokenizer.py.
"""

from __future__ import annotations

import html
import re
import unicodedata

# --- mojibake -------------------------------------------------------------

# Characters that almost never appear intentionally but are common UTF-8
# bytes mis-decoded as cp1252/latin-1 (A-tilde / A-circumflex lead bytes,
# the cp1252 euro-range continuation bytes, raw C1 controls).
_MOJIBAKE_HINT = re.compile(
    "[ÃÂâ-€™œžŸ]")


def _badness(text: str) -> int:
    """Count of mojibake-suspicious characters."""
    bad = 0
    for ch in text:
        o = ord(ch)
        if 0x80 <= o <= 0x9F:  # C1 controls: never intentional
            bad += 3
        elif ch in "ÃÂ":  # lead bytes of UTF-8 seen through latin-1
            bad += 2
        elif ch in "â€™“”˜œ":
            bad += 1
    return bad


def _try_fix_encoding(text: str) -> str:
    """One round of ftfy-style encoding repair."""
    for enc in ("windows-1252", "latin-1"):
        try:
            candidate = text.encode(enc).decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            continue
        if _badness(candidate) < _badness(text):
            return candidate
    return text


def fix_encoding(text: str, max_rounds: int = 3) -> str:
    """Iteratively repair mojibake (handles double-encoded UTF-8)."""
    for _ in range(max_rounds):
        if not _MOJIBAKE_HINT.search(text):
            return text
        fixed = _try_fix_encoding(text)
        if fixed == text:
            return text
        text = fixed
    return text


# --- character-level tables -------------------------------------------------

_LIGATURES = {
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
    "Ĳ": "IJ", "ĳ": "ij",
}

_CURLY_QUOTES = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "′": "'", "″": '"',
}

# Fullwidth ASCII block U+FF01..U+FF5E -> U+0021..U+007E, plus the
# ideographic space.
_WIDTH = {0x3000: " "}
_WIDTH.update({c: chr(c - 0xFF01 + 0x21) for c in range(0xFF01, 0xFF5F)})

_TRANSLATE = {**{ord(k): v for k, v in _LIGATURES.items()},
              **{ord(k): v for k, v in _CURLY_QUOTES.items()},
              **_WIDTH}

# C0 controls (except \t\n), C1 controls, zero-width chars, BOM.
_CONTROL = re.compile(
    "[\x00-\x08\x0b-\x1f\x7f-​-‍⁠﻿]")


def fix_text(text: str) -> str:
    """The ftfy.fix_text-equivalent cleanup used before CLIP BPE."""
    if "&" in text:
        text = html.unescape(text)
    text = fix_encoding(text)
    if "&" in text:  # entities revealed by the encoding fix
        text = html.unescape(text)
    text = text.translate(_TRANSLATE)
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    text = _CONTROL.sub("", text)
    return unicodedata.normalize("NFC", text)
