"""Native tokenizers: CLIP byte-BPE and BERT WordPiece.

The reference gets tokenization from vendored SLIP BPE code
(reference: additional_approaches/src/slip/tokenizer.py — the standard CLIP
SimpleTokenizer) and HF tokenizers.  These implementations take the same
vocabulary artifacts (``bpe_simple_vocab_16e6.txt`` merges for CLIP;
``vocab.txt`` for WordPiece) as plain files, so the text towers run with no
HF/tokenizers dependency once the files are supplied.

Both return fixed-length id arrays ready for the Flax text encoders
(srsem_torch.pseudo.clip_text.ClipTextEncoder / text_embed.MiniLMEncoder).
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


# ---------------- CLIP byte-BPE ------------------------------------------

@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP reversible byte→unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# CLIP's regex uses \p{L}/\p{N} Unicode property classes (regex module,
# reference: additional_approaches/src/slip/tokenizer.py:59-61); stdlib `re`
# has none, so the split is an explicit scanner over unicodedata categories —
# exactly equivalent to findall of
#   <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
#   [\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+   (IGNORECASE)
# including the cases where Python's \w fallback diverges: "_" is punctuation
# under \p{L}/\p{N} (not a word char) and superscripts like "2-superscript"
# are single \p{N} tokens (not letters).

_SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS_3 = ("'re", "'ve", "'ll")
_CONTRACTIONS_2 = ("'s", "'t", "'m", "'d")


def _cat(ch: str) -> str:
    import unicodedata

    return unicodedata.category(ch)


def clip_word_split(text: str) -> List[str]:
    """Scanner equivalent of the reference tokenizer's pattern findall."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "<":
            for sp in _SPECIAL_TOKENS:
                if text.startswith(sp, i):
                    tokens.append(sp)
                    i += len(sp)
                    break
            else:
                i = _scan_rest(text, i, tokens)
            continue
        if ch == "'":
            low3 = text[i: i + 3].lower()
            if low3 in _CONTRACTIONS_3:
                tokens.append(text[i: i + 3])
                i += 3
                continue
            low2 = text[i: i + 2].lower()
            if low2 in _CONTRACTIONS_2:
                tokens.append(text[i: i + 2])
                i += 2
                continue
        i = _scan_rest(text, i, tokens)
    return tokens


def _scan_rest(text: str, i: int, tokens: List[str]) -> int:
    """Match [\\p{L}]+ | [\\p{N}] | [^\\s\\p{L}\\p{N}]+ at position i."""
    n = len(text)
    c0 = _cat(text[i])[0]
    if c0 == "L":
        j = i + 1
        while j < n and _cat(text[j])[0] == "L":
            j += 1
        tokens.append(text[i:j])
        return j
    if c0 == "N":
        tokens.append(text[i])
        return i + 1
    j = i + 1
    while j < n and not text[j].isspace() and _cat(text[j])[0] not in ("L", "N"):
        j += 1
    tokens.append(text[i:j])
    return j


def _basic_clean(text: str) -> str:
    from srsem_torch.pseudo.textfix import fix_text

    # reference: slip/tokenizer.py:59-61 — ftfy.fix_text then a DOUBLE
    # html.unescape, then strip.
    return html.unescape(html.unescape(fix_text(text))).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBpeTokenizer:
    """CLIP SimpleTokenizer over a merges file (bpe_simple_vocab_16e6.txt,
    optionally gzipped).  Produces 77-token sequences with SOT/EOT."""

    def __init__(self, merges_path: str, context: int = 77):
        self.context = context
        self.byte_encoder = bytes_to_unicode()
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                merges_raw = f.read()
        else:
            with open(merges_path, encoding="utf-8") as f:
                merges_raw = f.read()
        merges = merges_raw.split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        # Specials pass through BPE verbatim (reference: slip/tokenizer.py's
        # cache pre-population).
        self.cache: Dict[str, str] = {t: t for t in _SPECIAL_TOKENS}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in clip_word_split(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text)[: self.context - 2] + [self.eot]
            out[row, : len(ids)] = ids
        return out


# ---------------- BERT WordPiece -----------------------------------------

class WordPieceTokenizer:
    """Lowercasing BERT WordPiece over a vocab.txt file — the MiniLM
    tokenizer.  Returns {"input_ids", "attention_mask"} numpy arrays like
    the HF API surface MiniLMEmbedder expects."""

    def __init__(self, vocab_path: str, max_length: int = 128):
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(tokens)}
        self.max_length = max_length
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.unk = self.vocab.get("[UNK]", 100)
        self.pad = self.vocab.get("[PAD]", 0)

    def _split(self, text: str) -> List[str]:
        import unicodedata

        # BERT-uncased normalization: lowercase AND strip accents (NFD +
        # drop combining marks) — HF's do_lower_case implies
        # strip_accents, so 'café' must tokenize as 'cafe', not [UNK]
        # (parity with the sentence-transformers MiniLM tokenizer).
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(c for c in text
                       if unicodedata.category(c) != "Mn")
        text = re.sub(r"([^\w\s])", r" \1 ", text)
        return text.split()

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=None, return_tensors="np") -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        ml = max_length or self.max_length
        ids_batch = np.full((len(texts), ml), self.pad, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        for row, text in enumerate(texts):
            ids = [self.cls]
            for word in self._split(text):
                ids.extend(self._wordpiece(word))
            ids = ids[: ml - 1] + [self.sep]
            ids_batch[row, : len(ids)] = ids
            mask[row, : len(ids)] = 1
        return {"input_ids": ids_batch, "attention_mask": mask}
