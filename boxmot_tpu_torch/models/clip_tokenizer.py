"""CLIP byte-level BPE tokenizer (host code).

A copy of ``boxmot_tpu/models/clip_tokenizer.py``: the tokenizer the
reference ships for CLIP-ReID (``clip/simple_tokenizer.py``), so that a
pretrained CLIP text tower is driven with the token ids it was trained on
(``models/convert.py::convert_clip``, ``reid/training/clip_prompt.py``).
The merges table is OpenAI's public CLIP BPE vocabulary, a byte-identical
copy under ``boxmot_tpu_torch/assets/``.

One change: the word split, which the original writes as a ``regex``
pattern with ``\\p{L}`` / ``\\p{N}`` classes, is a scanner over
``unicodedata`` categories here (``_split_words``), because the ``regex``
package need not be installed where the port runs.  It takes the
pattern's alternatives in the pattern's order at each position: the two
special tokens, the contractions ``'s 't 're 've 'm 'll 'd``, a run of
letters, one number character, a run of anything else that is neither
space, letter nor number; characters no alternative matches (spaces) are
skipped.  Plain categories class every code point that Python's
``unicodedata`` assigns as the pattern does, but for two cases written
out: U+0345 (a combining mark that ``regex`` case-folds to a letter
under IGNORECASE, so that no alternative matches it: ``_UNMATCHED``) and
U+001C-U+001F (``str.isspace`` but not ``\\s``: ``_NOT_SPACE``).
"""

from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path

import numpy as np

VOCAB_PATH = Path(__file__).resolve().parents[1] / "assets" / "clip_bpe_vocab_16e6.txt.gz"

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LENGTH = 77  # all CLIP text towers
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_UNMATCHED = "\u0345"
_NOT_SPACE = "\x1c\x1d\x1e\x1f"


def byte_unicode_table() -> dict[int, str]:
    """Canonical GPT-2/CLIP byte -> printable-unicode mapping: printable
    latin-1 bytes map to themselves, the other 68 to 256 + k, in the order
    the vocabulary lists them."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _clean(text: str) -> str:
    """The reference's basic and whitespace clean; ``ftfy.fix_text`` where
    ftfy is installed, else the identity (exact for ASCII templates)."""
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return " ".join(text.split())


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _is_other(c: str) -> bool:
    """``[^\\s\\p{L}\\p{N}]`` under IGNORECASE."""
    return not ((c.isspace() and c not in _NOT_SPACE) or _is_letter(c) or _is_number(c)
                or c in _UNMATCHED)


def _split_words(text: str) -> list[str]:
    """The original's ``regex.findall`` (IGNORECASE) of
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]
    |[^\\s\\p{L}\\p{N}]+`` over ``text``."""
    words, i, n = [], 0, len(text)
    while i < n:
        special = next((s for s in (SOT_TEXT, EOT_TEXT, *CONTRACTIONS)
                        if text[i:i + len(s)].lower() == s), None)
        if special is not None:
            words.append(text[i:i + len(special)])
            i += len(special)
            continue
        c = text[i]
        j = i + 1
        if _is_letter(c):
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            pass
        elif _is_other(c):
            while j < n and _is_other(text[j]):
                j += 1
        else:
            i = j  # a space (or U+0345): no alternative matches it
            continue
        words.append(text[i:j])
        i = j
    return words


class ClipBPE:
    """Byte-level BPE encoder/decoder over the CLIP merges table."""

    def __init__(self, vocab_path: str | Path = VOCAB_PATH):
        self._b2u = byte_unicode_table()
        self._u2b = {u: b for b, u in self._b2u.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a version banner; the table holds 48894 usable merges
        # (vocab 49152 = 256 bytes x2 + merges + 2 specials).
        merges = [tuple(ln.split()) for ln in lines[1: 49152 - 256 - 2 + 1]]
        self.ranks: dict[tuple[str, str], int] = {m: i for i, m in enumerate(merges)}

        symbols = list(self._b2u.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TEXT, EOT_TEXT]
        self.encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @functools.lru_cache(maxsize=16384)
    def _merge_word(self, token: str) -> tuple[str, ...]:
        """Apply BPE merges to one pre-tokenized word (unicode-mapped)."""
        parts = [*token[:-1], token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            # merge every non-overlapping occurrence, left to right
            merged: list[str] = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(parts)

    def encode(self, text: str) -> list[int]:
        """Text -> BPE token ids (no SOT/EOT)."""
        ids: list[int] = []
        for word in _split_words(_clean(text).lower()):
            if word in (SOT_TEXT, EOT_TEXT):
                ids.append(self.encoder[word])
                continue
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, ids) -> str:
        joined = "".join(self.decoder[int(i)] for i in ids)
        raw = bytes(self._u2b[c] for c in joined if c in self._u2b)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache(maxsize=1)
def get_tokenizer() -> ClipBPE:
    return ClipBPE()


def tokenize(texts: str | list[str], context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Prompts as a (N, context_length) int32 grid: SOT + body + EOT,
    zero-padded (clip.tokenize); an overlong prompt raises unless
    ``truncate``, which forces the last slot to EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot, *tok.encode(text), tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"prompt {text!r} tokenizes to {len(ids)} > "
                                 f"context_length {context_length}")
            ids = ids[:context_length - 1] + [tok.eot]
        out[i, :len(ids)] = ids
    return out
