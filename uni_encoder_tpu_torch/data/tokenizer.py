"""CLIP byte-pair-encoding tokenizer for task / text prompts.

The port's own copy of `uni_encoder_tpu/data/tokenizer.py`. The runtime
tokenizes the task string "The task is {panoptic|semantic|instance}" to
fixed-length-77 id sequences with SOT/EOT, and the task MLP consumes the raw
ids, so the ids must equal the JAX package's exactly.

Difference from the JAX copy: the word pattern is written for the standard
library's `re`, which has no `\\p{...}` classes (the `regex` package is not
installed everywhere the port runs). Letters are `[^\\W\\d_]+` (word
characters that are neither digits nor underscore), numbers `\\d`, and the
rest `(?:[^\\s\\w]|_)+` (neither space, letter nor number). For the ASCII
prompts the runtime uses, the two patterns split identically.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """GPT-2 style reversible byte <-> printable-unicode mapping.

    Insertion order matters: the vocab's first 256 entries are the values of
    this dict in order (printable ranges first, then the remapped control
    bytes), so token ids depend on it.
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


def _clean(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    def __init__(self, bpe_path: str = _ASSET):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # first line is a version header; CLIP uses merges[1:48895]
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(l.split()) for l in merge_lines]

        base = list(byte_unicode_table().values())
        vocab = base + [tok + "</w>" for tok in base]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [
                (self.merge_rank.get((parts[i], parts[i + 1]), None), i)
                for i in range(len(parts) - 1)
            ]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            best_rank = min(r for r, _ in ranked)
            # merge every non-overlapping occurrence of the best pair, L->R
            # (pair ranks are unique, so rank equality identifies the pair)
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and self.merge_rank.get((parts[i], parts[i + 1]), -1) == best_rank
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for word in _WORD_PATTERN.findall(text):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(word_bytes))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    @property
    def sot(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.encoder["<|endoftext|>"]


class Tokenize:
    """Fixed-length padding wrapper (reference tokenizer.py:87-117)."""

    def __init__(self, tokenizer: CLIPTokenizer, max_seq_len: int = 77, truncate: bool = True):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.truncate = truncate

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        out = np.zeros((len(texts), self.max_seq_len), dtype=np.int64)
        for i, t in enumerate(texts):
            ids = [self.tokenizer.sot] + self.tokenizer.encode(t) + [self.tokenizer.eot]
            if len(ids) > self.max_seq_len:
                if not self.truncate:
                    raise RuntimeError(f"input {t!r} too long for context {self.max_seq_len}")
                ids = ids[: self.max_seq_len]
                ids[-1] = self.tokenizer.eot
            out[i, : len(ids)] = ids
        return out[0] if single else out


@functools.lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()


@functools.lru_cache(maxsize=512)
def tokenize_task(task: str, seq_len: int = 77) -> Tuple[int, ...]:
    """Tokenize a task prompt; cached since there are only 3 at runtime."""
    return tuple(Tokenize(default_tokenizer(), seq_len)(task).tolist())
