"""CLIP BPE tokenizer (OpenCLIP-compatible), the port's copy of
geo4d_tpu/data/tokenizer.py: byte-pair encoding over the standard CLIP
vocabulary (bpe_simple_vocab_16e6.txt.gz, 49408 entries) with
<start_of_text>/<end_of_text>, padded or truncated to 77 tokens.

The merge table ships with the model assets. Without it a hash of each word
stands in (meaningless conditioning of the right shape, for random-weight
runs). That hash is CRC-32, so a prompt gives the same ids in every
process; the JAX package's fallback uses Python's `hash`, which is salted
per process. With a merge table both give the same ids.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

# OpenCLIP's word pattern: <specials> | contractions | \p{L}+ | \p{N} |
# [^\s\p{L}\p{N}]+, with [^\W\d_]+ for \p{L}+, a single digit for \p{N}
# (CLIP tokenizes "123" as three tokens) and (?:[^\s\w]|_)+ for the rest
_TOKEN_RE = re.compile(
    r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> unicode table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks: Dict[Tuple[str, str], int] = {}
        self.encoder: Dict[str, int] = {}
        self.has_vocab = False
        if bpe_path and os.path.exists(bpe_path):
            self._load_vocab(bpe_path)

    def _load_vocab(self, path: str):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # standard CLIP layout: a header line, then 48894 merges
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1] if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<start_of_text>": "<start_of_text>", "<end_of_text>": "<end_of_text>"}
        self.has_vocab = True

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def get_pairs(word):
            return {(word[i], word[i + 1]) for i in range(len(word) - 1)}

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip().lower())
        ids: List[int] = []
        for token in _TOKEN_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    @staticmethod
    def _hash_fallback(text: str) -> List[int]:
        return [zlib.crc32(w.encode("utf-8")) % (VOCAB_SIZE - 3) + 1
                for w in re.findall(r"\S+", text.lower())]

    def __call__(self, texts) -> np.ndarray:
        """Tokenize to (B, 77) int32 with SOT/EOT and zero padding."""
        if isinstance(texts, str):
            texts = [texts]
        sot, eot = VOCAB_SIZE - 2, VOCAB_SIZE - 1
        out = np.zeros((len(texts), CONTEXT_LENGTH), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode_text(t) if self.has_vocab else self._hash_fallback(t)
            ids = [sot] + ids[: CONTEXT_LENGTH - 2] + [eot]
            out[i, : len(ids)] = ids
        return out
