"""CLIP's tokenizer, pure Python: a frozen copy of the program's
``models/tokenizer.py``. Byte-level BPE when a merges file is given
(``CLIP_BPE_PATH``); without one, as in the benchmark, each word is hashed
into the BPE id range. Ids are padded with the end-of-text id to 77.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import re
from functools import lru_cache
from typing import List, Optional

import numpy as np

SOT = 49_406
EOT = 49_407
VOCAB_SIZE = 49_408
_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+",
    re.IGNORECASE,
)


@lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, max_length: int = 77):
        self.max_length = max_length
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH", "")
        self.byte_encoder = _bytes_to_unicode()
        self.bpe_ranks = {}
        self.encoder = {}
        if bpe_path and os.path.exists(bpe_path):
            self._load_bpe(bpe_path)
        self.fallback = not self.encoder

    def _load_bpe(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49_152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = []
        for tok in _WORD_RE.findall(text):
            if self.fallback:
                # deterministic hash bucket in the BPE id range
                h = int(hashlib.sha1(tok.encode()).hexdigest(), 16)
                ids.append(256 + h % (SOT - 512))
            else:
                btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(btok))
        return ids

    def __call__(self, texts: str | List[str]) -> np.ndarray:
        """Tokenize to padded int32 [B, 77]: SOT ids... EOT, pad with EOT
        (CLIP pads with the EOT id; SD relies on this)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), EOT, np.int32)
        for i, t in enumerate(texts):
            ids = [SOT] + self.encode(t)[: self.max_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out
