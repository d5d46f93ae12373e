"""RoBERTa byte-level BPE tokenizer (CLAP's text side), pure Python (a copy
of ``clap2diffusion_tpu/models/roberta_tokenizer.py``: the port imports
nothing of the JAX package, so a fix to the original must be copied here).

The reference tokenizes CLAP text prompts through transformers'
RobertaTokenizer (reference models/audio_encoder.py:255-280, truncation to
77). This implements the GPT-2-style byte-level BPE RoBERTa uses; it loads
the standard ``vocab.json`` + ``merges.txt`` pair when available locally
(``CLAP_BPE_DIR`` env var or explicit paths). With no files (this image has
zero egress), a deterministic hash fallback keeps similarity tooling
runnable; supply the files for checkpoint-faithful text embeddings.

Specials: <s>=0 <pad>=1 </s>=2 <unk>=3.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import List, Optional

import numpy as np

from clap2diffusion_tpu_torch.models.tokenizer import _bytes_to_unicode

BOS, PAD, EOS, UNK = 0, 1, 2, 3
_GPT2_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
)


class RobertaTokenizer:
    def __init__(
        self,
        vocab_path: Optional[str] = None,
        merges_path: Optional[str] = None,
        max_length: int = 77,
        vocab_size: int = 50_265,
    ):
        self.max_length = max_length
        self.vocab_size = vocab_size
        base = os.environ.get("CLAP_BPE_DIR", "")
        vocab_path = vocab_path or (os.path.join(base, "vocab.json") if base else "")
        merges_path = merges_path or (os.path.join(base, "merges.txt") if base else "")
        self.byte_encoder = _bytes_to_unicode()
        self.encoder = {}
        self.bpe_ranks = {}
        if vocab_path and merges_path and os.path.exists(vocab_path) and os.path.exists(merges_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
            with open(merges_path, encoding="utf-8") as f:
                merges = [
                    tuple(line.split())
                    for line in f.read().split("\n")
                    if line and not line.startswith("#version")
                ]
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
            self._cache = {}
        self.fallback = not self.encoder
        if self.fallback:
            from clap2diffusion_tpu_torch.models.tokenizer import _warn_fallback

            _warn_fallback(
                "RoBERTa BPE",
                "CLAP_BPE_DIR",
                "roberta-base vocab.json + merges.txt",
            )

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _GPT2_PAT.findall(text):
            if self.fallback:
                h = int(hashlib.sha1(tok.strip().lower().encode()).hexdigest(), 16)
                ids.append(10 + h % (self.vocab_size - 100))
                continue
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(
                self.encoder.get(t, UNK) for t in self._bpe(btok)
            )
        return ids

    def __call__(self, texts: str | List[str]) -> dict:
        """-> {input_ids [B,L], attention_mask [B,L]} int32, RoBERTa padding."""
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), self.max_length), PAD, np.int32)
        mask = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [BOS] + self.encode(t)[: self.max_length - 2] + [EOS]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
