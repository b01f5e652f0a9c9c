"""A word-level tokenizer that the benchmark hands to both sides, in place
of the CLIP BPE vocabulary, which is not in the repository: the TI tokens
`<sN>` map to the ids after the vocabulary, each other word or mark to a
fixed id in [300, vocab - 300) by its CRC-32; start, end and padding as
CLIP's (77 ids, start vocab - 2, end vocab - 1, padding the end id or the
given one)."""

from __future__ import annotations

import re
import zlib
from typing import List, Optional

_PIECES = re.compile(r"<s\d+>|\w+|[^\s\w]")


class WordTokenizer:
    def __init__(self, vocab_size: int, pad_token_id: Optional[int] = None):
        self.vocab = vocab_size
        self.bos_token_id, self.eos_token_id = vocab_size - 2, vocab_size - 1
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self.max_length = 77

    def _id(self, piece: str) -> int:
        if piece.startswith("<s") and piece.endswith(">"):
            return self.vocab + int(piece[2:-1])
        return 300 + zlib.crc32(piece.lower().encode()) % (self.vocab - 600)

    def encode(self, text: str) -> List[int]:
        ids = [self._id(p) for p in _PIECES.findall(text)][: self.max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, texts) -> List[List[int]]:
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for text in texts:
            ids = self.encode(text)
            out.append(ids + [self.pad_token_id] * (self.max_length - len(ids)))
        return out
