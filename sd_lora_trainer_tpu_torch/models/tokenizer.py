"""CLIP byte-level BPE tokenizer.

Counterpart of sd_lora_trainer_tpu/models/tokenizer.py (a copy: the port
imports nothing of the JAX package). A self-contained CLIP tokenization:

- byte -> unicode table, lowercasing + whitespace cleanup, the CLIP word
  pattern, greedy BPE with a merge-rank table, and `</w>` end-of-word marks;
- special/added tokens (`<s0>`,...) that bypass BPE (textual inversion);
- per-encoder pad token id (CLIP-L pads with EOS=49407, OpenCLIP-G pads
  with 0) and fixed length-77 encoding.

Vocab loading: HF-format `vocab.json` + `merges.txt` from a directory.
`build_test_vocab()` and `build_sized_test_vocab()` build small synthetic
vocabs for offline tests and synthetic checkpoints.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Tuple


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map bytes to printable unicode chars (GPT-2/CLIP construction)."""
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


_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        max_length: int = 77,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token_id: Optional[int] = None,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.max_length = max_length
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self.added_tokens: Dict[str, int] = {}
        self._added_pattern: Optional[re.Pattern] = None
        self.cache = {bos_token: bos_token, eos_token: eos_token}

    # -- vocab management ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def add_special_tokens(self, tokens: List[str]) -> int:
        """Append new special tokens (ids continue after the base vocab)."""
        added = 0
        for tok in tokens:
            if tok in self.encoder or tok in self.added_tokens:
                continue
            self.added_tokens[tok] = len(self.encoder) + len(self.added_tokens)
            added += 1
        if self.added_tokens:
            pattern = "|".join(re.escape(t) for t in self.added_tokens)
            self._added_pattern = re.compile(f"({pattern})")
        return added

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        out = []
        for tok in tokens:
            if tok in self.added_tokens:
                out.append(self.added_tokens[tok])
            elif tok in self.encoder:
                out.append(self.encoder[tok])
            else:
                raise KeyError(f"Unknown token: {tok}")
        return out

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
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
            pairs = set(zip(word[:-1], word[1:]))
        result = " ".join(word)
        self.cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(text).lower()
        segments = [text]
        if self._added_pattern is not None:
            segments = [s for s in self._added_pattern.split(text) if s]
        bpe_tokens: List[str] = []
        for seg in segments:
            if seg in self.added_tokens:
                bpe_tokens.append(seg)
                continue
            for word in _WORD_PATTERN.findall(seg):
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                bpe_tokens.extend(self._bpe(word).split(" "))
        return bpe_tokens

    def encode(self, text: str) -> List[int]:
        """BOS + tokens + EOS, truncated to max_length (no padding) — matches
        transformers `tokenizer.encode` used for DAAM token lookup
        (reference: trainer/loss.py:34)."""
        ids = [self.bos_token_id]
        for tok in self.tokenize(text):
            if tok in self.added_tokens:
                ids.append(self.added_tokens[tok])
            else:
                ids.append(self.encoder.get(tok, self.eos_token_id))
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_token_id)
        return ids

    def __call__(self, texts) -> "list[list[int]]":
        """Batch-encode to fixed length 77 with padding (the SD conditioning
        path: padding='max_length', truncation=True)."""
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for text in texts:
            ids = self.encode(text)
            ids = ids + [self.pad_token_id] * (self.max_length - len(ids))
            out.append(ids)
        return out

    def decode(self, ids: List[int]) -> str:
        toks = []
        for i in ids:
            if i in (self.bos_token_id, self.eos_token_id, self.pad_token_id):
                continue
            rev = {v: k for k, v in self.added_tokens.items()}
            if i in rev:
                toks.append(rev[i])
            else:
                toks.append(self.decoder.get(i, ""))
        text = "".join(toks).replace("</w>", " ")
        try:
            raw = bytearray([self.byte_decoder.get(c, ord(" ")) for c in text])
            return raw.decode("utf-8", errors="replace").strip()
        except Exception:
            return text.strip()


def load_tokenizer(
    vocab_dir: str, max_length: int = 77, pad_token_id: Optional[int] = None
) -> CLIPTokenizer:
    """Load HF-format vocab.json + merges.txt from a directory."""
    with open(os.path.join(vocab_dir, "vocab.json")) as f:
        vocab = json.load(f)
    merges: List[Tuple[str, str]] = []
    merges_path = os.path.join(vocab_dir, "merges.txt")
    with open(merges_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
    return CLIPTokenizer(vocab, merges, max_length=max_length, pad_token_id=pad_token_id)


def build_test_vocab(
    extra_words: Optional[List[str]] = None, n_merges: int = 0
) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Tiny synthetic-but-valid CLIP vocab: all byte tokens (plain + `</w>`),
    optional whole-word tokens, BOS/EOS last (EOS id == len-1, preserving the
    'eos is the max id' property SD relies on)."""
    byte_chars = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for c in byte_chars:
        vocab[c] = len(vocab)
    for c in byte_chars:
        vocab[c + "</w>"] = len(vocab)
    merges: List[Tuple[str, str]] = []
    for word in extra_words or []:
        enc = word
        # merge chars left-to-right: (a,b) -> ab, (ab,c) -> abc ... then +</w>
        if len(enc) >= 2:
            acc = enc[0]
            for ch in enc[1:-1]:
                merges.append((acc, ch))
                acc += ch
                vocab.setdefault(acc, len(vocab))
            merges.append((acc, enc[-1] + "</w>"))
        vocab.setdefault(enc + "</w>", len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def build_sized_test_vocab(
    size: int, extra_words: Optional[List[str]] = None
) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Synthetic vocab with EXACTLY `size` entries, BOS at size-2 and EOS at
    size-1 — sized to match a tiny text encoder's embedding table so offline
    end-to-end runs (synthetic checkpoints) can tokenize real text.

    Covers printable-ASCII byte tokens (plain + `</w>`) and pads the rest with
    unused filler tokens; unknown characters fall back to EOS at encode time.
    """
    ascii_chars = [chr(b) for b in range(ord("!"), ord("~") + 1)]
    vocab: Dict[str, int] = {}
    for c in ascii_chars:
        if len(vocab) < size - 2:
            vocab[c] = len(vocab)
    for c in ascii_chars:
        if len(vocab) < size - 2:
            vocab[c + "</w>"] = len(vocab)
    merges: List[Tuple[str, str]] = []
    for word in extra_words or []:
        if len(vocab) >= size - 2:
            break
        if len(word) >= 2:
            acc = word[0]
            for ch in word[1:-1]:
                merges.append((acc, ch))
                acc += ch
                if len(vocab) < size - 2:
                    vocab.setdefault(acc, len(vocab))
            merges.append((acc, word[-1] + "</w>"))
        if len(vocab) < size - 2:
            vocab.setdefault(word + "</w>", len(vocab))
    i = 0
    while len(vocab) < size - 2:
        vocab[f"<filler{i}>"] = len(vocab)
        i += 1
    vocab["<|startoftext|>"] = size - 2
    vocab["<|endoftext|>"] = size - 1
    assert len(vocab) == size
    return vocab, merges
