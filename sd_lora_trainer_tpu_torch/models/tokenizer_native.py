"""ctypes binding for the C++ CLIP BPE tokenizer (csrc/clip_bpe.cpp).

Counterpart of sd_lora_trainer_tpu/models/tokenizer_native.py. Captions are
tokenized on the host every train step (caption dropout), so the tokenizer
is the host's hot path. `NativeCLIPTokenizer` has the surface of
models/tokenizer.py's `CLIPTokenizer`.

The library is built at first use with `g++ -O2 -shared -fPIC -std=c++17`
into `build/tokenizer/` at the repository root (git-ignored), named by a
hash of the source and the flags. Processes may build at once: each takes an
`fcntl` lock on the build directory, compiles to a temporary name and
`os.replace`s it onto the final one, so a loader never sees a partial file.
A failed build raises with g++'s stderr; it never falls back quietly. Only
where no g++ exists does `native_available()` say False, and the caller
(main.build_tokenizers) then uses the Python tokenizer and says so.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SRC = Path(__file__).resolve().parent.parent / "csrc" / "clip_bpe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tokenizer"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIB: Optional[ctypes.CDLL] = None


def compiler_available() -> bool:
    return shutil.which("g++") is not None


def native_available() -> bool:
    """True where the library can be built (a g++ exists) or is built."""
    return _LIB is not None or library_path().exists() or compiler_available()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libclip_bpe-{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """The built library's path, compiling it if it is missing."""
    out = library_path()
    if out.exists():
        return out
    if not compiler_available():
        raise RuntimeError("g++ not found: the native tokenizer needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while this one waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build_library()))
        handle.clip_bpe_create.restype = ctypes.c_void_p
        handle.clip_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_long]
        handle.clip_bpe_add_special.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        handle.clip_bpe_encode.restype = ctypes.c_int
        handle.clip_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        handle.clip_bpe_destroy.argtypes = [ctypes.c_void_p]
        _LIB = handle
    return _LIB


class NativeCLIPTokenizer:
    """The surface of models/tokenizer.CLIPTokenizer, C++ inside."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 max_length: int = 77, pad_token_id: Optional[int] = None):
        self._lib = _load_library()
        self.max_length = max_length
        self.encoder = dict(vocab)
        self.bos_token_id = vocab["<|startoftext|>"]
        self.eos_token_id = vocab["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id if pad_token_id is None else pad_token_id
        self.added_tokens: Dict[str, int] = {}
        vocab_tsv = "\n".join(f"{tok}\t{idx}" for tok, idx in vocab.items())
        merges_txt = "\n".join(f"{a} {b}" for a, b in merges)
        self._handle = self._lib.clip_bpe_create(
            vocab_tsv.encode("utf-8"), merges_txt.encode("utf-8"), max_length,
            -1 if pad_token_id is None else pad_token_id,
        )
        self._buf = (ctypes.c_long * max_length)()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.clip_bpe_destroy(handle)

    def __len__(self):
        return len(self.encoder) + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def add_special_tokens(self, tokens: List[str]) -> int:
        added = 0
        for tok in tokens:
            if tok in self.encoder or tok in self.added_tokens:
                continue
            self.added_tokens[tok] = len(self.encoder) + len(self.added_tokens)
            self._lib.clip_bpe_add_special(self._handle, tok.lower().encode("utf-8"))
            added += 1
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

    def encode(self, text: str) -> List[int]:
        """BOS + tokens + EOS, truncated to max_length, no padding."""
        n = self._lib.clip_bpe_encode(self._handle, text.encode("utf-8"), self._buf, 0)
        return list(self._buf[:n])

    def __call__(self, texts) -> List[List[int]]:
        """Fixed-length (max_length) ids per text, padded with pad_token_id."""
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for text in texts:
            self._lib.clip_bpe_encode(self._handle, text.encode("utf-8"), self._buf, 1)
            out.append(list(self._buf[: self.max_length]))
        return out
