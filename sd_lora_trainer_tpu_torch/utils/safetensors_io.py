"""The safetensors file format, written and read with the port's own code.

Counterpart of sd_lora_trainer_tpu/utils/safetensors_io.py, without the
`safetensors` package (the port's machine need not have it). A file is an
8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} padded with spaces to a multiple of 8 bytes, then each tensor's
raw little-endian bytes, C-contiguous, back to back.

As in the JAX package, every tensor is made contiguous before it is written
(the format has no strides) and 0-d tensors (kohya's alphas) stay 0-d.
Writing streams one tensor at a time (a 6.9 GB checkpoint is never held as
one blob) into a temporary name that then replaces `path`, so a file that
is mapped elsewhere is never truncated under its mapping. `load_safetensors`
maps the file, so a tensor's bytes are read from disk only when it is used,
and a converter that moves each tensor to the card never holds the file
twice in host RAM.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}
# the numpy dtype each tensor dtype's bytes are mapped as (bf16: its bits)
_NP_VIEW = {torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
            torch.bfloat16: np.int16, torch.int64: np.int64, torch.int32: np.int32,
            torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
            torch.bool: np.bool_}


def _as_tensor(t) -> torch.Tensor:
    return torch.from_numpy(np.array(t)) if isinstance(t, np.ndarray) else t


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits as int16
        t = t.view(torch.int16)
    a = t.numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (torch tensors or numpy arrays, any device) to `path`,
    one tensor's bytes in host memory at a time."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = _as_tensor(tensors[name])
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            f.write(_bytes(_as_tensor(tensors[name])))
    os.replace(tmp, path)


def _read_header(path: str):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_safetensors_metadata(path: str) -> Dict[str, str]:
    """The file's `__metadata__` ({} when it has none); reads the header only."""
    header, _ = _read_header(path)
    return header.get("__metadata__") or {}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file.

    The file is mapped copy-on-write: the tensors share the mapping, their
    pages are read on first use, and writes to them stay private to the
    process."""
    header, base = _read_header(path)
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _FROM_NAME[info["dtype"]]
        view = np.dtype(_NP_VIEW[dtype]).newbyteorder("<")
        raw = data[base + begin:base + end]
        if (base + begin) % view.itemsize:  # unaligned: torch needs an aligned buffer
            raw = raw.copy()
        t = torch.from_numpy(raw.view(view).reshape(info["shape"]))
        out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out
