"""The safetensors file format, written and read with the port's own code.

Counterpart of sd_lora_trainer_tpu/utils/safetensors_io.py, without the
`safetensors` package (the port's machine need not have it). A file is an
8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} padded with spaces to a multiple of 8 bytes, then each tensor's
raw little-endian bytes, C-contiguous, back to back.

As in the JAX package, every tensor is made contiguous before it is written
(the format has no strides) and 0-d tensors (kohya's alphas) stay 0-d.
"""

from __future__ import annotations

import json
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


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits as int16
        t = t.view(torch.int16)
    a = t.numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (torch tensors or numpy arrays, any device) to `path`."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.array(t)) if isinstance(t, np.ndarray) else t
        blob = _bytes(t)
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _FROM_NAME[info["dtype"]]
        raw = bytearray(data[base + begin:base + end])
        t = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out
