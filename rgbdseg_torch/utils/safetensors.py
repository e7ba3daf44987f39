"""A reader and writer of the safetensors format on torch and json alone (the
card's machine has no `safetensors` package).

A file is an 8-byte little-endian header length n, n bytes of JSON, then the
tensors' raw little-endian bytes back to back. The header maps each tensor's
name to {"dtype", "shape", "data_offsets": [begin, end]} (offsets into the
data after the header) and may carry "__metadata__", a map of strings. The
writer lays the tensors out as the `safetensors` library does: by dtype,
widest first, then by name; the header is compact JSON padded with spaces to
a multiple of 8 bytes, "__metadata__" first.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> torch dtype, in the library's order of dtypes (its
# writer sorts tensors by this order, last first).
_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16, "F16": torch.float16,
    "BF16": torch.bfloat16, "I32": torch.int32, "F32": torch.float32, "F64": torch.float64, "I64": torch.int64,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.as_tensor(np.asarray(x)).contiguous()  # (ascontiguousarray would make a 0-d array 1-d)


def _raw(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""


def save_file(tensors: Mapping, path: str, metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (name -> torch tensor or numpy array) to `path`."""
    items = [(name, _as_tensor(x)) for name, x in tensors.items()]
    for name, t in items:
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name here")
    items.sort(key=lambda kv: (-_RANK[_NAMES[kv[1].dtype]], kv[0]))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name, t in items:
        blob = _raw(t)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file into CPU tensors, by name (the
    header's "__metadata__" is not returned)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", blob[:8])
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(blob[8 : 8 + n])
    header.pop("__metadata__", None)
    data = memoryview(blob)[8 + n :]
    out = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which this reader does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size() or end > len(data):
            raise ValueError(f"{path}: tensor {name} of {shape} {info['dtype']} has offsets {begin}..{end}")
        raw = torch.frombuffer(bytearray(data[begin:end]), dtype=torch.uint8) if count else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(shape)
    return out
