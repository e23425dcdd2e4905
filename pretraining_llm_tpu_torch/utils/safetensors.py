"""The safetensors file format, read and written with numpy and torch only.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes back to back. The header maps each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte buffer after the header) and may hold a
``"__metadata__"`` map of strings. Hugging Face's ``save_pretrained``
writes ``model.safetensors`` in this format; the checkpoint converters
(``import_hf_checkpoint``, ``export_hf_checkpoint``) read and write it
without the ``safetensors`` package, which the GPU host does not have.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(value))


def save_file(tensors: Mapping[str, Any], path: str, metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path`` with
    ``metadata`` as the header's ``__metadata__``. As the ``safetensors``
    package does, the header is padded with spaces to a multiple of 8 bytes
    and the tensors go widest element first (then by name), so every
    tensor starts on a multiple of its element size."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    converted = {name: _as_tensor(value) for name, value in tensors.items()}
    for name in sorted(converted, key=lambda n: (-converted[n].element_size(), n)):
        t = converted[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def read_header(path: str) -> Dict[str, Any]:
    """The JSON header of a safetensors file (``__metadata__`` included)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors. Raises
    ``ValueError`` on a dtype it does not know or on offsets that do not
    tile the byte buffer."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out: Dict[str, torch.Tensor] = {}
    spans = []
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, which this reader does not know")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name} spans {end - begin} bytes for shape {shape} {entry['dtype']}")
        spans.append((begin, end))
        # Views of one buffer, which the tensors keep alive: no copy per tensor.
        raw = (torch.frombuffer(buf, dtype=torch.uint8, offset=begin, count=end - begin) if count
               else torch.empty(0, dtype=torch.uint8))
        out[name] = raw.view(dtype).reshape(shape)
    pos = 0
    for begin, end in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: tensor bytes do not tile the buffer (a gap or an overlap at {pos})")
        pos = end
    if pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - pos} bytes after the last tensor")
    return out
