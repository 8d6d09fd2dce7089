"""Reader and writer of the safetensors file format, in numpy.

The format: an unsigned 64-bit little-endian header length N, N bytes of
JSON header mapping each tensor name to its dtype, shape and byte range
`data_offsets` (relative to the end of the header), then the raw
little-endian tensor bytes. The port carries this instead of depending on
the `safetensors` package, which the machines it runs on may not have.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U32": np.uint32,
    "U16": np.uint16,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_file(path: str | Path) -> dict[str, np.ndarray]:
    """Read every tensor of a safetensors file into numpy arrays."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"tensor '{name}' has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(body[start:end], dtype=dtype).reshape(info["shape"])
        out[name] = arr.astype(arr.dtype.newbyteorder("="))
    return out


def save_file(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """Write numpy arrays as a safetensors file (tensors in sorted name order,
    header padded with spaces to a multiple of 8 bytes)."""
    header: dict = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _NAMES:
            raise ValueError(f"tensor '{name}' has unsupported dtype {arr.dtype}")
        blob = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {
            "dtype": _NAMES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
