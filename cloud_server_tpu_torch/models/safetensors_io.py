"""A small reader and writer of the safetensors format, for HuggingFace
checkpoint interop without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__": {str: str}}`, padded with spaces), then the tensors'
raw little-endian bytes, back to back, offsets relative to the end of
the header. `load_file` maps the file and returns tensors that view it
(`torch.frombuffer` over a copy-on-write `mmap`: nothing is read until a
tensor is used, and writing to one never touches the file);
`save_file` writes tensors contiguously in the layout the reference
implementation reads (largest element size first, then by name, so
every tensor starts at a multiple of its element size).
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header larger than this is not a safetensors file (the reference
# implementation's own limit)
_MAX_HEADER = 100_000_000


def read_header(path: str | os.PathLike) -> tuple[int, dict]:
    """(header length, header dict) of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header length {n} is not plausible")
        header = json.loads(f.read(n))
    return n, header


def load_file(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, each a view of the
    mapped file (dtypes F64/F32/F16/BF16, I64/I32/I16/I8, U8, BOOL)."""
    n, header = read_header(path)
    size = os.path.getsize(path)
    out: dict[str, torch.Tensor] = {}
    if size == 8 + n:  # no tensor bytes (mmap cannot map length 0)
        buf = None
    else:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, not one of {sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * itemsize or 8 + n + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}) for shape {list(shape)}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = 8 + n + begin
        if offset % itemsize:  # an unaligned writer: copy it out
            t = torch.frombuffer(bytearray(buf[offset:offset + end - begin]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count,
                                 offset=offset)
        out[name] = t.reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict[str, str] | None = None) -> int:
    """Write `tensors` (moved to the CPU, made contiguous) as one
    safetensors file; returns the bytes written."""
    items = []
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             "safetensors name")
        items.append((name, t.detach().to("cpu").contiguous()))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                # a byte view: numpy has no bfloat16
                f.write(memoryview(t.view(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset
