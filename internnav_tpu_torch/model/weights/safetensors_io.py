"""safetensors files, read and written without the `safetensors` package.

The format: an 8-byte little-endian header length, a JSON header naming
each tensor's dtype, shape and byte range (offsets from the end of the
header), then the raw little-endian bytes, with no gaps. Reading maps the
file (copy-on-write) and hands out CPU tensors on that map in their stored
dtype (`torch.frombuffer`): nothing is read from disk or converted until a
tensor is used, so a 7B checkpoint costs no host copy of its own. Writing
takes tensors on any device and copies one at a time to the host.
Sharded checkpoints are written as HF writes them: `model-00001-of-0000N.
safetensors` files and a `model.safetensors.index.json` weight map.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, List, Mapping, Optional

import torch

#: the dtypes the port reads and writes, by their safetensors name
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"
#: HF's default shard size
MAX_SHARD_BYTES = 5 * 2**30


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file: CPU tensors on a
    copy-on-write map of the file, in their stored dtypes. A tensor whose
    bytes do not start at a multiple of its element size is copied out."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file's {size}")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base, out = 8 + n, {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(DTYPES)}")
        dtype, shape = DTYPES[info["dtype"]], [int(d) for d in info["shape"]]
        start, end = (base + int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = math.prod(shape)
        if end - start != count * itemsize or end > size or start < base:
            raise ValueError(f"{path}: {name} {info} does not fit its shape or the file")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif start % itemsize:
            out[name] = torch.frombuffer(buf, dtype=torch.uint8, count=end - start,
                                         offset=start).clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=start).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (any device) to one .safetensors file, larger
    elements first so that every tensor starts at a multiple of its element
    size; each is copied to the host on its own. The file appears whole or
    not at all (written beside it, then renamed). Returns its size."""
    entries = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    offset = 0
    for name, t in entries:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in entries:
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)
    return 8 + len(raw) + offset


def save_sharded(tensors: Mapping[str, torch.Tensor], directory: str,
                 max_shard_bytes: int = MAX_SHARD_BYTES) -> List[str]:
    """Write `tensors` into `directory` as HF does: one `model.safetensors`
    when they fit one shard, else shards of at most max_shard_bytes (a
    larger tensor gets a shard of its own) in the order given, and
    `model.safetensors.index.json` ({"metadata": {"total_size"},
    "weight_map": {name: file}}). Returns the files written."""
    os.makedirs(directory, exist_ok=True)
    shards: List[List[str]] = [[]]
    used = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and used + nbytes > max_shard_bytes:
            shards.append([])
            used = 0
        shards[-1].append(name)
        used += nbytes
    if len(shards) == 1:
        write_safetensors(os.path.join(directory, SINGLE_FILE), tensors, {"format": "pt"})
        return [SINGLE_FILE]
    files = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    weight_map = {}
    for file, names in zip(files, shards):
        write_safetensors(os.path.join(directory, file), {n: tensors[n] for n in names},
                          {"format": "pt"})
        weight_map.update(dict.fromkeys(names, file))
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(directory, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return files + [INDEX_FILE]
