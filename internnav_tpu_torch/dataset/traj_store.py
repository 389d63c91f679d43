"""Trajectory store: an append-only key → bytes file, in pure Python.

The on-disk format of internnav_tpu/dataset/traj_store.py (whose native
library under `native/traj_store/` stays the JAX package's): a sequence of
records `<u32 klen><u32 vlen><key><value>`, last write wins per key, and a
`<path>.size` sidecar holding the valid byte count as a little-endian u64
(the native store maps the file with spare capacity past it). A zero key
length or a record running past the valid size ends the scan (torn tail).

Values of `put_tree` / `get_tree` are flat dicts of numpy arrays, str and
bytes, in the JAX package's self-describing codec.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np


class TrajStore:
    """dict-like append-only byte store. Every put is written through to
    the file and its size sidecar; no handle is held between calls."""

    def __init__(self, path: str, writable: bool = True):
        self.path = path
        self.writable = writable
        self._index: Dict[bytes, bytes] = {}
        self._size = 0
        if writable:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        elif not os.path.exists(path):
            raise FileNotFoundError(path)
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        limit = os.path.getsize(self.path)
        size_path = self.path + ".size"
        if os.path.exists(size_path):
            with open(size_path, "rb") as f:
                recorded = struct.unpack("<Q", f.read(8))[0]
            limit = min(limit, recorded) if recorded else limit
        with open(self.path, "rb") as f:
            data = f.read(limit)
        off = 0
        while off + 8 <= len(data):
            klen, vlen = struct.unpack_from("<II", data, off)
            end = off + 8 + klen + vlen
            if end > len(data) or klen == 0:
                break
            self._index[data[off + 8: off + 8 + klen]] = data[off + 8 + klen: end]
            off = end
        self._size = off

    # ------------------------------------------------------------- raw api
    def put(self, key: str, value: bytes) -> None:
        if not self.writable:
            raise IOError(f"{self.path} is open read-only")
        kb = key.encode()
        record = struct.pack("<II", len(kb), len(value)) + kb + value
        with open(self.path, "r+b" if os.path.exists(self.path) else "wb") as f:
            f.seek(self._size)
            f.write(record)
        self._size += len(record)
        with open(self.path + ".size", "wb") as f:
            f.write(struct.pack("<Q", self._size))
        self._index[kb] = value

    def get(self, key: str) -> Optional[bytes]:
        return self._index.get(key.encode())

    def keys(self) -> List[str]:
        return [k.decode() for k in self._index]

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index

    def sync(self) -> None:
        """Nothing to flush: every put is written through (the JAX
        package's native store syncs its mapped file here)."""

    def close(self) -> None:
        """Nothing to release: no handle is held between calls."""

    # ---------------------------------------------------------- tree codec
    @staticmethod
    def encode_tree(tree: Dict[str, Any]) -> bytes:
        """Serialize a flat dict of numpy arrays / scalars / str / bytes."""
        buf = io.BytesIO()
        items = list(tree.items())
        buf.write(struct.pack("<I", len(items)))
        for k, v in items:
            kb = k.encode()
            buf.write(struct.pack("<H", len(kb)) + kb)
            if isinstance(v, str):
                vb = v.encode()
                buf.write(b"s" + struct.pack("<I", len(vb)) + vb)
            elif isinstance(v, bytes):
                buf.write(b"b" + struct.pack("<I", len(v)) + v)
            else:
                hdr = io.BytesIO()
                np.save(hdr, np.asarray(v), allow_pickle=False)
                hb = hdr.getvalue()
                buf.write(b"n" + struct.pack("<I", len(hb)) + hb)
        return buf.getvalue()

    @staticmethod
    def decode_tree(data: bytes) -> Dict[str, Any]:
        buf = io.BytesIO(data)
        (n,) = struct.unpack("<I", buf.read(4))
        out: Dict[str, Any] = {}
        for _ in range(n):
            (klen,) = struct.unpack("<H", buf.read(2))
            k = buf.read(klen).decode()
            tag = buf.read(1)
            (vlen,) = struct.unpack("<I", buf.read(4))
            vb = buf.read(vlen)
            if tag == b"s":
                out[k] = vb.decode()
            elif tag == b"b":
                out[k] = vb
            else:
                out[k] = np.load(io.BytesIO(vb), allow_pickle=False)
        return out

    def put_tree(self, key: str, tree: Dict[str, Any]) -> None:
        self.put(key, self.encode_tree(tree))

    def get_tree(self, key: str) -> Optional[Dict[str, Any]]:
        raw = self.get(key)
        return None if raw is None else self.decode_tree(raw)
