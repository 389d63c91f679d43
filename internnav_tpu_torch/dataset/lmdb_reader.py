"""Pure-Python LMDB reader and fixture writer, and the msgpack-numpy codec.

Port of internnav_tpu/dataset/lmdb_reader.py (the reference ships its
trajectory datasets as LMDB environments of msgpack_numpy-packed dicts,
internnav/dataset/cma_lmdb_dataset.py:41-95), with the Python reader only:
the JAX package's C++ walker (`NativeLMDBReader`, native/lmdb_reader) stays
its own, and `open_lmdb` always returns `LMDBReader`. Neither the `lmdb`
binding nor `msgpack` is needed: `packb` / `unpackb` are a pure-Python
msgpack of the types the codec meets (nil, bool, int, float, str, bin,
array, map), with msgpack-python's wire choices (the smallest int form,
float64, bin for bytes with use_bin_type), so the bytes equal the JAX
package's `msgpack.packb(obj, default=_mn_encode, use_bin_type=True)`.

Format notes (LMDB mdb.c, 64-bit build):
- data.mdb = array of pages; page size inferred by locating the second
  meta page's magic (candidates 4k..64k);
- meta pages 0/1: 16-byte page header, then MDB_meta {magic 0xBEEFC0DE,
  version, address, mapsize, MDB_db[2] (FREE + MAIN), last_pg, txnid};
  the live meta is the one with the larger txnid;
- MDB_db (48 bytes): pad u32, flags u16, depth u16, branch/leaf/overflow
  page counts u64, entries u64, root pgno u64;
- page header (16 bytes): pgno u64, pad u16, flags u16, lower u16,
  upper u16; node pointer array of u16 offsets starts at byte 16;
- node: lo u16, hi u16, flags u16, ksize u16, key, data. Leaf data size =
  lo | hi<<16; F_BIGDATA (0x01) stores an 8-byte overflow pgno instead,
  with the value starting 16 bytes into the first overflow page and
  running contiguously across the chain. Branch child pgno =
  lo | hi<<16 | flags<<32.

The writer emits a freshly-compacted single-tree environment (meta + leaf
/branch/overflow pages) good enough for fixtures and for round-tripping
through this reader; it is not a general transactional LMDB.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01
PAGE_HDR = 16
META_OFFSET = PAGE_HDR  # MDB_meta follows the page header
_DB_FMT = "<IHHQQQQQ"  # pad, flags, depth, branch, leaf, overflow, entries, root
_DB_SIZE = struct.calcsize(_DB_FMT)  # 48


def open_lmdb(path: str):
    """An LMDB environment's reader (the Python one; the JAX package's
    factory prefers its C++ walker when built, with the same surface)."""
    return LMDBReader(path)


# ------------------------------------------------------------------ reader
class LMDBReader:
    """Read-only view of an LMDB environment's main database."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        with open(path, "rb") as f:
            self._buf = f.read()
        self.page_size = self._find_page_size()
        meta = max((self._read_meta(0), self._read_meta(1)),
                   key=lambda m: m["txnid"])
        self.entries = meta["main"]["entries"]
        self._root = meta["main"]["root"]

    def _find_page_size(self) -> int:
        magic0 = struct.unpack_from("<I", self._buf, META_OFFSET)[0]
        if magic0 != MDB_MAGIC:
            raise ValueError("not an LMDB data file (bad meta magic)")
        for ps in (4096, 8192, 16384, 32768, 65536, 2048, 1024):
            if len(self._buf) >= ps + META_OFFSET + 4:
                m = struct.unpack_from("<I", self._buf, ps + META_OFFSET)[0]
                if m == MDB_MAGIC:
                    return ps
        raise ValueError("could not locate second meta page")

    def _read_meta(self, pgno: int) -> Dict[str, Any]:
        off = pgno * self.page_size + META_OFFSET if hasattr(self, "page_size") \
            else pgno * 4096 + META_OFFSET
        magic, version = struct.unpack_from("<II", self._buf, off)
        if magic != MDB_MAGIC:
            raise ValueError(f"bad meta magic at page {pgno}")
        off += 8
        _address, _mapsize = struct.unpack_from("<QQ", self._buf, off)
        off += 16
        dbs = []
        for _ in range(2):
            pad, flags, depth, br, lf, ov, entries, root = struct.unpack_from(
                _DB_FMT, self._buf, off)
            dbs.append({"flags": flags, "depth": depth, "entries": entries,
                        "root": root})
            off += _DB_SIZE
        last_pg, txnid = struct.unpack_from("<QQ", self._buf, off)
        return {"free": dbs[0], "main": dbs[1], "last_pg": last_pg,
                "txnid": txnid}

    # --------------------------------------------------------------- pages
    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """→ (offset, flags, lower, upper)."""
        off = pgno * self.page_size
        _pg, _pad, flags, lower, upper = struct.unpack_from(
            "<QHHHH", self._buf, off)
        return off, flags, lower, upper

    def _nodes(self, pgno: int):
        off, flags, lower, _ = self._page(pgno)
        n = (lower - PAGE_HDR) // 2
        for i in range(n):
            ptr = struct.unpack_from("<H", self._buf, off + PAGE_HDR + 2 * i)[0]
            yield off + ptr, flags

    def _iter_tree(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        if pgno == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty DB
            return
        _, pflags, _, _ = self._page(pgno)
        if pflags & P_LEAF2:
            raise NotImplementedError("MDB_DUPFIXED leaf2 pages")
        for node_off, _ in self._nodes(pgno):
            lo, hi, nflags, ksize = struct.unpack_from(
                "<HHHH", self._buf, node_off)
            if pflags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_tree(child)
            else:
                key = self._buf[node_off + 8: node_off + 8 + ksize]
                dsize = lo | (hi << 16)
                dstart = node_off + 8 + ksize
                if nflags & F_BIGDATA:
                    ovpg = struct.unpack_from("<Q", self._buf, dstart)[0]
                    o = ovpg * self.page_size + PAGE_HDR
                    data = self._buf[o: o + dsize]
                else:
                    data = self._buf[dstart: dstart + dsize]
                yield bytes(key), bytes(data)

    # ----------------------------------------------------------------- api
    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        yield from self._iter_tree(self._root)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes) -> Optional[bytes]:
        key = key if isinstance(key, bytes) else str(key).encode()
        for k, v in self.items():
            if k == key:
                return v
        return None

    def __len__(self) -> int:
        return self.entries


# ------------------------------------------------------------------ writer
class LMDBWriter:
    """Minimal compacted-environment writer (fixtures / store import).

    Builds one leaf level (+ one branch level when needed) from sorted
    keys; large values go to overflow chains. Readable by real lmdb and by
    LMDBReader.
    """

    def __init__(self, path: str, page_size: int = 4096):
        self.page_size = page_size
        if not os.path.splitext(path)[1]:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._kv: Dict[bytes, bytes] = {}

    def put(self, key, value) -> None:
        key = key if isinstance(key, bytes) else str(key).encode()
        value = value if isinstance(value, bytes) else bytes(value)
        self._kv[key] = value

    def _leaf_node(self, key: bytes, value: bytes, overflow_pgno=None) -> bytes:
        dsize = len(value)
        flags = F_BIGDATA if overflow_pgno is not None else 0
        hdr = struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, flags, len(key))
        body = key + (struct.pack("<Q", overflow_pgno)
                      if overflow_pgno is not None else value)
        node = hdr + body
        return node + b"\x00" * (len(node) % 2)  # 2-byte alignment

    def _branch_node(self, key: bytes, child: int) -> bytes:
        hdr = struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                          (child >> 32) & 0xFFFF, len(key))
        node = hdr + key
        return node + b"\x00" * (len(node) % 2)

    def _emit_page(self, pages: List[bytes], flags: int, nodes: List[bytes],
                   n_ov: int = 0) -> int:
        ps = self.page_size
        pgno = len(pages)
        ptrs, body = [], b""
        body_top = ps
        for node in reversed(nodes):
            body_top -= len(node)
            body = node + body
        lower = PAGE_HDR + 2 * len(nodes)
        hdr = struct.pack("<QHHHH", pgno, 0, flags, lower, body_top)
        off = body_top
        for node in nodes:
            ptrs.append(off)
            off += len(node)
        ptr_bytes = b"".join(struct.pack("<H", p) for p in ptrs)
        page = hdr + ptr_bytes
        page += b"\x00" * (body_top - len(page)) + body
        assert len(page) == ps, (len(page), ps)
        pages.append(page)
        return pgno

    def _emit_overflow(self, pages: List[bytes], value: bytes) -> int:
        ps = self.page_size
        total = PAGE_HDR + len(value)
        n_pages = -(-total // ps)
        pgno = len(pages)
        hdr = struct.pack("<QHHI", pgno, 0, P_OVERFLOW, n_pages)
        blob = hdr + value
        blob += b"\x00" * (n_pages * ps - len(blob))
        for i in range(n_pages):
            pages.append(blob[i * ps: (i + 1) * ps])
        return pgno

    def close(self) -> None:
        ps = self.page_size
        pages: List[bytes] = [b"", b""]  # meta slots filled last
        items = sorted(self._kv.items())

        # leaves (+ overflow chains), splitting by page capacity
        leaf_pages: List[Tuple[bytes, int]] = []  # (first key, pgno)
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_free = ps - PAGE_HDR

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_free
            if cur_nodes:
                pgno = self._emit_page(pages, P_LEAF, cur_nodes)
                leaf_pages.append((cur_first, pgno))
            cur_nodes, cur_first, cur_free = [], None, ps - PAGE_HDR

        for key, value in items:
            inline_limit = ps // 2 - 32
            if len(value) > inline_limit:
                ov = self._emit_overflow(pages, value)
                node = self._leaf_node(key, value, overflow_pgno=ov)
            else:
                node = self._leaf_node(key, value)
            need = len(node) + 2
            if need > cur_free:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(node)
            cur_free -= need
        flush_leaf()

        if not leaf_pages:
            root, depth = 0xFFFFFFFFFFFFFFFF, 0
        elif len(leaf_pages) == 1:
            root, depth = leaf_pages[0][1], 1
        else:
            nodes = []
            for i, (first, pgno) in enumerate(leaf_pages):
                nodes.append(self._branch_node(b"" if i == 0 else first, pgno))
            root = self._emit_page(pages, P_BRANCH, nodes)
            depth = 2

        n_leaf = len(leaf_pages)
        n_branch = 1 if depth == 2 else 0
        n_ov = len(pages) - 2 - n_leaf - n_branch
        free_db = struct.pack(_DB_FMT, 0, 0, 0, 0, 0, 0, 0,
                              0xFFFFFFFFFFFFFFFF)
        main_db = struct.pack(_DB_FMT, 0, 0, depth, n_branch, n_leaf, n_ov,
                              len(items), root)
        for slot, txnid in ((0, 1), (1, 2)):
            meta = struct.pack("<QHHHH", slot, 0, P_META, 0, 0)
            meta += struct.pack("<IIQQ", MDB_MAGIC, 1, 0, ps * max(len(pages), 4))
            meta += free_db + main_db
            meta += struct.pack("<QQ", len(pages) - 1, txnid)
            meta += b"\x00" * (ps - len(meta))
            pages[slot] = meta
        with open(self.path, "wb") as f:
            f.write(b"".join(pages))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ------------------------------------------------------- msgpack numpy ext
def _mn_encode(obj):
    """msgpack_numpy encoding hooks (the b'nd'/b'type'/b'shape'/b'data'
    dict convention)."""
    if isinstance(obj, np.ndarray):
        return {b"nd": True, b"type": obj.dtype.str,
                b"shape": list(obj.shape),
                b"data": obj.tobytes()}
    if isinstance(obj, (np.generic,)):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    return obj


def _mn_decode(obj):
    if isinstance(obj, dict):
        nd = obj.get(b"nd", obj.get("nd"))
        if nd is True:
            typ = obj.get(b"type", obj.get("type"))
            shape = obj.get(b"shape", obj.get("shape"))
            data = obj.get(b"data", obj.get("data"))
            return np.frombuffer(data, dtype=np.dtype(typ)).reshape(shape)
        if nd is False:
            typ = obj.get(b"type", obj.get("type"))
            data = obj.get(b"data", obj.get("data"))
            return np.frombuffer(data, dtype=np.dtype(typ))[0]
    return obj


def _pack_len(out: List[bytes], n: int, fix: Optional[int], fix_max: int,
              codes: Tuple[int, ...]) -> None:
    """A length header: the fix form under fix_max, else the 8- (where the
    type has one), 16- or 32-bit form."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, ("B", "H", "I")[3 - len(codes):],
                              (0xFF, 0xFFFF, 0xFFFFFFFF)[3 - len(codes):]):
        if n <= top:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(out: List[bytes], v: int) -> None:
    """msgpack-python's choice of form for an int."""
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"int {v} too large for msgpack")


def _pack(obj, out: List[bytes], default, depth: int = 0) -> None:
    if depth > 512:
        raise ValueError("object nested too deep for msgpack")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):  # np.float64 too, a float subclass
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, default, depth + 1)
            _pack(v, out, default, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out, default, depth + 1)
    else:
        new = default(obj)
        if new is obj:
            raise TypeError(f"cannot serialize {type(obj).__name__!r} object")
        _pack(new, out, default, depth + 1)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: bytes, pos: int, hook) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    elif b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    elif b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, hook)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, hook)
        v, pos = _unpack(buf, pos, hook)
        out[k] = v
    return hook(out), pos


def packb(obj) -> bytes:
    """msgpack bytes of obj, numpy arrays and scalars as msgpack_numpy's
    dicts (msgpack-python's packb with use_bin_type=True)."""
    out: List[bytes] = []
    _pack(obj, out, _mn_encode)
    return b"".join(out)


def unpackb(data: bytes):
    """The inverse of `packb` (msgpack-python's unpackb with raw=False,
    strict_map_key=False and the msgpack_numpy object hook)."""
    obj, pos = _unpack(memoryview(data).tobytes() if not isinstance(data, bytes) else data,
                       0, _mn_decode)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} extra bytes after the msgpack object")
    return obj


# ------------------------------------------------------------ dataset view
class LmdbTrajectoryReader:
    """Dict-style view over a reference trajectory LMDB (keys → unpacked
    msgpack_numpy dicts), the read surface cma_lmdb_dataset.py consumes."""

    def __init__(self, path: str):
        self.db = open_lmdb(path)
        self._keys = self.db.keys()

    def keys(self) -> List[str]:
        return [k.decode() for k in self._keys]

    def __len__(self) -> int:
        return len(self.db)

    def __getitem__(self, key: str):
        raw = self.db.get(key.encode() if isinstance(key, str) else key)
        if raw is None:
            raise KeyError(key)
        return unpackb(raw)

    def items(self):
        for k, v in self.db.items():
            yield k.decode(), unpackb(v)
