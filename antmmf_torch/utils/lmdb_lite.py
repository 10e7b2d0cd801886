"""lmdb-lite: a pure-Python LMDB data-file reader and one-shot writer.

Own copy of ``antmmf_tpu/utils/lmdb_lite.py``, byte-compatible with it: the
on-disk LMDB data format (liblmdb ``mdb.c``; magic 0xBEEFC0DE, data version
1) written and read without the ``lmdb`` C library.

* ``LmdbLiteReader`` opens a ``data.mdb`` read-only: it picks the live meta
  page (the larger txnid of pages 0 and 1), walks the main B+tree (branch
  and leaf pages, ``F_BIGDATA`` overflow values) and offers
  ``get``/``keys``/``items``; ``get`` reads only the value it returns (the
  JAX copy reads every value of the leaf up to the key);
* ``LmdbLiteWriter`` packs sorted keys into leaf pages under as many branch
  levels as they need, large values in overflow pages (4096-byte pages,
  16-byte page headers, 8-byte node headers).

``open_lmdb`` uses the real ``lmdb`` package when it is installed and this
reader otherwise (the JAX package's native C++ reader is not ported).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

_PAGE_HDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODE_HDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf,
#                                   entries, root
_META_HEAD = struct.Struct("<IIQQ")  # magic, version, address, mapsize

INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class LmdbLiteError(RuntimeError):
    pass


class LmdbLiteReader:
    """Read-only access to an LMDB data file (no locks, snapshot-at-open)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        import mmap

        self._f = open(path, "rb")
        try:
            # page-cache-backed lazy reads (real liblmdb mmaps too) — packed
            # frame environments reach many GB; never copy them into Python
            self._data = mmap.mmap(self._f.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file etc.
            self._data = self._f.read()
        if len(self._data) < 2 * PAGE_SIZE:
            raise LmdbLiteError(f"{path}: too small for an LMDB file")
        self._root, self._entries = self._live_meta()

    # -- format parsing ----------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int, int, bytes]:
        off = pgno * PAGE_SIZE
        raw = self._data[off: off + PAGE_SIZE]
        if len(raw) < _PAGE_HDR.size:
            raise LmdbLiteError(f"page {pgno} out of range")
        _, _, flags, lower, upper = _PAGE_HDR.unpack_from(raw)
        return flags, lower, upper, raw

    def _live_meta(self) -> Tuple[int, int]:
        best: Optional[Tuple[int, int, int]] = None
        for pgno in (0, 1):
            flags, _, _, raw = self._page(pgno)
            if not flags & P_META:
                continue
            magic, version, _, _ = _META_HEAD.unpack_from(raw, 16)
            if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
                continue
            main_off = 16 + _META_HEAD.size + _DB.size
            db = _DB.unpack_from(raw, main_off)
            txnid = struct.unpack_from("<Q", raw, main_off + _DB.size + 8)[0]
            if best is None or txnid >= best[0]:
                best = (txnid, db[7], db[6])  # txnid, root, entries
        if best is None:
            raise LmdbLiteError("no valid LMDB meta page")
        return best[1], best[2]

    def _nodes(self, raw: bytes) -> List[int]:
        _, _, _, lower, _ = _PAGE_HDR.unpack_from(raw)
        n = (lower - _PAGE_HDR.size) // 2
        return [struct.unpack_from("<H", raw, _PAGE_HDR.size + 2 * i)[0]
                for i in range(n)]

    def _leaf_node(self, raw: bytes, off: int) -> Tuple[bytes, bytes]:
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(raw, off)
        key = raw[off + 8: off + 8 + ksize]
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from(
                "<Q", raw, off + 8 + ksize)[0]
            return key, self._overflow(ovf_pgno, dsize)
        data = raw[off + 8 + ksize: off + 8 + ksize + dsize]
        return key, data

    def _branch_node(self, raw: bytes, off: int) -> Tuple[bytes, int]:
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(raw, off)
        pgno = lo | (hi << 16) | (flags << 32)
        key = raw[off + 8: off + 8 + ksize]
        return key, pgno

    def _overflow(self, pgno: int, size: int) -> bytes:
        # the payload runs on across the chain's consecutive pages after the
        # first page's header (mdb.c OVERFLOW layout): one slice
        off = pgno * PAGE_SIZE + _PAGE_HDR.size
        return bytes(self._data[off: off + size])

    # -- public API --------------------------------------------------------
    def __len__(self) -> int:
        return self._entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._root == INVALID_PGNO:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            flags, _, _, raw = self._page(pgno)
            if flags & P_LEAF:
                for off in self._nodes(raw):
                    yield self._leaf_node(raw, off)
            elif flags & P_BRANCH:
                kids = [self._branch_node(raw, off)[1]
                        for off in self._nodes(raw)]
                stack.extend(reversed(kids))
            else:
                raise LmdbLiteError(f"unexpected page flags {flags:#x}")

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        if self._root == INVALID_PGNO:
            return None
        pgno = self._root
        while True:
            flags, _, _, raw = self._page(pgno)
            offs = self._nodes(raw)
            if flags & P_LEAF:
                for off in offs:
                    # compare the key before reading the value: values of
                    # packed clips run to megabytes
                    ksize = _NODE_HDR.unpack_from(raw, off)[3]
                    if raw[off + 8: off + 8 + ksize] == key:
                        return self._leaf_node(raw, off)[1]
                return None
            # branch: follow the rightmost child whose key <= target
            # (the first branch node's key is implicit/empty)
            child = None
            for i, off in enumerate(offs):
                k, p = self._branch_node(raw, off)
                if i == 0 or k <= key:
                    child = p
                else:
                    break
            pgno = child


class LmdbLiteWriter:
    """One-shot LMDB environment writer (sorted bulk load).

    Supports data sizes up to one branch level (≈ page_size/16 leaves ≈
    hundreds of thousands of small entries) — the fixture/feature-pack
    scale; values larger than the in-leaf max go to overflow pages."""

    def __init__(self, path: str):
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self._path = path
        self._kv: Dict[bytes, bytes] = {}

    def put(self, key, value) -> None:
        if isinstance(key, str):
            key = key.encode("utf-8")
        if isinstance(value, str):
            value = value.encode("utf-8")
        self._kv[bytes(key)] = bytes(value)

    # -- layout ------------------------------------------------------------
    @staticmethod
    def _leaf_page(pgno: int, nodes: List[bytes]) -> bytes:
        lower = _PAGE_HDR.size + 2 * len(nodes)
        sizes = [len(n) + len(n) % 2 for n in nodes]
        upper = PAGE_SIZE - sum(sizes)
        page = bytearray(PAGE_SIZE)
        _PAGE_HDR.pack_into(page, 0, pgno, 0, P_LEAF, lower, upper)
        off = PAGE_SIZE
        ptrs = []
        for node, size in zip(nodes, sizes):
            off -= size
            page[off: off + len(node)] = node
            ptrs.append(off)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", page, _PAGE_HDR.size + 2 * i, p)
        return bytes(page)

    def save(self) -> str:
        items = sorted(self._kv.items())
        pages: List[bytes] = [b"", b""]  # meta placeholders
        next_pgno = 2

        def alloc() -> int:
            nonlocal next_pgno
            pages.append(b"")
            next_pgno += 1
            return next_pgno - 1

        max_inline = PAGE_SIZE // 4  # conservative in-leaf value cap
        leaf_specs: List[Tuple[bytes, List[bytes]]] = []
        cur_nodes: List[bytes] = []
        cur_size = _PAGE_HDR.size
        cur_first: Optional[bytes] = None
        n_overflow = 0

        def flush_leaf():
            nonlocal cur_nodes, cur_size, cur_first
            if cur_nodes:
                leaf_specs.append((cur_first, cur_nodes))
            cur_nodes, cur_size, cur_first = [], _PAGE_HDR.size, None

        overflow_blobs: List[Tuple[int, bytes]] = []
        for key, value in items:
            if len(value) > max_inline:
                # overflow chain: header on first page only, then raw pages
                total = _PAGE_HDR.size + len(value)
                npages = (total + PAGE_SIZE - 1) // PAGE_SIZE
                first = next_pgno
                for _ in range(npages):
                    alloc()
                overflow_blobs.append((first, value))
                n_overflow += npages
                node = _NODE_HDR.pack(len(value) & 0xFFFF,
                                      (len(value) >> 16) & 0xFFFF,
                                      F_BIGDATA, len(key)) + key + \
                    struct.pack("<Q", first)
            else:
                node = _NODE_HDR.pack(len(value) & 0xFFFF,
                                      (len(value) >> 16) & 0xFFFF,
                                      0, len(key)) + key + value
            need = 2 + len(node) + len(node) % 2
            if cur_size + need > PAGE_SIZE:
                flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(node)
            cur_size += need
        flush_leaf()

        leaf_pgnos = [alloc() for _ in leaf_specs]
        for pgno, (_, nodes) in zip(leaf_pgnos, leaf_specs):
            pages[pgno] = self._leaf_page(pgno, nodes)

        def _branch_page(pgno: int, nodes: List[bytes]) -> bytes:
            lower = _PAGE_HDR.size + 2 * len(nodes)
            sizes = [len(n) + len(n) % 2 for n in nodes]
            upper = PAGE_SIZE - sum(sizes)
            page = bytearray(PAGE_SIZE)
            _PAGE_HDR.pack_into(page, 0, pgno, 0, P_BRANCH, lower, upper)
            off = PAGE_SIZE
            ptrs = []
            for node, size in zip(nodes, sizes):
                off -= size
                page[off: off + len(node)] = node
                ptrs.append(off)
            for i, p in enumerate(ptrs):
                struct.pack_into("<H", page, _PAGE_HDR.size + 2 * i, p)
            return bytes(page)

        n_branch = 0
        if not leaf_specs:
            root = INVALID_PGNO
            depth = 0
        elif len(leaf_specs) == 1:
            root = leaf_pgnos[0]
            depth = 1
        else:
            # build branch levels bottom-up until one root page remains
            # (arbitrary tree depth — packed video/feature environments can
            # exceed one branch level easily)
            level: List[Tuple[bytes, int]] = [
                (first_key, pgno)
                for (first_key, _), pgno in zip(leaf_specs, leaf_pgnos)]
            depth = 1
            while len(level) > 1:
                depth += 1
                next_level: List[Tuple[bytes, int]] = []
                group_nodes: List[bytes] = []
                group_first: Optional[bytes] = None
                group_size = _PAGE_HDR.size

                def flush_branch():
                    nonlocal group_nodes, group_first, group_size, n_branch
                    if group_nodes:
                        pgno = alloc()
                        pages[pgno] = _branch_page(pgno, group_nodes)
                        next_level.append((group_first, pgno))
                        n_branch += 1
                    group_nodes, group_first = [], None
                    group_size = _PAGE_HDR.size

                for i, (first_key, child_pgno) in enumerate(level):
                    key = b"" if not group_nodes else first_key
                    node = _NODE_HDR.pack(
                        child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                        (child_pgno >> 32) & 0xFFFF, len(key)) + key
                    need = 2 + len(node) + len(node) % 2
                    # reserve room for at least two children per branch page
                    if group_size + need > PAGE_SIZE and len(group_nodes) >= 2:
                        flush_branch()
                        key = b""
                        node = _NODE_HDR.pack(
                            child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                            (child_pgno >> 32) & 0xFFFF, len(key)) + key
                        need = 2 + len(node) + len(node) % 2
                    if group_first is None:
                        group_first = first_key
                    group_nodes.append(node)
                    group_size += need
                flush_branch()
                level = next_level
            root = level[0][1]

        # overflow chains
        for first, value in overflow_blobs:
            blob = bytearray(_PAGE_HDR.size) + value
            npages = (len(blob) + PAGE_SIZE - 1) // PAGE_SIZE
            _PAGE_HDR.pack_into(blob, 0, first, 0, P_OVERFLOW, 0, 0)
            # lower field reuse: mdb stores the page count in pb_pages
            struct.pack_into("<I", blob, 12, npages)
            blob += b"\0" * (npages * PAGE_SIZE - len(blob))
            for i in range(npages):
                pages[first + i] = bytes(
                    blob[i * PAGE_SIZE: (i + 1) * PAGE_SIZE])

        last_pg = len(pages) - 1

        def meta(pgno: int, txnid: int) -> bytes:
            page = bytearray(PAGE_SIZE)
            _PAGE_HDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            _META_HEAD.pack_into(page, 16, MDB_MAGIC, MDB_DATA_VERSION, 0,
                                 max(len(pages) * PAGE_SIZE, 1 << 20))
            free_off = 16 + _META_HEAD.size
            _DB.pack_into(page, free_off, 0, 0, 0, 0, 0, 0, 0, INVALID_PGNO)
            main_off = free_off + _DB.size
            _DB.pack_into(page, main_off, 0, 0, depth, n_branch,
                          len(leaf_specs), n_overflow, len(items), root)
            tail = main_off + _DB.size
            struct.pack_into("<QQ", page, tail, last_pg, txnid)
            return bytes(page)

        pages[0] = meta(0, 0)
        pages[1] = meta(1, 1)
        with open(self._path, "wb") as f:
            for raw in pages:
                f.write(raw if raw else b"\0" * PAGE_SIZE)
        return self._path


class _RealLmdbShim:
    def __init__(self, env):
        self._env = env

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        with self._env.begin() as txn:
            return txn.get(key)

    def keys(self) -> List[bytes]:
        with self._env.begin() as txn:
            return [k for k, _ in txn.cursor()]


def open_lmdb(path: str):
    """Open an LMDB environment read-only: the real ``lmdb`` package when it
    is installed, else ``LmdbLiteReader``; both offer ``get``/``keys``."""
    try:
        import lmdb  # type: ignore

        if not hasattr(lmdb, "open"):  # a bare stub module, not real lmdb
            raise ImportError("lmdb stub")
        # LmdbLiteWriter may write a flat data file; real lmdb needs
        # subdir=False for those
        return _RealLmdbShim(lmdb.open(path, readonly=True, lock=False, readahead=False,
                                       subdir=os.path.isdir(path)))
    except Exception:
        return LmdbLiteReader(path)
