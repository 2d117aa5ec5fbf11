"""The reference's h5 frame store, read and written without h5py.

A raw clip keeps its JPEG frames in ``<clip>.h5``: one 1-D dataset named
after the clip, each element a variable-length uint8 sequence (one encoded
frame), as h5py writes ``create_dataset(name, (n,), dtype=vlen_dtype(uint8))``.
The card's machine has no h5py, so the port reads and writes that one layout
itself, in HDF5's original file format (superblock 0, a symbol-table root
group, version-1 object headers, a contiguous dataset, one global heap
collection per element), which is what h5py writes by default and reads
back.  ``write`` makes such a file; ``Reader`` (and ``read``, ``length``)
reads that layout from any HDF5 file of the original format (h5py's
included), through a memory map, so a clip of many gigabytes is read a
frame at a time.  Other layouts raise.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, List, Optional, Sequence

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16  # HDF5's defaults: 2K symbols a node
_HEAP_MIN = 4096  # the smallest global heap collection
_FREE_NULL = 1  # a local heap's "no free block"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    """One version-1 object header message: type, size, flags, data padded to 8."""
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: Sequence[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def write(path: str, key: str, items: Sequence[bytes]) -> None:
    """Write ``items`` as the file's only dataset, ``key``: element i holds
    the bytes of items[i]."""
    n = len(items)
    name = key.encode()
    out = bytearray(96)  # the superblock, filled in last

    def put(block: bytes) -> int:
        addr = len(out)
        out.extend(block)
        out.extend(b"\0" * (_pad8(len(out)) - len(out)))
        return addr

    # local heap of the link names: "" at 0, the dataset's name at 8
    seg = b"\0" * 8 + name + b"\0" * (_pad8(len(name) + 1) - len(name))
    heap_hdr = len(out)
    out.extend(b"\0" * 32)
    seg_addr = put(seg)
    out[heap_hdr:heap_hdr + 32] = b"HEAP" + struct.pack("<B3xQQQ", 0, len(seg), _FREE_NULL,
                                                              seg_addr)

    # one global heap collection per element
    refs = []
    for blob in items:
        used = 16 + 16 + _pad8(len(blob))
        size = max(_HEAP_MIN, used + 16)
        coll = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, size))
        coll += struct.pack("<HH4xQ", 1, 0, len(blob)) + blob
        coll += b"\0" * (used - len(coll))
        coll += struct.pack("<HH4xQ", 0, 0, size - used)  # the free space
        coll += b"\0" * (size - len(coll))
        refs.append((len(blob), put(bytes(coll))))
    raw = b"".join(struct.pack("<IQI", length, addr, 1) for length, addr in refs)
    raw_addr = put(raw) if raw else _UNDEF

    u8 = struct.pack("<B3sI", 0x10, b"\0\0\0", 1) + struct.pack("<HH", 0, 8)
    dset = _object_header([
        _message(0x0001, struct.pack("<BBB5xQQ", 1, 1, 1, n, n)),  # dataspace [n]
        _message(0x0003, struct.pack("<B3sI", 0x19, b"\0\0\0", 16) + u8, 1),  # vlen uint8
        _message(0x0005, struct.pack("<BBBBI", 2, 2, 0, 1, 0), 1),  # fill value: empty
        _message(0x0008, struct.pack("<BBQQ", 3, 1, raw_addr, len(raw))),  # contiguous
    ])
    dset_addr = put(dset)

    entry = struct.pack("<QQI4x16x", 8, dset_addr, 0)
    snod = b"SNOD" + struct.pack("<BxH", 1, 1) + entry
    snod_addr = put(snod + b"\0" * (8 + 2 * _LEAF_K * 40 - len(snod)))
    tree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
            + struct.pack("<QQQ", 0, snod_addr, 8))
    tree_addr = put(tree + b"\0" * (24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
                                    - len(tree)))
    root_addr = put(_object_header([_message(0x0011, struct.pack("<QQ", tree_addr, heap_hdr))]))

    out[:96] = (_SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                         _INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, _UNDEF, len(out), _UNDEF)
                + struct.pack("<QQI4xQQ", 0, root_addr, 1, tree_addr, heap_hdr))
    with open(path, "wb") as f:
        f.write(out)


class _File:
    def __init__(self, buf: bytes):
        self.b = buf
        if buf[:8] != _SIGNATURE or buf[8] != 0:
            raise ValueError("not an HDF5 file of the original format (superblock 0)")
        if buf[13] != 8 or buf[14] != 8:
            raise ValueError("only 8-byte offsets and lengths are read")

    def u(self, fmt: str, at: int):
        return struct.unpack_from("<" + fmt, self.b, at)

    def messages(self, addr: int) -> List[tuple]:
        """(type, data offset, size) of a version-1 object header's messages,
        continuation blocks followed."""
        version, _, count = self.u("BBH", addr)
        if version != 1:
            raise ValueError(f"object header version {version} is not read")
        size, = self.u("I", addr + 8)
        blocks, found = [(addr + 16, size)], []
        while blocks and len(found) < count:
            at, left = blocks.pop(0)
            end = at + left
            while at + 8 <= end and len(found) < count:
                mtype, msize = self.u("HH", at)
                found.append((mtype, at + 8, msize))
                if mtype == 0x0010:  # continuation
                    blocks.append(self.u("QQ", at + 8))
                at += 8 + msize
        return found

    def heap_object(self, coll: int, idx: int) -> bytes:
        """Object ``idx`` of the global heap collection at ``coll``."""
        if self.b[coll:coll + 4] != b"GCOL":
            raise ValueError("bad global heap collection")
        at, end = coll + 16, coll + self.u("Q", coll + 8)[0]
        while at + 16 <= end:
            oidx, _, size = self.u("HH4xQ", at)
            if oidx == idx:
                return self.b[at + 16:at + 16 + size]
            if oidx == 0:  # the free space ends the objects
                break
            at += 16 + _pad8(size)
        raise ValueError(f"global heap object {idx} not found")

    def links(self, group_addr: int) -> Dict[str, int]:
        """Link name -> object header address of a symbol-table group."""
        sym = [m for m in self.messages(group_addr) if m[0] == 0x0011]
        if not sym:
            raise ValueError("the group is not a symbol-table group")
        tree, heap = self.u("QQ", sym[0][1])
        if self.b[heap:heap + 4] != b"HEAP":
            raise ValueError("bad local heap")
        seg, = self.u("Q", heap + 24)
        out: Dict[str, int] = {}
        self._walk(tree, seg, out)
        return out

    def _walk(self, node: int, seg: int, out: Dict[str, int]) -> None:
        if self.b[node:node + 4] != b"TREE":
            raise ValueError("bad group B-tree node")
        ntype, level, used = self.u("BBH", node + 4)
        for i in range(used):
            child, = self.u("Q", node + 24 + 8 + 16 * i)
            if level:
                self._walk(child, seg, out)
                continue
            if self.b[child:child + 4] != b"SNOD":
                raise ValueError("bad symbol table node")
            nsym, = self.u("H", child + 6)
            for j in range(nsym):
                name_off, obj = self.u("QQ", child + 8 + 40 * j)
                end = self.b.find(b"\0", seg + name_off)
                out[self.b[seg + name_off:end].decode()] = obj


class Reader:
    """Dataset ``key`` of the file at ``path``, a 1-D vlen uint8 dataset with
    contiguous storage at the file's root, through a read-only memory map:
    ``len(r)`` elements, ``r[i]`` the bytes of element i.  Reads from several
    threads at once are safe."""

    def __init__(self, path: str, key: str):
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        h = self._file = _File(self._map)
        links = h.links(h.u("Q", 64)[0])
        if key not in links:
            raise KeyError(f"{path} has no dataset {key!r} (it has {sorted(links)})")
        msgs = {m[0]: m for m in h.messages(links[key])}
        _, at, _ = msgs[0x0001]
        version, rank = h.u("BB", at)
        if rank != 1:
            raise ValueError(f"dataset {key!r} has rank {rank}, not 1")
        self._n, = h.u("Q", at + (8 if version == 1 else 4))
        _, at, _ = msgs[0x0003]
        cls, size = h.b[at] & 0x0F, h.u("I", at + 4)[0]
        base_cls, base_size = h.b[at + 8] & 0x0F, h.u("I", at + 12)[0]
        if cls != 9 or (h.b[at + 1] & 0x0F) != 0 or base_cls != 0 or base_size != 1 or size != 16:
            raise ValueError(f"dataset {key!r} is not a vlen uint8 sequence")
        _, at, _ = msgs[0x0008]
        version, layout = h.u("BB", at)
        if version != 3 or layout != 1:
            raise ValueError(f"dataset {key!r}: layout {version}/{layout} is not contiguous v3")
        self._raw, = h.u("Q", at + 2)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> bytes:
        i = int(i)
        if not 0 <= i < self._n:
            raise IndexError(f"element {i} of a dataset of {self._n}")
        length, coll, idx = self._file.u("IQI", self._raw + 16 * i)
        return self._file.heap_object(coll, idx)[:length]

    def close(self) -> None:
        self._map.close()


def read(path: str, key: str, indices: Optional[Sequence[int]] = None) -> List[bytes]:
    """The bytes of the given elements (all when None) of dataset ``key``
    (see Reader)."""
    r = Reader(path, key)
    try:
        return [r[i] for i in (range(len(r)) if indices is None else indices)]
    finally:
        r.close()


def length(path: str, key: str) -> int:
    """The number of elements of dataset ``key``."""
    r = Reader(path, key)
    try:
        return len(r)
    finally:
        r.close()
