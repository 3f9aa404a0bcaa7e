"""A reader of the part of HDF5 that mdtraj trajectories use, with numpy
and the standard library only (the JAX package reads them with h5py).

It reads a dataset's values, and nothing else (no attributes), from files
with:

- superblock version 0 or 1, any size of offsets and lengths;
- version-1 object headers, with their continuation blocks;
- symbol-table groups (a version-1 group B-tree, ``SNOD`` nodes and a
  local heap);
- dataspace messages of version 1 and 2 (scalar or simple);
- IEEE floating-point (16, 32, 64 bit) and integer (8-64 bit) datatypes of
  either byte order;
- layout message version 3, contiguous or chunked, chunks indexed by a
  version-1 B-tree; edge chunks are stored whole and cut;
- the shuffle and deflate filters, with each chunk's filter mask.

Anything else raises `NotImplementedError` naming what it met (superblock
2 or 3, version-2 object headers, link-message groups, other filters such
as fletcher32, szip or lzf, compact or virtual layouts, other B-tree
versions, unallocated storage, external files, shared messages); a file
that contradicts itself raises `ValueError`.  It never returns values it
did not read from the file.

Usage: ``read_dataset("data/aldp_500K_train_mini.h5", "coordinates")``.
"""
import math
import struct
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types.
_NIL, _DATASPACE, _DATATYPE, _LAYOUT, _FILTERS = 0x0, 0x1, 0x3, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# Messages that do not change a dataset's values or a group's members:
# old and new fill value (storage is read only where allocated), attribute,
# comment, old and new modification time, B-tree 'K' values, attribute info,
# reference count.
_IGNORED = {0x4, 0x5, 0xC, 0xD, 0xE, 0x12, 0x13, 0x15, 0x16}
_MESSAGE_NAMES = {0x2: "link info", 0x6: "link", 0x7: "external data files", 0xA: "group info",
                  0x14: "bogus", 0x17: "object header continuation (v2)", 0x18: "b-tree v2 'K'"}

_DEFLATE, _SHUFFLE = 1, 2
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                 32001: "blosc", 307: "bzip2"}

# IEEE layouts by size: exponent location and size, mantissa location and
# size, exponent bias.
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}

Message = Tuple[int, int, bytes]  # (type, flags, body)


def _uint(buf: bytes, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos:pos + size], "little")


class _File:
    """An open HDF5 file: its superblock's sizes and reads at addresses."""

    def __init__(self, f):
        self.f = f
        f.seek(0, 2)
        self.size = f.tell()
        start = 0
        while True:
            if start + 8 > self.size:
                raise ValueError("not an HDF5 file (no superblock signature)")
            f.seek(start)
            if f.read(8) == _SIGNATURE:
                break
            start = 512 if start == 0 else 2 * start
        head = self._raw(start + 8, 16)
        version = head[0]
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock version {version} (only 0 and 1)")
        self.so, self.sl = head[5], head[6]  # sizes of offsets and lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"superblock sizes of offsets {self.so} and lengths {self.sl}")
        self.undefined = (1 << (8 * self.so)) - 1
        pos = start + 24 + (4 if version == 1 else 0)
        addresses = self._raw(pos, 4 * self.so)
        self.base = _uint(addresses, 0, self.so)
        # The root group's symbol table entry follows the four addresses.
        entry = self._raw(pos + 4 * self.so, 2 * self.so)
        self.root = _uint(entry, self.so, self.so)

    def _raw(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > self.size:
            raise ValueError(f"read of {n} bytes at {pos} past the end of the file ({self.size})")
        self.f.seek(pos)
        return self.f.read(n)

    def read(self, address: int, n: int) -> bytes:
        """``n`` bytes at a file address (relative to the base address)."""
        if address == self.undefined:
            raise ValueError("read at the undefined address")
        return self._raw(self.base + address, n)

    def address(self, buf: bytes, pos: int) -> int:
        return _uint(buf, pos, self.so)

    def length(self, buf: bytes, pos: int) -> int:
        return _uint(buf, pos, self.sl)

    # -- object headers -------------------------------------------------

    def messages(self, address: int) -> List[Message]:
        """The messages of the version-1 object header at ``address``,
        continuation blocks followed and NIL messages dropped."""
        prefix = self.read(address, 16)
        if prefix[:4] == b"OHDR":
            raise NotImplementedError("HDF5 version-2 object header (only version 1)")
        if prefix[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {prefix[0]} (only 1)")
        n_messages, header_size = struct.unpack_from("<H", prefix, 2)[0], _uint(prefix, 8, 4)
        blocks, out, seen = [(address + 16, header_size)], [], 0
        while blocks:
            start, size = blocks.pop(0)
            block, pos = self.read(start, size), 0
            while pos + 8 <= size and seen < n_messages:
                mtype, msize, mflags = struct.unpack_from("<HHB", block, pos)
                body = block[pos + 8:pos + 8 + msize]
                if len(body) != msize:
                    raise ValueError(f"object header message at {start + pos} overruns its block")
                pos += 8 + msize
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append((self.address(body, 0), self.length(body, self.so)))
                elif mtype != _NIL:
                    out.append((mtype, mflags, body))
        if seen != n_messages:
            raise ValueError(f"object header at {address}: {seen} of {n_messages} messages found")
        return out

    # -- groups -----------------------------------------------------------

    def btree_leaves(self, address: int, node_type: int, key_size: int) -> Iterator[Tuple[bytes, int]]:
        """(key, child address) of every leaf entry of a version-1 B-tree;
        the key is the one to the child's left."""
        head = self.read(address, 8 + 2 * self.so)
        if head[:4] != b"TREE":
            if head[:4] == b"BTHD":
                raise NotImplementedError("HDF5 version-2 B-tree (only version 1)")
            raise ValueError(f"no B-tree node at {address}")
        if head[4] != node_type:
            raise ValueError(f"B-tree node type {head[4]} at {address}, expected {node_type}")
        level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
        stride = key_size + self.so
        body = self.read(address + len(head), entries * stride + key_size)
        for i in range(entries):
            key = body[i * stride:i * stride + key_size]
            child = self.address(body, i * stride + key_size)
            if level > 0:
                yield from self.btree_leaves(child, node_type, key_size)
            else:
                yield key, child

    def _local_heap(self, address: int) -> bytes:
        head = self.read(address, 8 + 2 * self.sl + self.so)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise ValueError(f"no version-0 local heap at {address}")
        size = self.length(head, 8)
        return self.read(self.address(head, 8 + 2 * self.sl), size)

    def members(self, address: int) -> Dict[str, int]:
        """Name -> object header address of the group at ``address``."""
        messages = self.messages(address)
        tables = [body for mtype, _, body in messages if mtype == _SYMBOL_TABLE]
        if not tables:
            kinds = sorted({_MESSAGE_NAMES.get(t, hex(t)) for t, _, _ in messages})
            raise NotImplementedError(
                f"HDF5 object at {address} is not a symbol-table group (messages: {kinds})")
        btree, heap = self.address(tables[0], 0), self.address(tables[0], self.so)
        names = self._local_heap(heap)
        entry_size = 2 * self.so + 24
        out = {}
        for _, snod in self.btree_leaves(btree, 0, self.sl):
            head = self.read(snod, 8)
            if head[:4] != b"SNOD" or head[4] != 1:
                raise ValueError(f"no version-1 symbol table node at {snod}")
            count = struct.unpack_from("<H", head, 6)[0]
            entries = self.read(snod + 8, count * entry_size)
            for i in range(count):
                offset = self.length(entries, i * entry_size)
                end = names.index(b"\0", offset)
                out[names[offset:end].decode()] = self.address(entries, i * entry_size + self.so)
        return out

    # -- datasets ---------------------------------------------------------

    def dataset(self, address: int) -> np.ndarray:
        """The values of the dataset whose object header is at ``address``."""
        found: Dict[int, bytes] = {}
        for mtype, mflags, body in self.messages(address):
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                if mflags & 0x2:
                    raise NotImplementedError(f"HDF5 shared message of type {mtype:#x}")
                found[mtype] = body
            elif mtype not in _IGNORED:
                name = _MESSAGE_NAMES.get(mtype, "unknown")
                raise NotImplementedError(f"HDF5 object header message {mtype:#x} ({name})")
        for mtype, what in ((_DATASPACE, "dataspace"), (_DATATYPE, "datatype"), (_LAYOUT, "layout")):
            if mtype not in found:
                raise NotImplementedError(f"HDF5 object at {address} has no {what} message "
                                          "(not a dataset)")
        shape = self._dataspace(found[_DATASPACE])
        dtype = _datatype(found[_DATATYPE])
        filters = _filters(found[_FILTERS]) if _FILTERS in found else []
        layout = found[_LAYOUT]
        if layout[0] != 3:
            raise NotImplementedError(f"HDF5 data layout message version {layout[0]} (only 3)")
        kind = layout[1]
        if kind == 1:
            if filters:
                raise ValueError("filters on a contiguous dataset")
            data = self._contiguous(layout, shape, dtype)
        elif kind == 2:
            data = self._chunked(layout, shape, dtype, filters)
        else:
            name = {0: "compact", 3: "virtual"}.get(kind, f"class {kind}")
            raise NotImplementedError(f"HDF5 {name} data layout (only contiguous and chunked)")
        return data.astype(dtype.newbyteorder("="), copy=False)

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        version, ndim, flags = body[0], body[1], body[2]
        if version == 1:
            if flags & 0x2:
                raise NotImplementedError("HDF5 dataspace with a permutation index")
            pos = 8
        elif version == 2:
            if body[3] == 2:
                raise NotImplementedError("HDF5 null dataspace")
            pos = 4
        else:
            raise NotImplementedError(f"HDF5 dataspace message version {version} (only 1 and 2)")
        return tuple(self.length(body, pos + i * self.sl) for i in range(ndim))

    def _contiguous(self, layout: bytes, shape, dtype: np.dtype) -> np.ndarray:
        address, size = self.address(layout, 2), self.length(layout, 2 + self.so)
        nbytes = math.prod(shape) * dtype.itemsize
        if nbytes == 0:
            return np.empty(shape, dtype)
        if address == self.undefined:
            raise NotImplementedError("HDF5 dataset storage not allocated (fill values)")
        if size < nbytes:
            raise ValueError(f"contiguous storage of {size} bytes for {nbytes}")
        return np.frombuffer(self.read(address, nbytes), dtype).reshape(shape)

    def _chunked(self, layout: bytes, shape, dtype: np.dtype, filters) -> np.ndarray:
        rank = layout[2]  # dataset rank + 1: the last "dimension" is the element size
        btree = self.address(layout, 3)
        dims = struct.unpack_from(f"<{rank}I", layout, 3 + self.so)
        chunk, element = tuple(dims[:-1]), dims[-1]
        if len(chunk) != len(shape) or element != dtype.itemsize or 0 in chunk:
            raise ValueError(f"chunk dimensions {dims} for shape {shape} of {dtype}")
        out = np.empty(shape, dtype)
        expected = math.prod(-(-s // c) for s, c in zip(shape, chunk))
        if expected == 0:
            return out
        if btree == self.undefined:
            raise NotImplementedError("HDF5 dataset storage not allocated (fill values)")
        seen = set()
        for key, child in self.btree_leaves(btree, 1, 8 + 8 * rank):
            size, mask = struct.unpack_from("<II", key)
            offsets = struct.unpack_from(f"<{rank}Q", key, 8)[:-1]
            if any(o >= s for o, s in zip(offsets, shape)):
                continue  # a chunk past the current extent
            if any(o % c for o, c in zip(offsets, chunk)) or offsets in seen:
                raise ValueError(f"chunk offsets {offsets} for chunks of {chunk}")
            seen.add(offsets)
            raw = self.read(child, size)
            for i, (fid, _) in reversed(list(enumerate(filters))):
                if not mask & (1 << i):
                    raw = _unfilter(fid, raw, dtype.itemsize)
            if len(raw) != math.prod(chunk) * dtype.itemsize:
                raise ValueError(f"chunk at {offsets}: {len(raw)} bytes after the filters")
            values = np.frombuffer(raw, dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[dst] = values[tuple(slice(0, d.stop - d.start) for d in dst)]
        if len(seen) != expected:
            raise NotImplementedError(
                f"HDF5 dataset with {expected - len(seen)} of {expected} chunks not allocated "
                "(fill values)")
        return out


def _datatype(body: bytes) -> np.dtype:
    cls, bits = body[0] & 0x0F, _uint(body, 1, 3)
    size = _uint(body, 4, 4)
    order = ">" if bits & 0x1 else "<"
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise NotImplementedError(
                f"HDF5 integer of {size} bytes at bit offset {offset}, precision {precision}")
        return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")
    if cls == 1:  # floating point
        if bits & 0x40:
            raise NotImplementedError("HDF5 VAX-order floating point")
        offset, precision, epos, esize, mpos, msize, bias = struct.unpack_from("<HHBBBBI", body, 8)
        sign, norm = (bits >> 8) & 0xFF, (bits >> 4) & 0x3
        if (size not in _IEEE or offset != 0 or precision != 8 * size or sign != 8 * size - 1
                or norm != 2 or (epos, esize, mpos, msize, bias) != _IEEE[size]):
            raise NotImplementedError(f"HDF5 non-IEEE floating point of {size} bytes")
        return np.dtype(f"{order}f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumerated", 9: "variable-length", 10: "array"}
    raise NotImplementedError(f"HDF5 datatype class {cls} ({names.get(cls, 'unknown')})")


def _filters(body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    """(filter id, client data) of each filter of a pipeline, in the order
    they were applied on writing."""
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise NotImplementedError(f"HDF5 filter pipeline message version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(count):
        fid = struct.unpack_from("<H", body, pos)[0]
        pos += 2
        name_length = 0
        if version == 1 or fid >= 256:
            name_length = struct.unpack_from("<H", body, pos)[0]
            pos += 2
        _, n_values = struct.unpack_from("<HH", body, pos)
        pos += 4 + name_length
        values = struct.unpack_from(f"<{n_values}I", body, pos)
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (_DEFLATE, _SHUFFLE):
            name = _FILTER_NAMES.get(fid, "unknown")
            raise NotImplementedError(f"HDF5 filter {fid} ({name}); only shuffle and deflate")
        out.append((fid, values))
    return out


def _unfilter(fid: int, raw: bytes, itemsize: int) -> bytes:
    """Undo one filter of a chunk's bytes."""
    if fid == _DEFLATE:
        return zlib.decompress(raw)
    # Shuffle: byte j of every element lies in the j-th of ``itemsize``
    # planes; bytes past the last whole element are left as they are.
    n = len(raw) // itemsize
    planes = np.frombuffer(raw, np.uint8, count=n * itemsize).reshape(itemsize, n)
    return planes.T.tobytes() + raw[n * itemsize:]


def read_dataset(path, name: str) -> np.ndarray:
    """The values of dataset ``name`` (a ``/``-separated path from the root
    group) of the HDF5 file at ``path``, in native byte order."""
    with open(path, "rb") as f:
        h5 = _File(f)
        address = h5.root
        for part in [p for p in name.split("/") if p]:
            members = h5.members(address)
            if part not in members:
                raise KeyError(f"{name!r}: no member {part!r} in {path} (members: {sorted(members)})")
            address = members[part]
        return h5.dataset(address).copy()
