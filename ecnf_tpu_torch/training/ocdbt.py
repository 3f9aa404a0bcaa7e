"""A read-only OCDBT key-value store: the on-disk format of the JAX
package's Orbax checkpoints (``ocp.PyTreeCheckpointer`` writes one through
tensorstore's OCDBT key-value store).

Layout as tensorstore writes it:

- ``manifest.ocdbt``: a header (magic ``0x0cdb3a2a``, its u64 length, a
  format version and a compression byte), the body (a zstd frame when
  compressed) and a CRC-32C trailer.  The body holds the store's config,
  a table of data files and the version tree; the newest version names
  the root B-tree node.
- B-tree nodes (magic ``0x0cdb20de``), laid out the same way, sit in data
  files under ``d/`` at an offset and length.  A node holds its own data
  file table, then its entries column by column: keys as (prefix shared
  with the previous key, suffix); in an interior node each entry also
  names how much of its key the child's keys leave out, and the child's
  location; in a leaf each value is inline (its bytes at the end of the
  node) or indirect (data file, offset, length).
- A data file is named by a base path and a relative path, both relative
  to the store's directory; the top-level store of a multi-process
  checkpoint points into ``ocdbt.process_*/d/*``.

Anything else (a numbered manifest, another format version or
compression) is refused by name.
"""
import os
from typing import Dict, List, Tuple, Union

from ecnf_tpu_torch.utils import zstd

__all__ = ["OcdbtStore", "crc32c"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_MAGIC = 0x0CDB20DE
_HEADER = 4 + 8  # magic + length, before the version and compression varints


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT manifests and nodes."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise ValueError(f"OCDBT {self.what}: truncated")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n : self.pos]

    def u32(self) -> int:
        return int.from_bytes(self.bytes(4), "little")

    def varint(self) -> int:
        value = shift = 0
        while True:
            c = self.byte()
            value |= (c & 0x7F) << shift
            if not c & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node after its header and CRC are checked."""
    if len(raw) < _HEADER + 2 + 4:
        raise ValueError(f"OCDBT {what}: truncated")
    if int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"OCDBT {what}: bad magic {raw[:4].hex()}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"OCDBT {what}: length {length} in its header, {len(raw)} on disk")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Reader(raw[: len(raw) - 4], what)
    head.pos = _HEADER
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise NotImplementedError(f"OCDBT {what}: format version {version} (only 0 is read)")
    body = raw[head.pos : len(raw) - 4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise NotImplementedError(f"OCDBT {what}: compression format {compression}")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    """Paths (base path + relative path) of the data files a node refers to."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data file table")
        full = prev[: prefix[i]] + r.bytes(suffix[i])
        if base[i] > len(full):
            raise ValueError(f"OCDBT {r.what}: bad data file base path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad key prefix")
        prev = prev[: prefix[i]] + r.bytes(suffix[i])
        keys.append(prev)
    return keys, subtree


# A value: its bytes (inline) or (data file path, offset, length).
_Value = Union[bytes, Tuple[str, int, int]]


class OcdbtStore:
    """``OcdbtStore(path).keys()`` and ``.read(key)`` of the newest version
    of the OCDBT store at ``path``; keys are ``bytes`` in sorted order."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: Dict[str, bytes] = {}
        manifest = os.path.join(self.path, "manifest.ocdbt")
        if not os.path.exists(manifest):
            raise ValueError(f"{self.path} is not an OCDBT store (no manifest.ocdbt)")
        with open(manifest, "rb") as f:
            r = _unwrap(f.read(), _MANIFEST_MAGIC, "manifest")
        r.bytes(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise NotImplementedError("OCDBT manifest kind 'numbered' (only 'single' is read)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # compression method: zstd, with its level
            r.u32()
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{self.path}: OCDBT manifest without a version")
        # Versions column by column; the newest is the last.
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self._index: Dict[bytes, _Value] = {}
        self.height = heights[-1]  # of the root B-tree node; 0 for a single leaf
        if lengths[-1]:
            root = (self._file_path(files, file_ids[-1], "manifest"), offsets[-1], lengths[-1])
            self._walk(root, self.height, b"")

    def _file_path(self, files: List[str], file_id: int, what: str) -> str:
        if file_id >= len(files):
            raise ValueError(f"OCDBT {what}: data file {file_id} not in its table")
        return files[file_id]

    def _read_range(self, ref: Tuple[str, int, int]) -> bytes:
        path, offset, length = ref
        data = self._files.get(path)
        if data is None:
            full = os.path.normpath(os.path.join(self.path, path))
            if not full.startswith(self.path + os.sep):
                raise ValueError(f"OCDBT data file {path!r} lies outside the store")
            with open(full, "rb") as f:
                data = self._files[path] = f.read()
        if offset + length > len(data):
            raise ValueError(f"OCDBT data file {path}: range {offset}+{length} past its end")
        return data[offset : offset + length]

    def _walk(self, ref: Tuple[str, int, int], height: int, prefix: bytes) -> None:
        r = _unwrap(self._read_range(ref), _BTREE_MAGIC, f"node {ref[0]}@{ref[1]}")
        if r.byte() != height:
            raise ValueError(f"OCDBT node {ref[0]}@{ref[1]}: height differs from its parent's")
        files = _data_file_table(r)
        n = r.varint()
        keys, subtree = _keys(r, n, interior=height > 0)
        if height > 0:
            file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                child = (self._file_path(files, file_ids[i], r.what), offsets[i], lengths[i])
                self._walk(child, height - 1, prefix + keys[i][: subtree[i]])
            r.varints(3 * n)  # the subtrees' key, tree-byte and indirect-byte counts
        else:
            self._leaf(r, files, keys, prefix)
        if r.pos != len(r.buf):
            raise ValueError(f"OCDBT {r.what}: {len(r.buf) - r.pos} bytes after its entries")

    def _leaf(self, r: _Reader, files: List[str], keys: List[bytes], prefix: bytes) -> None:
        n = len(keys)
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise NotImplementedError(f"OCDBT {r.what}: value kind other than inline or indirect")
        m = sum(kinds)
        file_ids, offsets = r.varints(m), r.varints(m)
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind:
                value = (self._file_path(files, file_ids[j], r.what), offsets[j], length)
                j += 1
            else:
                value = r.bytes(length)
            self._index[prefix + key] = value

    def keys(self) -> List[bytes]:
        return sorted(self._index)

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._index

    def read(self, key) -> bytes:
        """The value of ``key`` (``str`` or ``bytes``); ``KeyError`` when absent."""
        value = self._index[key.encode() if isinstance(key, str) else key]
        return value if isinstance(value, bytes) else self._read_range(value)
