"""Zstandard decompression (RFC 8878) in Python and numpy.

The JAX package's Orbax checkpoints hold every array chunk, B-tree node
and manifest body as a zstd frame (`ecnf_tpu_torch.training.ocdbt`,
`training.orbax`).  Neither the card's machine nor Python's standard
library has a zstd decoder, so the port carries this one; it never falls
back to another, so a fault here shows as an error, not as a silent
switch.

What it reads: concatenated frames and skippable frames; raw, RLE and
compressed blocks; raw, RLE, Huffman (1 or 4 streams) and treeless
literals; predefined, RLE, FSE and repeat sequence tables; repeat offsets;
the XXH64 content checksum.  A malformed or truncated frame or a wrong
checksum raises ``ValueError``; a dictionary other than 0 raises
``NotImplementedError``.

Huffman literals, the bulk of a float array's frame, are decoded from a
table lookup at every bit position of a stream (numpy) followed by one
walk of the chain of positions the stream visits, so the per-symbol
Python work is one list lookup.
"""
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decompress", "xxh64"]

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MAGIC = 0x184D2A50  # the low four bits are free
_MAX_BLOCK = 128 * 1024
_M64 = (1 << 64) - 1


def _need(buf, end: int) -> None:
    if end > len(buf):
        raise ValueError("zstd: truncated frame")


# ---------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    acc = ((acc << 31) | (acc >> 33)) & _M64
    return (acc * _P1) & _M64


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the zstd content checksum keeps its
    low 32 bits)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (_P1 + _P2) & _M64
        v2 = _P2
        v3 = 0
        v4 = (-_P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        for k in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[k])
            v2 = _round(v2, lanes[k + 1])
            v3 = _round(v3, lanes[k + 2])
            v4 = _round(v4, lanes[k + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = stripes * 32
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i : i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i : i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- bit streams


class _ForwardBits:
    """Bits read from the low end of ``buf`` upwards (FSE table headers)."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def read(self, n: int) -> int:
        lo, hi = self.pos, self.pos + n
        _need(self.buf, (hi + 7) >> 3)
        self.pos = hi
        return (int.from_bytes(self.buf[lo >> 3 : (hi + 7) >> 3], "little") >> (lo & 7)) & ((1 << n) - 1)

    def nbytes(self) -> int:
        return (self.pos + 7) >> 3


class _BackwardBits:
    """A zstd backward bit stream: read from the marker bit of the last byte
    down; bits below the start read as 0 and leave ``pos`` negative."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ValueError("zstd: bit stream without its end marker")
        self.buf = buf
        self.pos = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo >= 0:
            v = int.from_bytes(self.buf[lo >> 3 : (lo + n + 7) >> 3], "little") >> (lo & 7)
            return v & ((1 << n) - 1)
        if lo + n <= 0:
            return 0
        v = int.from_bytes(self.buf[: (lo + n + 7) >> 3], "little") & ((1 << (lo + n)) - 1)
        return v << -lo


# ---------------------------------------------------------------- FSE


def _read_fse_header(buf: bytes, max_log: int, max_symbols: int) -> Tuple[List[int], int, int]:
    """(normalized counts, accuracy log, bytes used) of an FSE table description."""
    bits = _ForwardBits(buf)
    log = 5 + bits.read(4)
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} above {max_log}")
    remaining = 1 << log
    counts: List[int] = []
    while remaining > 0 and len(counts) < max_symbols:
        nbits = (remaining + 1).bit_length()
        val = bits.read(nbits)
        lower_mask = (1 << (nbits - 1)) - 1
        threshold = (1 << nbits) - 1 - (remaining + 1)
        if (val & lower_mask) < threshold:
            bits.pos -= 1
            val &= lower_mask
        elif val > lower_mask:
            val -= threshold
        proba = val - 1
        remaining -= -proba if proba < 0 else proba
        counts.append(proba)
        if proba == 0:
            while True:
                repeat = bits.read(2)
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
            if len(counts) > max_symbols:
                raise ValueError("zstd: FSE table with too many symbols")
    if remaining != 0:
        raise ValueError("zstd: FSE table counts do not sum to the table size")
    return counts, log, bits.nbytes()


def _fse_table(counts: List[int], log: int):
    """Decoding table ``(symbols, nbits, base)`` of a normalized distribution."""
    size = 1 << log
    symbols = [0] * size
    high = size
    next_desc = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            high -= 1
            symbols[high] = s
            next_desc[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        if c <= 0:
            continue
        next_desc[s] = c
        for _ in range(c):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: FSE table spread does not close")
    nbits, base = [0] * size, [0] * size
    for i in range(size):
        d = next_desc[symbols[i]]
        next_desc[symbols[i]] = d + 1
        nb = log - (d.bit_length() - 1)
        nbits[i] = nb
        base[i] = (d << nb) - size
    return symbols, nbits, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


# ---------------------------------------------------------------- Huffman


def _huffman_weights_fse(buf: bytes) -> List[int]:
    counts, log, used = _read_fse_header(buf, max_log=6, max_symbols=256)
    symbols, nbits, base, _ = _fse_table(counts, log)
    bits = _BackwardBits(buf[used:])
    s1, s2 = bits.read(log), bits.read(log)
    out: List[int] = []
    while True:
        out.append(symbols[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            out.append(symbols[s2])
            break
        out.append(symbols[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            out.append(symbols[s1])
            break
        if len(out) > 255:
            raise ValueError("zstd: too many Huffman weights")
    return out


def _huffman_table(buf: bytes) -> Tuple[Tuple[np.ndarray, np.ndarray, int], int]:
    """((symbol, code length) indexed by a max_bits window, max_bits), bytes used."""
    _need(buf, 1)
    head = buf[0]
    if head < 128:
        _need(buf, 1 + head)
        weights, used = _huffman_weights_fse(buf[1 : 1 + head]), 1 + head
    else:
        n = head - 127
        used = 1 + (n + 1) // 2
        _need(buf, used)
        weights = [(buf[1 + i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
    if len(weights) > 255 or max(weights, default=0) > 11:
        raise ValueError("zstd: bad Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: Huffman weights all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ValueError("zstd: Huffman weights do not complete a tree")
    weights.append(left.bit_length())
    if max_bits > 11:
        raise ValueError("zstd: Huffman code longer than 11 bits")
    lengths = [max_bits + 1 - w if w else 0 for w in weights]
    rank_count = [0] * (max_bits + 1)
    for n in lengths:
        rank_count[n] += 1
    size = 1 << max_bits
    rank_start = [0] * (max_bits + 1)
    nb = np.zeros(size, np.int64)
    start = 0
    for n in range(max_bits, 0, -1):
        rank_start[n] = start
        end = start + rank_count[n] * (1 << (max_bits - n))
        nb[start:end] = n
        start = end
    if start != size:
        raise ValueError("zstd: Huffman code table does not fill")
    sym = np.zeros(size, np.uint8)
    for s, n in enumerate(lengths):
        if n:
            span = 1 << (max_bits - n)
            sym[rank_start[n] : rank_start[n] + span] = s
            rank_start[n] += span
    return (sym, nb, max_bits), used


def _huffman_stream(stream: bytes, table, count: int) -> np.ndarray:
    """``count`` literals of one backward Huffman stream."""
    sym, nb, max_bits = table
    if not stream or stream[-1] == 0:
        raise ValueError("zstd: Huffman stream without its end marker")
    total = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
    bits = np.unpackbits(np.frombuffer(stream, np.uint8), bitorder="little")[:total]
    # padded[q] is bit q - max_bits of the stream, so window[p] (the max_bits
    # bits just below position p, zeros below the start) is padded[p : p + max_bits].
    padded = np.zeros(total + max_bits, np.int64)
    padded[max_bits:] = bits
    window = np.zeros(total + 1, np.int64)
    for j in range(max_bits):
        window |= padded[j : j + total + 1] << j
    # Positions below 0 (an overrun) loop on themselves; the end check catches them.
    nxt = np.arange(-max_bits, total + 1, dtype=np.int64)
    nxt[max_bits:] -= nb[window]
    nxt = (nxt + max_bits).clip(0).tolist()
    path = [0] * count
    q = total + max_bits
    for i in range(count):
        path[i] = q
        q = nxt[q]
    if q != max_bits:
        raise ValueError("zstd: Huffman stream not consumed exactly")
    return sym[window[np.asarray(path, np.int64) - max_bits]]


# ---------------------------------------------------------------- sequences

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# (default counts, default accuracy log, max accuracy log, number of symbols)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6, 9, 36)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                -1, -1, -1, -1, -1], 5, 8, 32)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6, 9, 53)


@lru_cache(maxsize=None)
def _predefined(which: int):
    counts, log, _, _ = (_LL_DEFAULT, _OF_DEFAULT, _ML_DEFAULT)[which]
    return _fse_table(counts, log)


class _FrameState:
    """What a block may reuse from the frame's earlier blocks."""

    def __init__(self):
        self.huffman = None
        self.tables: List[Optional[tuple]] = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _sequence_table(buf: bytes, pos: int, mode: int, which: int, state: _FrameState):
    _, _, max_log, n_symbols = (_LL_DEFAULT, _OF_DEFAULT, _ML_DEFAULT)[which]
    if mode == 0:
        table = _predefined(which)
    elif mode == 1:
        _need(buf, pos + 1)
        if buf[pos] >= n_symbols:
            raise ValueError("zstd: RLE sequence code out of range")
        table = _rle_table(buf[pos])
        pos += 1
    elif mode == 2:
        counts, log, used = _read_fse_header(buf[pos:], max_log, n_symbols)
        table = _fse_table(counts, log)
        pos += used
    else:
        table = state.tables[which]
        if table is None:
            raise ValueError("zstd: repeat sequence table without an earlier one")
    state.tables[which] = table
    return table, pos


def _execute_sequences(buf: bytes, pos: int, literals: bytes, state: _FrameState,
                       out: bytearray) -> None:
    _need(buf, pos + 1)
    b0 = buf[pos]
    if b0 == 0:
        if pos + 1 != len(buf):
            raise ValueError("zstd: bytes after an empty sequences section")
        out += literals
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        _need(buf, pos + 2)
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        _need(buf, pos + 3)
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    _need(buf, pos + 1)
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence modes")
    (ll_sym, ll_nb, ll_base, ll_log), pos = _sequence_table(buf, pos, modes >> 6, 0, state)
    (of_sym, of_nb, of_base, of_log), pos = _sequence_table(buf, pos, (modes >> 4) & 3, 1, state)
    (ml_sym, ml_nb, ml_base, ml_log), pos = _sequence_table(buf, pos, (modes >> 2) & 3, 2, state)
    bits = _BackwardBits(buf[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = state.rep
    lit = 0
    n_lit = len(literals)
    for i in range(nseq):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ValueError("zstd: offset code out of range")
        offset_value = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            rep = [offset, rep[0], rep[1]]
        else:
            idx = offset_value - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[0] - 1 if idx == 3 else rep[idx]
                rep = [offset, rep[0], rep[2]] if idx == 1 else [offset, rep[0], rep[1]]
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lit + ll > n_lit:
            raise ValueError("zstd: sequence reads past its literals")
        out += literals[lit : lit + ll]
        lit += ll
        if offset == 0 or offset > len(out):
            raise ValueError("zstd: match offset outside the decoded output")
        start = len(out) - offset
        if offset >= ml:
            out += out[start : start + ml]
        else:
            chunk = out[start:]
            out += (chunk * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ValueError("zstd: sequence stream not consumed exactly")
    state.rep = rep
    out += literals[lit:]


# ---------------------------------------------------------------- blocks and frames


def _literals(buf: bytes, state: _FrameState) -> Tuple[bytes, int]:
    _need(buf, 1)
    b0 = buf[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        if size_format in (0, 2):
            size, pos = b0 >> 3, 1
        elif size_format == 1:
            _need(buf, 2)
            size, pos = (b0 >> 4) + (buf[1] << 4), 2
        else:
            _need(buf, 3)
            size, pos = (b0 >> 4) + (buf[1] << 4) + (buf[2] << 12), 3
        if kind == 0:
            _need(buf, pos + size)
            return bytes(buf[pos : pos + size]), pos + size
        _need(buf, pos + 1)
        return bytes(buf[pos : pos + 1]) * size, pos + 1
    head_len = {0: 3, 1: 3, 2: 4, 3: 5}[size_format]
    _need(buf, head_len)
    head = int.from_bytes(buf[:head_len], "little")
    field = {3: 10, 4: 14, 5: 18}[head_len]
    regen = (head >> 4) & ((1 << field) - 1)
    comp = (head >> (4 + field)) & ((1 << field) - 1)
    _need(buf, head_len + comp)
    section = buf[head_len : head_len + comp]
    if kind == 2:
        state.huffman, used = _huffman_table(section)
        section = section[used:]
    elif state.huffman is None:
        raise ValueError("zstd: treeless literals without an earlier Huffman table")
    table = state.huffman
    if size_format == 0:
        lits = _huffman_stream(section, table, regen)
    else:
        _need(section, 6)
        sizes = [int.from_bytes(section[2 * k : 2 * k + 2], "little") for k in range(3)]
        sizes.append(len(section) - 6 - sum(sizes))
        seg = (regen + 3) // 4
        counts = [seg, seg, seg, regen - 3 * seg]
        if sizes[3] < 0 or counts[3] < 0:
            raise ValueError("zstd: bad 4-stream literals jump table")
        parts, at = [], 6
        for size, count in zip(sizes, counts):
            parts.append(_huffman_stream(section[at : at + size], table, count))
            at += size
        lits = np.concatenate(parts)
    return lits.tobytes(), head_len + comp


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    _need(data, pos + 1)
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ValueError("zstd: reserved bit set in the frame header")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept, so it limits nothing
    dict_size = (0, 1, 2, 4)[dict_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    _need(data, pos + dict_size + fcs_size)
    dict_id = int.from_bytes(data[pos : pos + dict_size], "little")
    pos += dict_size
    if dict_id != 0:
        raise NotImplementedError(f"zstd: dictionary {dict_id} (only frames without one are read)")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos : pos + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    frame = bytearray()
    state = _FrameState()
    while True:
        _need(data, pos + 3)
        head = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if size > _MAX_BLOCK:
            raise ValueError("zstd: block larger than 128 KiB")
        if kind == 0:
            _need(data, pos + size)
            frame += data[pos : pos + size]
            pos += size
        elif kind == 1:
            _need(data, pos + 1)
            frame += data[pos : pos + 1] * size
            pos += 1
        elif kind == 2:
            _need(data, pos + size)
            block = data[pos : pos + size]
            pos += size
            before = len(frame)
            literals, used = _literals(block, state)
            _execute_sequences(block, used, literals, state, frame)
            if len(frame) - before > _MAX_BLOCK:
                raise ValueError("zstd: block decodes to more than 128 KiB")
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    if content_size is not None and len(frame) != content_size:
        raise ValueError(f"zstd: frame decodes to {len(frame)} bytes, its header says {content_size}")
    if checksum:
        _need(data, pos + 4)
        want = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if xxh64(bytes(frame)) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
    out += frame
    return pos


def decompress(data: bytes) -> bytes:
    """The content of one or more concatenated zstd frames (skippable frames
    are skipped)."""
    data = bytes(data)
    if not data:
        raise ValueError("zstd: empty input")
    out = bytearray()
    pos = 0
    while pos < len(data):
        _need(data, pos + 4)
        magic = int.from_bytes(data[pos : pos + 4], "little")
        if magic == _FRAME_MAGIC:
            pos = _frame(data, pos + 4, out)
        elif magic & 0xFFFFFFF0 == _SKIPPABLE_MAGIC:
            _need(data, pos + 8)
            pos += 8 + int.from_bytes(data[pos + 4 : pos + 8], "little")
            _need(data, pos)
        else:
            raise ValueError(f"zstd: bad magic {magic:#010x}")
    return bytes(out)
