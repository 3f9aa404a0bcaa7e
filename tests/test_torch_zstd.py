"""`ecnf_tpu_torch.utils.zstd`, the port's Zstandard decoder, against the
frames that tensorstore writes for zarr-v2 arrays (the writer of the JAX package's
Orbax checkpoints) and, where tensorstore cannot make the frame (empty
content, a content checksum), against the ``zstandard`` package.

Every decoded frame must equal the array's bytes bit for bit; a truncated
frame, a bad magic and a wrong checksum raise ``ValueError``, a dictionary
``NotImplementedError``.
"""
import collections

import numpy as np
import pytest
import tensorstore as ts

from ecnf_tpu_torch.utils import zstd

LEVELS = (1, 3, 9, 19)
SIZES = (0, 1, 100, 128 * 1024 + 1, 1024 * 1024)
KINDS = ("zeros", "ramp", "random_f32", "low_entropy", "pattern")


def _content(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "zeros":
        return bytes(n)
    if kind == "ramp":
        return np.arange(n // 4 + 1, dtype="<f4").tobytes()[:n]
    if kind == "random_f32":
        return rng.normal(size=n // 4 + 1).astype("<f4").tobytes()[:n]
    if kind == "low_entropy":
        return rng.integers(0, 4, n).astype(np.uint8).tobytes()
    return (b"ecnf-tpu-port" * (n // 13 + 1))[:n]


def tensorstore_frame(data: bytes, level: int) -> bytes:
    """The one chunk of a zarr-v2 ``|u1`` array holding ``data``, as
    tensorstore writes it with the zstd compressor at ``level``."""
    spec = {
        "driver": "zarr", "kvstore": {"driver": "memory"}, "create": True,
        "metadata": {"dtype": "|u1", "shape": [len(data)], "chunks": [len(data)],
                     "compressor": {"id": "zstd", "level": level}},
    }
    array = ts.open(spec).result()
    array.write(np.frombuffer(data, np.uint8)).result()
    return array.kvstore.read("0").result().value


def _zstandard_frame(data: bytes, level: int, checksum: bool = False) -> bytes:
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_tensorstore_frames_decode_bit_for_bit(level, kind, size):
    data = _content(kind, size)
    # A zarr array has no empty chunk: the empty frame comes from zstandard.
    frame = tensorstore_frame(data, level) if size else _zstandard_frame(data, level)
    assert frame[:4] == bytes.fromhex("28b52ffd")
    assert zstd.decompress(frame) == data


def test_frames_exercise_every_block_literal_and_table_kind(monkeypatch):
    """The frames of the set above reach every branch of the format that
    the decoder names: raw, RLE and compressed blocks; raw, RLE, Huffman
    (1 and 4 streams, FSE and direct weights) and treeless literals; the
    predefined, RLE, FSE and repeat tables of all three sequence codes."""
    seen = collections.Counter()
    literals, table, huffman = zstd._literals, zstd._sequence_table, zstd._huffman_table

    def spy_literals(buf, state):
        kind, size_format = buf[0] & 3, (buf[0] >> 2) & 3
        streams = 0 if kind < 2 else (1 if size_format == 0 else 4)
        seen[("literals", kind, streams)] += 1
        return literals(buf, state)

    def spy_table(buf, pos, mode, which, state):
        seen[("table", which, mode)] += 1
        return table(buf, pos, mode, which, state)

    def spy_huffman(buf):
        seen[("weights", "fse" if buf[0] < 128 else "direct")] += 1
        return huffman(buf)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_sequence_table", spy_table)
    monkeypatch.setattr(zstd, "_huffman_table", spy_huffman)
    blocks = collections.Counter()
    cases = [(kind, size) for kind in KINDS for size in (100, 128 * 1024 + 1)]
    # RLE blocks need a long run; RLE literals show in the 1 MiB ramp at
    # level 19, treeless literals in 1 MiB of low-entropy bytes.
    cases += [("zeros", 1024 * 1024), ("ramp", 1024 * 1024), ("low_entropy", 1024 * 1024)]
    for level in (1, 19):
        for kind, size in cases:
            data = _content(kind, size)
            frame = tensorstore_frame(data, level)
            for block_type in _block_types(frame):
                blocks[block_type] += 1
            assert zstd.decompress(frame) == data
    assert set(blocks) == {0, 1, 2}
    for key in ((0, 0), (1, 0), (2, 1), (2, 4), (3, 4)):  # (kind, streams)
        assert ("literals", *key) in seen, key
    assert ("weights", "fse") in seen and ("weights", "direct") in seen
    for which in range(3):
        for mode in range(4):
            assert ("table", which, mode) in seen, (which, mode)


def _block_types(frame: bytes):
    fhd = frame[4]
    single = (fhd >> 5) & 1
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + (single, 2, 4, 8)[fhd >> 6]
    while True:
        head = int.from_bytes(frame[pos : pos + 3], "little")
        kind = (head >> 1) & 3
        yield kind
        pos += 3 + (1 if kind == 1 else head >> 3)
        if head & 1:
            return


@pytest.mark.parametrize("size", (0, 31, 32, 100, 128 * 1024 + 1))
def test_content_checksum_is_checked(size):
    data = _content("random_f32", size)
    frame = _zstandard_frame(data, 3, checksum=True)
    assert frame[4] & 4  # the frame carries a checksum
    assert zstd.decompress(frame) == data
    flipped = bytearray(frame)
    flipped[-2] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(flipped))


def test_concatenated_and_skippable_frames():
    a, b = _content("pattern", 1000), _content("random_f32", 5000)
    skippable = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"xyz"
    stream = tensorstore_frame(a, 3) + skippable + tensorstore_frame(b, 19)
    assert zstd.decompress(stream) == a + b


@pytest.mark.parametrize("cut", (1, 3, 7, 20, -1))
def test_truncated_frame_raises(cut):
    frame = tensorstore_frame(_content("random_f32", 4096), 3)
    with pytest.raises(ValueError):
        zstd.decompress(frame[:cut] if cut > 0 else frame[:cut])


def test_bad_magic_and_empty_input_raise():
    frame = tensorstore_frame(_content("ramp", 400), 1)
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\x29" + frame[1:])
    with pytest.raises(ValueError, match="empty"):
        zstd.decompress(b"")


def test_dictionary_frames_are_refused():
    # Frame header: dictionary-ID flag 1 (one byte, id 7), single segment,
    # content size 3, then one raw last block "abc".
    frame = bytes.fromhex("28b52ffd") + bytes([0x21, 7, 3]) + (1 | 3 << 3).to_bytes(3, "little") + b"abc"
    with pytest.raises(NotImplementedError, match="dictionary 7"):
        zstd.decompress(frame)
    plain = bytes.fromhex("28b52ffd") + bytes([0x20, 3]) + (1 | 3 << 3).to_bytes(3, "little") + b"abc"
    assert zstd.decompress(plain) == b"abc"


def test_xxh64_known_values():
    # XXH64 reference values (seed 0).
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
