"""TFRecord / tf.train.Example interop: the reference's on-disk format.

Own copy of the JAX package's ``data/tfrecord_compat.py``, with numpy, the
standard library and the port's host library (no TensorFlow or pandas). The
reference serializes datasets as TFRecord shards of ``tf.train.Example``
protos (ref: pkg/tfrecord_writer/tfrecord_writer.py:44-126) and reads them
back with ``tf.data.TFRecordDataset`` (ref:
pkg/modelling/tfrecord_dataset.py:24-37). This module is the migration
bridge between those files and the port's encoded npz shards:

* ``iter_tfrecords`` / ``parse_example``: read the reference's files;
* ``write_tfrecords`` / ``build_example``: write files byte-identical to
  the JAX package's (and readable by ``tf.io``);
* ``tfrecords_to_dataframe`` / ``dataframe_to_tfrecords``: a table (the
  port's dict of numpy columns and ``ListColumn``, ``etl/transformations.py``)
  to and from ``{prefix}_{n}.tfrecord`` shards;
* ``import_tfrecords`` / ``export_shards_to_tfrecords``: TFRecord shards to
  and from the port's npz shards, through ``ShardWriter`` and
  ``ShardDataset``.

The bytes equal the JAX writer's for every feature kind. A missing
categorical (``""`` in a str column, NaN in a float one) is written as the
JAX package writes the NaN that pandas 3's ``astype(str)`` keeps:
``FloatList [nan]``, which reads back as the string ``"nan"``. Files are
read in the JAX package's order, ``sorted(glob(...))``, so ``train_10``
comes before ``train_2``.

The record framing, its scan and the CRC32C run in C++
(``native_ext.tfrecord_frame``, ``tfrecord_scan``, ``tfrecord_masked_crc``;
``csrc/shardio.cpp``), as the JAX package's native path runs them: a
corrupt or truncated file raises ``ValueError("corrupt TFRecord data at
byte N")`` before any record is yielded. Their plain versions stay here in
numpy: ``_masked_crcs`` runs the CRC over many records at once, four bytes
a step through two 64Ki-entry tables (records cut into segments of at most
1 KiB, the segments whose words share an alignment copied as rows of words,
longest first, so the segments still running at a step are a prefix of a
column, and each record's segments chained through one table of the
register's step over 1 KiB of zeros); ``_frame`` writes the framing by one
scatter and ``_scan`` reads it by one loop over records, and finds faults
in the order and with the messages of the JAX package's Python reader.

Wire format (tensorflow/core/example/{example,feature}.proto):
    Example.features = field 1; Features.feature map entries = field 1
    (key = entry field 1, value = entry field 2);
    Feature.bytes_list/float_list/int64_list = fields 1/2/3;
    BytesList.value = repeated field 1 (len-delimited);
    FloatList.value = repeated field 1 (packed fixed32 by default);
    Int64List.value = repeated field 1 (packed varint by default).
Record framing: uint64 length | masked crc32c(length) | data |
masked crc32c(data), with masked(c) = rotr15(c) + 0xa282ead8.
"""

from __future__ import annotations

import glob
import logging
import os
import struct
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from hm_retrieval_tpu_torch import native_ext
from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.data.shard_writer import ShardWriter
from hm_retrieval_tpu_torch.etl.transformations import (
    ListColumn,
    Table,
    factorize,
    isna,
    table_len,
)
from hm_retrieval_tpu_torch.schema.features import Feature, FeatureKind

logger = logging.getLogger(__name__)

FeatureValue = Union[List[bytes], List[float], List[int]]

# ---------------------------------------------------------------------------
# CRC32C over many records at once (the plain version)
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78  # CRC32C (Castagnoli), reflected
_MASK_DELTA = 0xA282EAD8
_SEGMENT = 1024  # bytes a record is cut into, for long records
_FOLD_WORDS = 1 << 19  # words of the runs folded together
_tables: Dict[str, np.ndarray] = {}


def _crc_tables() -> Dict[str, np.ndarray]:
    """The byte table; the 4-byte step split by the register's low and high
    16 bits; and a zero segment's step (the register after _SEGMENT zero
    bytes) split by the register's four bytes."""
    if not _tables:
        t = [np.arange(256, dtype=np.uint32)]
        for _ in range(8):
            t[0] = np.where(t[0] & 1, (t[0] >> 1) ^ np.uint32(_POLY),
                            t[0] >> 1)
        for _ in range(3):  # t[k][i]: byte i followed by k zero bytes
            t.append((t[-1] >> 8) ^ t[0][t[-1] & 0xFF])
        x = np.arange(1 << 16, dtype=np.uint32)
        lo, hi = t[3][x & 0xFF] ^ t[2][x >> 8], t[1][x & 0xFF] ^ t[0][x >> 8]
        # each of a register's bytes alone, through _SEGMENT zero bytes
        c = (np.arange(256, dtype=np.uint32)[None, :]
             << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
        for _ in range(_SEGMENT // 4):
            c = lo[c & 0xFFFF] ^ hi[c >> 16]
        _tables.update(byte=t[0], lo=lo, hi=hi, skip=c.reshape(4, 256))
    return _tables


def _fold(buf: np.ndarray, starts, lengths, init) -> np.ndarray:
    """The CRC32C register after each run ``buf[starts[i]:starts[i] +
    lengths[i]]``, from register ``init[i]``: each run's first ``length %
    4`` bytes a byte a step, then its whole words four bytes a step, every
    run at once."""
    tables = _crc_tables()
    byte, lo, hi = tables["byte"], tables["lo"], tables["hi"]
    crc = init.copy()
    lead = lengths % 4
    for k in range(3):
        rows = np.flatnonzero(lead > k)
        c = crc[rows]
        crc[rows] = byte[(c ^ buf[starts[rows] + k]) & 0xFF] ^ (c >> 8)
    first, words = starts + lead, lengths // 4
    if not words.any():
        return crc
    # zero words after the end, so every run's window of words fits
    padded = np.zeros(len(buf) + 4 * int(words.max()) + 4, np.uint8)
    padded[:len(buf)] = buf
    for a in range(4):
        # the runs whose words start at byte a modulo 4, longest first, as
        # rows of little-endian words of padded[a:]
        w32 = padded[a:a + (len(padded) - a) // 4 * 4].view("<u4")
        aligned = np.flatnonzero(first % 4 == a)
        aligned = aligned[np.argsort(-words[aligned], kind="stable")]
        i = 0
        while i < len(aligned) and words[aligned[i]]:
            n_words = int(words[aligned[i]])
            rows = aligned[i:i + max(1, _FOLD_WORDS // n_words)]
            i += len(rows)
            # column j holds each run's word j; the runs still going at
            # word j are a prefix
            cols = np.ascontiguousarray(sliding_window_view(w32, n_words)[
                (first[rows] - a) // 4].T)
            active = np.searchsorted(-words[rows], -np.arange(n_words))
            c = crc[rows]
            t = np.empty_like(c)
            for j, m in enumerate(active.tolist()):
                head = c[:m]
                head ^= cols[j, :m]
                np.take(hi, head >> 16, out=t[:m])
                np.take(lo, head & 0xFFFF, out=head)
                head ^= t[:m]
            crc[rows] = c
    return crc


def _masked_crcs(buf: np.ndarray, starts, lengths) -> np.ndarray:
    """Masked CRC32C of ``buf[starts[i]:starts[i] + lengths[i]]`` for every
    i, as uint32. A record is cut into a short first segment and segments
    of _SEGMENT bytes, folded all at once (the first from the initial
    register, the others from 0); a record's segments are then chained: the
    register so far through _SEGMENT zero bytes, plus the next segment's."""
    skip = _crc_tables()["skip"]
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    if not len(lengths):
        return np.zeros(0, np.uint32)
    n_seg = np.maximum(1, -(-lengths // _SEGMENT))
    head = lengths - _SEGMENT * (n_seg - 1)  # the first segment's bytes
    seg0 = np.cumsum(n_seg) - n_seg  # each record's first segment
    rec = np.repeat(np.arange(len(lengths)), n_seg)
    k = np.arange(int(n_seg.sum())) - seg0[rec]  # the segment's place
    regs = _fold(buf, starts[rec] + np.where(k > 0, head[rec]
                                             + (k - 1) * _SEGMENT, 0),
                 np.where(k > 0, _SEGMENT, head[rec]),
                 np.where(k > 0, 0, 0xFFFFFFFF).astype(np.uint32))
    order = np.argsort(-n_seg, kind="stable")  # the longest records first
    crc = regs[seg0[order]]
    for s, m in enumerate(np.searchsorted(-n_seg[order],
                                          -np.arange(1, n_seg.max())), 1):
        c = crc[:m]
        crc[:m] = (skip[0][c & 0xFF] ^ skip[1][(c >> 8) & 0xFF]
                   ^ skip[2][(c >> 16) & 0xFF] ^ skip[3][c >> 24]
                   ^ regs[seg0[order[:m]] + s])
    out = np.empty_like(crc)
    out[order] = crc ^ np.uint32(0xFFFFFFFF)
    return ((out >> 15) | (out << 17)) + np.uint32(_MASK_DELTA)


def masked_crc32c(data: bytes) -> int:
    """Masked CRC32C as used by the TFRecord container (C++)."""
    return native_ext.tfrecord_masked_crc(data)


# ---------------------------------------------------------------------------
# Record framing (read/write)
# ---------------------------------------------------------------------------


def _u32_at(buf: np.ndarray, pos) -> np.ndarray:
    idx = np.asarray(pos, np.int64)[:, None] + np.arange(4)
    return np.ascontiguousarray(buf[idx]).view("<u4").reshape(-1)


def _scan(path: str, data: bytes, verify_crc: bool):
    """``tfrecord_scan``'s plain version. (record starts, record lengths,
    error): the records before the first fault, and the fault's
    ``ValueError`` (None if the file is whole),
    found in the JAX reader's order within a record: truncated header,
    length CRC, truncated body, data CRC."""
    n = len(data)
    heads: List[int] = []
    append = heads.append
    unpack = struct.Struct("<Q").unpack_from
    pos = 0
    while pos + 12 <= n:
        append(pos)
        pos += 16 + unpack(data, pos)[0]
    cut = None  # (record, stage, pos)
    if pos > n:  # the last record's body runs past the end
        cut = (len(heads) - 1, 2, heads[-1])
    elif pos < n:
        cut = (len(heads), 0, pos)
    head = np.asarray(heads, np.int64)
    buf = np.frombuffer(data, np.uint8)
    whole = head[:len(head) - (pos > n)]
    length = (np.ascontiguousarray(buf[whole[:, None] + np.arange(8)])
              .view("<u8").reshape(-1).astype(np.int64))
    faults = [cut] if cut else []
    if verify_crc and len(heads):
        bad = np.flatnonzero(_masked_crcs(buf, head, np.full(len(head), 8))
                             != _u32_at(buf, head + 8))
        if len(bad):
            faults.append((int(bad[0]), 1, heads[bad[0]]))
        body = head[:len(length)] + 12
        bad = np.flatnonzero(_masked_crcs(buf, body, length)
                             != _u32_at(buf, body + length))
        if len(bad):
            faults.append((int(bad[0]), 3, heads[bad[0]]))
    if not faults:
        return head + 12, length, None
    rec, stage, at = min(faults)
    what = ("truncated record header", "bad length CRC",
            "truncated record body", "bad data CRC")[stage]
    return head[:rec] + 12, length[:rec], ValueError(f"{path}: {what} @ {at}")


def iter_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file. The whole file is
    scanned first: a truncated or (with ``verify_crc``) corrupt record
    raises ``ValueError("corrupt TFRecord data at byte N")`` before any
    record is yielded, as the JAX package's native reader does."""
    with open(path, "rb") as f:
        data = f.read()
    starts, lengths = native_ext.tfrecord_scan(data, verify=verify_crc)
    for s, ln in zip(starts.tolist(), lengths.tolist()):
        yield data[s:s + ln]


def _frame(payloads: Sequence[bytes]) -> bytes:
    """``tfrecord_frame``'s plain version: the TFRecord bytes of
    ``payloads``, each record's 12-byte header and 4-byte trailer scattered
    around the payloads in one pass."""
    lengths = np.fromiter(map(len, payloads), np.int64, count=len(payloads))
    if not len(lengths):
        return b""
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    before = np.cumsum(lengths) - lengths
    head = np.arange(len(lengths), dtype=np.int64) * 16 + before
    frame = np.empty((len(lengths), 16), np.uint8)
    frame[:, :8] = lengths.astype("<u8").view(np.uint8).reshape(-1, 8)
    hcrc = _masked_crcs(frame[:, :8].reshape(-1),
                        np.arange(len(lengths)) * 8, np.full(len(lengths), 8))
    frame[:, 8:12] = hcrc.astype("<u4").view(np.uint8).reshape(-1, 4)
    frame[:, 12:] = _masked_crcs(blob, before, lengths).astype(
        "<u4").view(np.uint8).reshape(-1, 4)
    out = np.empty(len(blob) + frame.size, np.uint8)
    is_frame = np.zeros(len(out), bool)
    is_frame[(head[:, None] + np.arange(12)).reshape(-1)] = True
    is_frame[(head[:, None] + 12 + lengths[:, None]
              + np.arange(4)).reshape(-1)] = True
    out[is_frame] = frame.reshape(-1)
    out[~is_frame] = blob
    return out.tobytes()


def _frame_native(payloads: Sequence[bytes]) -> bytes:
    """The TFRecord bytes of ``payloads``, framed in C++."""
    offsets = np.zeros(len(payloads) + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, payloads), np.uint64,
                          count=len(payloads)), out=offsets[1:])
    return native_ext.tfrecord_frame(b"".join(payloads), offsets)


def write_tfrecords(path: str, payloads: Sequence[bytes]) -> None:
    """Write raw payloads as one TFRecord file (tf.io-compatible), framed
    in C++."""
    framed = _frame_native(payloads)
    with open(path, "wb") as f:
        f.write(framed)


# ---------------------------------------------------------------------------
# tf.train.Example wire-format decode / encode (no TF dependency)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    b = buf[pos]
    if b < 0x80:
        return b, pos + 1
    result = b & 0x7F
    shift = 7
    pos += 1
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == 1:  # fixed64
        return pos + 8
    if wire == 2:  # len-delimited
        ln, pos = _read_varint(buf, pos)
        return pos + ln
    if wire == 5:  # fixed32
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


def _length(buf: bytes, pos: int):
    """(length, position after it) of the varint length at ``pos``, the
    one-byte case inline."""
    ln = buf[pos]
    if ln < 0x80:
        return ln, pos + 1
    return _read_varint(buf, pos)


def _parse_bytes_list(buf: bytes) -> List[bytes]:
    out: List[bytes] = []
    pos, n = 0, len(buf)
    while pos < n:
        if buf[pos] == 0x0A:  # field 1, len-delimited
            ln, pos = _length(buf, pos + 1)
            out.append(buf[pos:pos + ln])
            pos += ln
        else:
            tag, pos = _read_varint(buf, pos)
            pos = _skip_field(buf, pos, tag & 7)
    return out


def _parse_float_list(buf: bytes) -> List[float]:
    out: List[float] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag == 0x0A:  # packed
            ln, pos = _read_varint(buf, pos)
            out.extend(np.frombuffer(buf, np.dtype("<f4"), ln // 4,
                                     pos).tolist())
            pos += ln
        elif tag == 0x0D:  # unpacked fixed32
            out.append(struct.unpack_from("<f", buf, pos)[0])
            pos += 4
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_int64_list(buf: bytes) -> List[int]:
    out: List[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag == 0x0A:  # packed
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                out.append(_signed(v))
        elif tag == 0x08:  # unpacked varint
            v, pos = _read_varint(buf, pos)
            out.append(_signed(v))
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return out


_LIST_PARSERS = {1: _parse_bytes_list, 2: _parse_float_list,
                 3: _parse_int64_list}


def _parse_feature(buf: bytes) -> FeatureValue:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2 and field in _LIST_PARSERS:
            ln, pos = _length(buf, pos)
            return _LIST_PARSERS[field](buf[pos:pos + ln])
        pos = _skip_field(buf, pos, wire)
    return []  # empty Feature (no kind set)


def _parse_entry(ebuf: bytes):
    key, value = "", []
    pos, n = 0, len(ebuf)
    while pos < n:
        tag = ebuf[pos]
        if tag == 0x0A:  # key
            ln, pos = _length(ebuf, pos + 1)
            key = ebuf[pos:pos + ln].decode("utf-8")
            pos += ln
        elif tag == 0x12:  # value
            ln, pos = _length(ebuf, pos + 1)
            value = _parse_feature(ebuf[pos:pos + ln])
            pos += ln
        else:
            tag, pos = _read_varint(ebuf, pos)
            pos = _skip_field(ebuf, pos, tag & 7)
    return key, value


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """Decode one tf.train.Example proto to {name: list-of-values}: packed
    and unpacked lists, unknown fields skipped, the last of a repeated key
    kept."""
    out: Dict[str, FeatureValue] = {}
    pos = 0
    while pos < len(payload):
        if payload[pos] != 0x0A:  # not Example.features
            tag, pos = _read_varint(payload, pos)
            pos = _skip_field(payload, pos, tag & 7)
            continue
        ln, pos = _length(payload, pos + 1)
        fbuf = payload[pos:pos + ln]
        pos += ln
        fpos, fn = 0, len(fbuf)
        while fpos < fn:
            if fbuf[fpos] != 0x0A:  # not a map entry
                ftag, fpos = _read_varint(fbuf, fpos)
                fpos = _skip_field(fbuf, fpos, ftag & 7)
                continue
            eln, fpos = _length(fbuf, fpos + 1)
            key, value = _parse_entry(fbuf[fpos:fpos + eln])
            fpos += eln
            out[key] = value
    return out


_ONE_BYTE = [bytes((i,)) for i in range(0x80)]


def _varint(v: int) -> bytes:
    if v < 0x80:
        return _ONE_BYTE[v]
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(values: FeatureValue) -> bytes:
    """Encode one Feature message. The first value's type decides the list
    kind, as tf.train does: bytes/str -> BytesList, float -> FloatList,
    int -> Int64List (packed varints, a negative value in 10 bytes)."""
    if not len(values):
        return b""
    v0 = values[0]
    if isinstance(v0, (bytes, str)):
        inner = b"".join(
            _len_delimited(1, v if isinstance(v, bytes) else v.encode("utf-8"))
            for v in values
        )
        return _len_delimited(1, inner)
    if isinstance(v0, (float, np.floating)):
        packed = np.asarray(values, "<f4").tobytes()
        return _len_delimited(2, _len_delimited(1, packed))
    if isinstance(v0, (int, np.integer)):
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
        return _len_delimited(3, _len_delimited(1, packed))
    raise TypeError(f"unsupported feature value type {type(v0)}")


def _entry(key: bytes, feature: bytes) -> bytes:
    """One Features map entry: key, then the encoded Feature."""
    return _len_delimited(1, _len_delimited(1, key)
                          + _len_delimited(2, feature))


def build_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode {name: values} as a tf.train.Example payload."""
    entries = b"".join(_entry(name.encode("utf-8"), _encode_feature(vals))
                       for name, vals in features.items())
    return _len_delimited(1, entries)


# ---------------------------------------------------------------------------
# Table <-> TFRecord (the reference's writer/reader contract)
# ---------------------------------------------------------------------------


def _tfrecord_paths(path_or_dir: str) -> List[str]:
    """The JAX package's file order: ``sorted(glob(...))``, so
    ``train_10`` comes before ``train_2``."""
    if os.path.isdir(path_or_dir):
        paths = sorted(glob.glob(os.path.join(path_or_dir, "*.tfrecord")))
    else:
        paths = sorted(glob.glob(path_or_dir)) or [path_or_dir]
    if not any(os.path.exists(p) for p in paths):
        raise FileNotFoundError(f"no TFRecord files at {path_or_dir}")
    return paths


def _text(v) -> str:
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


def _list_column(rows: List[List[str]]) -> ListColumn:
    lens = np.fromiter(map(len, rows), np.int64, count=len(rows))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.asarray([t for row in rows for t in row], dtype=str)
    if not len(flat):
        return ListColumn(offsets, np.zeros(0, np.int32), np.zeros(0, str))
    codes, tokens = factorize(flat)
    return ListColumn(offsets, codes.astype(np.int32), tokens)


def tfrecords_to_dataframe(
    path_or_dir: str,
    features: Sequence[Feature],
    verify_crc: bool = True,
) -> Table:
    """Read reference-written TFRecord shards into a table: float64 numeric
    columns (NaN where a record lacks the feature), str categorical columns
    (the first value; a float value as ``str``, so a NaN reads ``"nan"``;
    ``""`` where absent) and ``ListColumn`` sequence columns (the inverse of
    the reference's per-row serializer, ref: tfrecord_writer.py:44-53)."""
    cols: Dict[str, list] = {f.name: [] for f in features}
    for path in _tfrecord_paths(path_or_dir):
        for payload in iter_tfrecords(path, verify_crc=verify_crc):
            row = parse_example(payload)
            for f in features:
                vals = row.get(f.name, [])
                if f.kind == FeatureKind.NUMERIC:
                    cols[f.name].append(float(vals[0]) if vals else np.nan)
                elif f.kind == FeatureKind.SEQUENCE:
                    cols[f.name].append(list(map(_text, vals)))
                else:
                    cols[f.name].append(_text(vals[0] if vals else b""))
    table: Table = {}
    for f in features:
        if f.kind == FeatureKind.NUMERIC:
            table[f.name] = np.asarray(cols[f.name], np.float64)
        elif f.kind == FeatureKind.SEQUENCE:
            table[f.name] = _list_column(cols[f.name])
        else:
            table[f.name] = np.asarray(cols[f.name], dtype=str)
    return table


def _categorical_features(col: np.ndarray) -> Tuple[list, np.ndarray]:
    """(encoded Feature of each distinct value, the row's value index) of a
    categorical column as the JAX writer encodes ``astype(str)``: a string
    as a one-value BytesList, a missing value as ``FloatList [nan]``."""
    col = np.asarray(col)
    missing = isna(col)
    text = col if col.dtype.kind == "U" else col.astype(str)
    codes, uniq = factorize(np.where(missing, "", text))
    encoded = [_encode_feature([t]) for t in uniq.tolist()]
    if missing.any():
        encoded.append(_encode_feature([np.nan]))
        codes = np.where(missing, len(encoded) - 1, codes)
    return encoded, codes


def _numeric_features(col: np.ndarray) -> Tuple[list, np.ndarray]:
    """The same for a numeric column: a one-value FloatList of its float32
    cast."""
    bits = np.asarray(col, np.float32).view(np.uint32)
    uniq, codes = np.unique(bits, return_inverse=True)
    encoded = [_encode_feature(v) for v in uniq.view(np.float32)[:, None]]
    return encoded, codes.reshape(-1)


def _sequence_features(col: ListColumn) -> List[bytes]:
    """Each row's encoded Feature: its tokens as a BytesList (an empty row
    an empty Feature)."""
    pieces = [_len_delimited(1, t.encode("utf-8")) for t in col.tokens.tolist()]
    codes = col.codes.tolist()
    offsets = col.offsets.tolist()
    out = []
    for a, b in zip(offsets[:-1], offsets[1:]):
        out.append(_len_delimited(1, b"".join([pieces[c] for c in codes[a:b]]))
                   if b > a else b"")
    return out


def _entries(table: Table, f: Feature) -> List[bytes]:
    """Every row's Features map entry for ``f``."""
    key = f.name.encode("utf-8")
    col = table[f.name]
    if f.kind == FeatureKind.SEQUENCE:
        if not isinstance(col, ListColumn):
            raise TypeError(f"sequence column {f.name!r} must be a ListColumn")
        return [_entry(key, feat) for feat in _sequence_features(col)]
    encoded, codes = (_numeric_features(col) if f.kind == FeatureKind.NUMERIC
                      else _categorical_features(col))
    entries = [_entry(key, feat) for feat in encoded]
    return [entries[c] for c in codes.tolist()]


def dataframe_to_tfrecords(
    df: Table,
    features: Sequence[Feature],
    path_prefix: str,
    max_rows: int = 100_000,
) -> List[str]:
    """Write a table as ``{prefix}_{n}.tfrecord`` shards with the
    reference's per-feature encoding: CATEGORICAL -> single-value
    BytesList, NUMERIC -> single-value FloatList (ref:
    tfrecord_writer.py:44-53, 105-126); SEQUENCE (no reference analog) ->
    multi-value BytesList. The bytes are the JAX writer's on the same rows
    (module docstring)."""
    if max_rows <= 0:
        raise ValueError("max_rows must be positive")
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    n = table_len(df)
    columns = [_entries(df, f) for f in features]
    examples = ([_len_delimited(1, b"".join(parts)) for parts in zip(*columns)]
                if columns else [_len_delimited(1, b"")] * n)
    paths: List[str] = []
    num_shards = max(1, -(-n // max_rows))
    for s in range(num_shards):
        path = f"{path_prefix}_{s}.tfrecord"
        write_tfrecords(path, examples[s * max_rows:(s + 1) * max_rows])
        paths.append(path)
    logger.info("Wrote %d rows as %d TFRecord shard(s) at %s_*.tfrecord",
                n, num_shards, path_prefix)
    return paths


# ---------------------------------------------------------------------------
# Migration: TFRecord <-> the port's encoded npz shards
# ---------------------------------------------------------------------------


def import_tfrecords(
    path_or_dir: str,
    features: Sequence[Feature],
    out_dir: str,
    max_rows: int = 100_000,
    verify_crc: bool = True,
) -> int:
    """Migrate reference TFRecord shards into the port's encoded columnar
    npz shards (vocab lookup applied once, here). Returns the shard count
    written."""
    table = tfrecords_to_dataframe(path_or_dir, features,
                                   verify_crc=verify_crc)
    writer = ShardWriter(list(features), max_rows=max_rows)
    return writer.write_shards(table, out_dir)


def _decoded_sequence(f: Feature, ids: np.ndarray) -> ListColumn:
    """(B, L) ids -> each row's non-pad tokens (id 0 dropped, ids outside
    the vocab as ``"<OOV>"``), as ``Feature.decode`` gives them."""
    tokens = f.decode(np.arange(len(f.vocab) + 1))
    keep = ids != 0
    offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=offsets[1:])
    flat = ids[keep]
    codes = np.where((flat >= 0) & (flat < len(tokens)), flat, 0)
    return ListColumn(offsets, codes.astype(np.int32), tokens)


def export_shards_to_tfrecords(
    shard_dir: str,
    features: Sequence[Feature],
    path_prefix: str,
    max_rows: int = 100_000,
) -> List[str]:
    """Decode the port's npz shards back to string tokens and write
    reference-compatible TFRecord shards (ids -> tokens via each feature's
    vocab; id 0 decodes to '<OOV>')."""
    data = ShardDataset(shard_dir).load_all()
    table: Table = {}
    for f in features:
        arr = data[f.name]
        if f.kind == FeatureKind.NUMERIC:
            table[f.name] = arr.astype(np.float32)
        elif f.kind == FeatureKind.SEQUENCE:
            table[f.name] = _decoded_sequence(f, arr)
        else:
            table[f.name] = f.decode(arr)
    return dataframe_to_tfrecords(table, features, path_prefix,
                                  max_rows=max_rows)
