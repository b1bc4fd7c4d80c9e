"""The port's TFRecord bridge against the JAX package's.

The same rows go through ``hm_retrieval_tpu.data.tfrecord_compat`` (pandas
frames) and ``hm_retrieval_tpu_torch.data.tfrecord_compat`` (the port's
tables, read from the same CSV): the files must be byte-identical, including
a missing categorical written as ``FloatList [nan]`` (trap q); both read the
other's files and TensorFlow's own; ``parse_example`` decodes packed,
unpacked, unknown-field and negative-int64 payloads as JAX's does (trap s);
the C++ CRC and the plain vectorized one equal the per-byte form and JAX's;
the port's reader (C++) raises on corruption as JAX's native reader does,
before any record, and its plain version (``_scan``) carries the JAX Python
reader's messages after the records before the fault; twelve files are read
in JAX's lexicographic order (trap r); import and export equal JAX's array
for array; and the module runs with pandas, pyarrow and TensorFlow blocked.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from hm_retrieval_tpu.data import tfrecord_compat as jtfc
from hm_retrieval_tpu.schema.features import Feature as JaxFeature
from hm_retrieval_tpu_torch.data import tfrecord_compat as tfc
from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.data.shard_writer import ShardWriter
from hm_retrieval_tpu_torch.etl.transformations import (
    ListColumn,
    load_dataframe,
)
from hm_retrieval_tpu_torch.schema.features import Feature

ROOT = Path(__file__).resolve().parent.parent

CSV = (
    "customer_id,colour,size,age,price\n"
    "c2,red,1,21.0,0.5\n"
    "c1,,2,35.5,\n"
    "zzz,blue,,44.0,1.25\n"
    "c3,red,3,,2.0\n"
    "c2,green,1,60.0,0.0003333333333333333\n"
)
HISTORY = [["a1", "a2"], [], ["a2", "a2", "a1", "zz"], ["a1"], []]


FEATURE_SPECS = [
    dict(name="customer_id", kind="categorical", family="query",
         embedding_size=4, vocab=["c1", "c2", "c3"]),
    dict(name="colour", kind="categorical", family="candidate",
         embedding_size=4, vocab=["red", "blue", "nan"]),
    dict(name="size", kind="categorical", family="candidate",
         embedding_size=4, vocab=["1", "2.0", "3.0"]),
    dict(name="age", kind="numeric", family="query", standardize=True,
         mean=40.0, std=12.0),
    dict(name="price", kind="numeric", family="candidate"),
    dict(name="history", kind="sequence", family="query", embedding_size=4,
         vocab=["a1", "a2"], max_len=3),
]


def both_features():
    return ([Feature(**s) for s in FEATURE_SPECS],
            [JaxFeature(**s) for s in FEATURE_SPECS])


def history_column(rows):
    flat = [t for r in rows for t in r]
    tokens, codes = np.unique(np.asarray(flat, dtype=str),
                              return_inverse=True)
    offsets = np.cumsum([0] + [len(r) for r in rows])
    return ListColumn(offsets.astype(np.int64), codes.astype(np.int32),
                      tokens)


@pytest.fixture
def rows(tmp_path):
    """The same rows as the port's table and as JAX's frame, both read from
    one CSV: a missing colour ("" / NaN), a size column of integers with a
    missing value (float64, "1.0"), a missing age and price."""
    path = tmp_path / "rows.csv"
    path.write_text(CSV)
    table = load_dataframe(str(path))
    table["history"] = history_column(HISTORY)
    frame = pd.read_csv(str(path))
    frame["history"] = pd.Series(HISTORY, dtype=object)
    return table, frame


def files_bytes(paths):
    return [Path(p).read_bytes() for p in paths]


# --- CRC32C --------------------------------------------------------------------


def crc_per_byte(data: bytes) -> int:
    """The per-byte form (the JAX package's pure-Python fallback)."""
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
        table.append(c)
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_crc_equals_the_per_byte_form_and_jax():
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in list(range(0, 37))
                + [255, 1000, 1023, 1024, 1025, 2048, 4099, 10_000]]
    payloads += [b"123456789", b"\x00" * 64, b"\xff" * 63]
    for p in payloads:
        want = crc_per_byte(p)
        assert tfc.masked_crc32c(p) == want == jtfc.masked_crc32c(p)
        plain = tfc._masked_crcs(np.frombuffer(p, np.uint8), [0], [len(p)])
        assert int(plain[0]) == want
    # every record of a buffer at once, at every alignment and length, those
    # past 1 KiB as chained segments
    blob = b"".join(payloads)
    lengths = np.array([len(p) for p in payloads])
    starts = np.cumsum(lengths) - lengths
    got = tfc._masked_crcs(np.frombuffer(blob, np.uint8), starts, lengths)
    assert got.tolist() == [crc_per_byte(p) for p in payloads]
    c = 0xE3069283  # crc32c(b"123456789")
    assert tfc.masked_crc32c(b"123456789") == (
        ((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- framing -------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [[], [0], [5, 0, 1000, 14, 3],
                                   list(range(0, 300, 7))])
def test_framing_bytes_equal_jax(tmp_path, sizes):
    rng = np.random.default_rng(len(sizes))
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in sizes]
    tfc.write_tfrecords(str(tmp_path / "port.tfrecord"), payloads)
    jtfc.write_tfrecords(str(tmp_path / "jax.tfrecord"), payloads)
    port = (tmp_path / "port.tfrecord").read_bytes()
    assert port == (tmp_path / "jax.tfrecord").read_bytes()
    assert tfc._frame(payloads) == port
    assert list(tfc.iter_tfrecords(str(tmp_path / "jax.tfrecord"))) == payloads
    assert plain_records(str(tmp_path / "jax.tfrecord"), True) == (payloads,
                                                                  None)


def corrupt(raw: bytes, what: str) -> bytes:
    """Three records of 13, 7 and 20 bytes; one fault in the second, at
    byte 29 onward."""
    second = 16 + 13
    raw = bytearray(raw)
    if what == "length_crc":
        raw[second + 9] ^= 0x10
    elif what == "length":  # a length past the end: its CRC fails first
        raw[second + 2] = 0x7F
    elif what == "data_crc":
        raw[second + 14] ^= 0x01
    elif what == "trailer":
        raw[second + 12 + 7 + 2] ^= 0x40
    elif what == "truncated_body":
        raw = raw[:second + 12 + 5]
    elif what == "truncated_header":
        raw = raw[:second + 7]
    elif what == "truncated_trailer":
        raw = raw[:2 * 16 + 13 + 7 + 16 + 20 - 1]
    return bytes(raw)


def plain_records(path, verify):
    """The port's plain reader: the records ``_scan`` finds before the
    first fault, and the fault's message (None if the file is whole)."""
    data = Path(path).read_bytes()
    starts, lengths, error = tfc._scan(path, data, verify)
    got = [data[s:s + ln] for s, ln in zip(starts.tolist(), lengths.tolist())]
    return got, None if error is None else str(error)


def read_all(module, path, verify):
    """The records ``module.iter_tfrecords`` yields before it raises, and
    its ``ValueError``'s message (None if it does not raise)."""
    got = []
    try:
        for rec in module.iter_tfrecords(str(path), verify_crc=verify):
            got.append(rec)
    except ValueError as exc:
        return got, str(exc)
    return got, None


CORRUPTIONS = ["length_crc", "length", "data_crc", "trailer",
               "truncated_body", "truncated_header", "truncated_trailer"]


def corrupt_file(tmp_path, what):
    payloads = [b"a" * 13, bytes(range(7)), b"\xfe" * 20]
    path = tmp_path / "t.tfrecord"
    tfc.write_tfrecords(str(path), payloads)
    path.write_bytes(corrupt(path.read_bytes(), what))
    return path


@pytest.mark.parametrize("what", CORRUPTIONS)
@pytest.mark.parametrize("verify", [True, False])
def test_corruption_errors_match_jax(tmp_path, monkeypatch, what, verify):
    """The port's plain reader (``_scan``) against the JAX package's Python
    reader: the records before the fault, then the same ``ValueError``
    message (bad length CRC, bad data CRC, truncated header or body, each
    at the record's offset); without ``verify_crc`` only the truncations
    raise."""
    no_native(monkeypatch)
    path = corrupt_file(tmp_path, what)
    got, err = plain_records(str(path), verify)
    want, want_err = read_all(jtfc, path, verify)
    assert (got, err) == (want, want_err)
    if verify or what.startswith("truncated") or what == "length":
        assert err is not None and err.startswith(f"{path}: ")
    if not verify and what in ("length_crc", "data_crc", "trailer"):
        assert err is None and len(got) == 3


@pytest.mark.parametrize("what", CORRUPTIONS)
@pytest.mark.parametrize("verify", [True, False])
def test_native_corruption_errors_match_jax_native(tmp_path, what, verify):
    """The port's reader (C++) against the JAX package's native reader: the
    whole file is scanned first, so a fault raises ``corrupt TFRecord data
    at byte N`` (N the faulty record's offset: the second record's, 29, or
    the third's, 52, for a cut trailer) before any record; without
    ``verify_crc`` only the truncations raise."""
    path = corrupt_file(tmp_path, what)
    got, err = read_all(tfc, path, verify)
    assert (got, err) == read_all(jtfc, path, verify)
    at = 52 if what == "truncated_trailer" else 29
    if verify or what.startswith("truncated") or what == "length":
        assert got == [] and err == f"corrupt TFRecord data at byte {at}"
    if not verify and what in ("length_crc", "data_crc", "trailer"):
        assert err is None and len(got) == 3


def no_native(monkeypatch):
    """The JAX package's pure-Python TFRecord path: its native library's
    functions answer None."""
    from hm_retrieval_tpu import native_ext

    for name in ("tfrecord_frame", "tfrecord_masked_crc", "tfrecord_scan"):
        monkeypatch.setattr(native_ext, name, lambda *a, **k: None)


def test_jax_python_fallback_reads_and_writes_as_the_port(tmp_path,
                                                          monkeypatch):
    """The JAX package's pure-Python path (no native library) and the port
    write the same bytes and read each other's files."""
    no_native(monkeypatch)
    payloads = [b"x", b"yy" * 50, b"", b"\x00\x01\x02"]
    tfc.write_tfrecords(str(tmp_path / "p.tfrecord"), payloads)
    jtfc.write_tfrecords(str(tmp_path / "j.tfrecord"), payloads)
    assert ((tmp_path / "p.tfrecord").read_bytes()
            == (tmp_path / "j.tfrecord").read_bytes())
    assert list(jtfc.iter_tfrecords(str(tmp_path / "p.tfrecord"))) == payloads


# --- tf.train.Example ------------------------------------------------------------


EXAMPLES = {
    "bytes": {"s": [b"tok1", b"tok2", b""]},
    "str": {"s": ["abc", "été"]},
    "float": {"f": [1.5, -2.25, 0.0, float("nan"), float("inf")]},
    "numpy_float": {"f": [np.float32(0.1), np.float64(1e-30)]},
    "int64": {"i": [7, -3, 2**40, -(2**63), 2**63 - 1, 0]},
    "empty_list": {"e": []},
    "mixed": {"a": [b"x"], "b": [2.5], "c": [-1], "d": []},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_build_example_bytes_equal_jax(name):
    row = EXAMPLES[name]
    got = tfc.build_example(row)
    assert got == jtfc.build_example(row)
    assert repr(tfc.parse_example(got)) == repr(jtfc.parse_example(got))


def _ld(field, payload):
    return bytes([field << 3 | 2, len(payload)]) + payload


PAYLOADS = {
    # FloatList written unpacked (tag 0x0D a value)
    "unpacked_float": _ld(1, _ld(1, _ld(1, b"f") + _ld(2, _ld(
        2, b"\x0d" + struct.pack("<f", 1.5) + b"\x0d"
        + struct.pack("<f", -3.0))))),
    # Int64List written unpacked (tag 0x08 a value), one negative: 10 bytes
    "unpacked_int64": _ld(1, _ld(1, _ld(1, b"i") + _ld(2, _ld(
        3, b"\x08\x05\x08" + tfc._varint((-2) & 0xFFFFFFFFFFFFFFFF))))),
    "negative_packed_int64": tfc.build_example({"i": [-1, -(2**40), 3]}),
    # unknown fields at every level: Example, Features, the entry, the list
    "unknown_fields": (
        b"\x10\x2a"  # Example field 2, varint
        + _ld(1, b"\x19" + b"\x00" * 8  # Features field 3, fixed64
              + _ld(1, b"\x1d" + b"\x00" * 4  # entry field 3, fixed32
                    + _ld(1, b"k") + _ld(2, b"\x20\x01" + _ld(
                        1, b"\x10\x07" + _ld(1, b"v"))))
              + _ld(5, b"junk"))),
    "repeated_key_last_wins": _ld(1, _ld(1, _ld(1, b"k") + _ld(2, _ld(
        1, _ld(1, b"first")))) + _ld(1, _ld(1, b"k") + _ld(2, _ld(
            1, _ld(1, b"second"))))),
    "entry_without_value": _ld(1, _ld(1, _ld(1, b"k"))),
    "empty_feature": _ld(1, _ld(1, _ld(1, b"k") + _ld(2, b""))),
    "packed_floats_from_tf": tfc.build_example({"f": [0.25, 1e-7]}),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_parse_example_equals_jax(name):
    payload = PAYLOADS[name]
    got = tfc.parse_example(payload)
    assert repr(got) == repr(jtfc.parse_example(payload))
    if name == "unpacked_int64":
        assert got == {"i": [5, -2]}
    if name == "repeated_key_last_wins":
        assert got == {"k": [b"second"]}


# --- tables <-> TFRecord -----------------------------------------------------------


@pytest.mark.parametrize("max_rows", [2, 100])
def test_table_to_tfrecords_bytes_equal_jax(tmp_path, rows, max_rows):
    """Every feature kind, byte for byte: the missing colour (NaN in the
    frame, ``""`` in the table) as ``FloatList [nan]``, the float size
    column as ``"1.0"``, the missing age and price as NaN floats, empty
    histories as empty Features."""
    table, frame = rows
    port_f, jax_f = both_features()
    got = tfc.dataframe_to_tfrecords(table, port_f, str(tmp_path / "p" / "t"),
                                     max_rows=max_rows)
    want = jtfc.dataframe_to_tfrecords(frame, jax_f,
                                       str(tmp_path / "j" / "t"),
                                       max_rows=max_rows)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert files_bytes(got) == files_bytes(want)
    records = [tfc.parse_example(r) for f in got
               for r in tfc.iter_tfrecords(f)]
    # trap q: the missing categorical is a FloatList holding NaN
    assert len(records[1]["colour"]) == 1
    assert np.isnan(records[1]["colour"][0])
    assert records[0]["size"] == [b"1.0"]
    assert records[1]["history"] == []


def test_the_port_reads_jax_files_as_jax_reads_them(tmp_path, rows):
    table, frame = rows
    port_f, jax_f = both_features()
    jtfc.dataframe_to_tfrecords(frame, jax_f, str(tmp_path / "t"),
                                max_rows=2)
    got = tfc.tfrecords_to_dataframe(str(tmp_path), port_f)
    want = jtfc.tfrecords_to_dataframe(str(tmp_path), jax_f)
    assert_table_equals_frame(got, want)
    assert got["colour"].tolist() == ["red", "nan", "blue", "red", "green"]


def assert_table_equals_frame(table, frame):
    assert list(table) == list(frame.columns)
    for name, col in table.items():
        if isinstance(col, ListColumn):
            assert col.tolist() == frame[name].tolist(), name
        elif col.dtype.kind == "f":
            np.testing.assert_array_equal(col, frame[name].to_numpy(float))
        else:
            assert col.tolist() == frame[name].tolist(), name


def test_the_port_reads_tensorflows_files(tmp_path):
    """Files written by ``tf.io.TFRecordWriter`` from ``tf.train.Example``
    (TF packs its floats and int64s): the port's table equals JAX's."""
    tf = pytest.importorskip("tensorflow")
    port_f, jax_f = both_features()
    path = str(tmp_path / "ref_0.tfrecord")
    rows = [("c2", "red", "1", 21.0, 0.5, [b"a1", b"a2"]),
            ("zzz", "blue", "3.0", -4.75, 1e-6, []),
            ("c1", "nan", "2.0", float("nan"), 3.0, [b"a2"] * 4)]
    with tf.io.TFRecordWriter(path) as w:
        for cust, colour, size, age, price, hist in rows:
            def b(v):
                return tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=v))

            def f(v):
                return tf.train.Feature(float_list=tf.train.FloatList(
                    value=[v]))
            ex = tf.train.Example(features=tf.train.Features(feature={
                "customer_id": b([cust.encode()]),
                "colour": b([colour.encode()]),
                "size": b([size.encode()]),
                "age": f(age),
                "price": f(price),
                "history": b(hist),
                "extra": tf.train.Feature(int64_list=tf.train.Int64List(
                    value=[-5, 2**40])),
            }))
            w.write(ex.SerializeToString())
    got = tfc.tfrecords_to_dataframe(path, port_f)
    assert_table_equals_frame(got, jtfc.tfrecords_to_dataframe(path, jax_f))
    assert got["customer_id"].tolist() == ["c2", "zzz", "c1"]
    # TF reads the port's files back
    written = tfc.dataframe_to_tfrecords(got, port_f,
                                         str(tmp_path / "out" / "t"))
    spec = {"customer_id": tf.io.FixedLenFeature([1], tf.string),
            "age": tf.io.FixedLenFeature([1], tf.float32),
            "history": tf.io.VarLenFeature(tf.string)}
    parsed = [tf.io.parse_single_example(r, spec)
              for r in tf.data.TFRecordDataset(written)]
    assert [p["customer_id"].numpy()[0].decode() for p in parsed] == [
        "c2", "zzz", "c1"]
    assert [p["history"].values.numpy().tolist() for p in parsed] == [
        [b"a1", b"a2"], [], [b"a2"] * 4]


def test_twelve_files_read_in_jaxs_lexicographic_order(tmp_path, rows):
    """Twelve one-row files: ``t_10`` and ``t_11`` come before ``t_2``, so
    the rows read back permuted, as JAX reads them."""
    table, frame = rows
    port_f, jax_f = both_features()
    big = {k: (v.take(np.arange(12) % 5) if isinstance(v, ListColumn)
               else v[np.arange(12) % 5]) for k, v in table.items()}
    big["customer_id"] = np.array([f"r{i}" for i in range(12)])
    paths = tfc.dataframe_to_tfrecords(big, port_f, str(tmp_path / "t"),
                                       max_rows=1)
    assert len(paths) == 12
    got = tfc.tfrecords_to_dataframe(str(tmp_path), port_f)
    want = jtfc.tfrecords_to_dataframe(str(tmp_path), jax_f)
    assert_table_equals_frame(got, want)
    order = [0, 1, 10, 11] + list(range(2, 10))
    assert got["customer_id"].tolist() == [f"r{i}" for i in order]


# --- migration -----------------------------------------------------------------------


def shard_arrays(d):
    ds = ShardDataset(str(d))
    return ds.manifest, ds.load_all()


def assert_same_shards(a, b):
    (ma, da), (mb, db) = shard_arrays(a), shard_arrays(b)
    assert ma == mb
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert set(da) == set(db)
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_import_and_export_equal_jax(tmp_path, rows):
    """``import_tfrecords`` of JAX-written files equals JAX's import array
    for array (and a direct ``ShardWriter`` write of the same rows), and
    ``export_shards_to_tfrecords`` writes JAX's export bytes."""
    table, frame = rows
    port_f, jax_f = both_features()
    jtfc.dataframe_to_tfrecords(frame, jax_f, str(tmp_path / "tfr" / "t"),
                                max_rows=2)
    n = tfc.import_tfrecords(str(tmp_path / "tfr"), port_f,
                             str(tmp_path / "port_npz"), max_rows=3)
    assert n == jtfc.import_tfrecords(str(tmp_path / "tfr"), jax_f,
                                      str(tmp_path / "jax_npz"), max_rows=3)
    assert_same_shards(tmp_path / "port_npz", tmp_path / "jax_npz")
    # the missing colour read back as "nan", which this vocab holds
    colour = ShardDataset(str(tmp_path / "port_npz")).load_all()["colour"]
    assert colour.tolist() == [1, 3, 2, 1, 0]
    # where "nan" is no token, the import equals a direct write of the rows
    plain = [Feature(**dict(s, vocab=["red", "blue"]))
             if s["name"] == "colour" else Feature(**s)
             for s in FEATURE_SPECS]
    tfc.import_tfrecords(str(tmp_path / "tfr"), plain,
                         str(tmp_path / "plain_npz"), max_rows=3)
    ShardWriter(plain, max_rows=3).write_shards(table,
                                                str(tmp_path / "direct"))
    assert_same_shards(tmp_path / "plain_npz", tmp_path / "direct")

    got = tfc.export_shards_to_tfrecords(str(tmp_path / "port_npz"), port_f,
                                         str(tmp_path / "pout" / "t"),
                                         max_rows=4)
    want = jtfc.export_shards_to_tfrecords(str(tmp_path / "jax_npz"), jax_f,
                                           str(tmp_path / "jout" / "t"),
                                           max_rows=4)
    assert files_bytes(got) == files_bytes(want)
    back = tfc.tfrecords_to_dataframe(str(tmp_path / "pout"), port_f)
    # "zzz" was OOV at encode time: "<OOV>" now; the OOV token "zz" of
    # the last three is id 0, the pad, and drops out
    assert back["customer_id"].tolist() == ["c2", "c1", "<OOV>", "c3", "c2"]
    assert back["history"].tolist()[2] == ["a2", "a1"]


def test_export_keeps_out_of_range_ids_as_oov(tmp_path):
    port_f, jax_f = both_features()
    shards = {"customer_id": np.array([1, 9, -1, 0], np.int32),
              "colour": np.array([1, 2, 3, 0], np.int32),
              "size": np.array([3, 1, 0, 2], np.int32),
              "age": np.array([0.5, np.nan, -1.0, 2.0], np.float32),
              "price": np.array([1, 2, 3, 4], np.float32),
              "history": np.array([[1, 2, 0], [0, 0, 0], [7, -3, 2],
                                   [2, 2, 2]], np.int32)}
    d = tmp_path / "npz"
    d.mkdir()
    np.savez(d / "shard_00000.npz", **shards)
    (d / "manifest.json").write_text(
        '{"num_rows": 4, "num_shards": 1, "max_rows": 100, "features": '
        '{"customer_id": "int32", "colour": "int32", "size": "int32", '
        '"age": "float32", "price": "float32", "history": "int32"}}')
    got = tfc.export_shards_to_tfrecords(str(d), port_f,
                                         str(tmp_path / "p" / "t"))
    want = jtfc.export_shards_to_tfrecords(str(d), jax_f,
                                           str(tmp_path / "j" / "t"))
    assert files_bytes(got) == files_bytes(want)


def test_the_module_runs_without_pandas_pyarrow_or_tensorflow(tmp_path):
    """A fresh interpreter with pandas, pyarrow and tensorflow blocked
    writes, reads, imports and exports; the files equal this process's."""
    port_f, _ = both_features()
    table = {"customer_id": np.array(["c1", "", "c9"]),
             "colour": np.array(["red", "blue", ""]),
             "size": np.array([1.0, np.nan, 3.0]),
             "age": np.array([20.0, np.nan, 61.5]),
             "price": np.array([0.5, 1.5, 2.5]),
             "history": ListColumn(np.array([0, 1, 1, 3]),
                                   np.array([0, 1, 0]),
                                   np.array(["a1", "a2"]))}
    want = files_bytes(tfc.dataframe_to_tfrecords(
        table, port_f, str(tmp_path / "want" / "t")))
    code = f"""
import sys
for m in ("pandas", "pyarrow", "tensorflow"):
    sys.modules[m] = None
import numpy as np
from hm_retrieval_tpu_torch.data import tfrecord_compat as tfc
from hm_retrieval_tpu_torch.etl.transformations import ListColumn
from hm_retrieval_tpu_torch.schema.features import Feature
feats = [Feature(**s) for s in {FEATURE_SPECS!r}]
table = {{"customer_id": np.array(["c1", "", "c9"]),
         "colour": np.array(["red", "blue", ""]),
         "size": np.array([1.0, np.nan, 3.0]),
         "age": np.array([20.0, np.nan, 61.5]),
         "price": np.array([0.5, 1.5, 2.5]),
         "history": ListColumn(np.array([0, 1, 1, 3]), np.array([0, 1, 0]),
                               np.array(["a1", "a2"]))}}
tfc.dataframe_to_tfrecords(table, feats, {str(tmp_path / 'got' / 't')!r})
tfc.import_tfrecords({str(tmp_path / 'got')!r}, feats,
                     {str(tmp_path / 'npz')!r})
tfc.export_shards_to_tfrecords({str(tmp_path / 'npz')!r}, feats,
                               {str(tmp_path / 'out' / 't')!r})
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("pandas", "pyarrow", "tensorflow", "jax")
             and sys.modules[m] is not None))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[]"
    assert files_bytes([tmp_path / "got" / "t_0.tfrecord"]) == want
    assert len(list(tfc.iter_tfrecords(
        str(tmp_path / "out" / "t_0.tfrecord")))) == 3
