"""ETL primitives without pandas: CSV typing, table IO, date filtering, the
inner merge and the purchase-history column.

Counterpart of the JAX package's ``etl/transformations.py``. A table is a
dict of column name -> column, every column of one length, in column order:

- a 1-D numpy array: int64, float64 (NaN where a value is missing), bool, or
  str (numpy ``U``; ``""`` where a value is missing, since ``pd.read_csv``
  never returns an empty string);
- a ``ListColumn``: a list of string tokens a row (the history column).

A CSV column takes the type ``pd.read_csv`` gives it (pandas 3, its default
``na_values``):

- ``""``, ``NA``, ``null``, ``nan`` and the rest of ``NA_VALUES`` are
  missing;
- every present value an integer: int64 (``"0108775015"`` reads as
  108775015), or float64 when a value is missing (``astype(str)`` then gives
  ``"1.0"``);
- every present value a number: float64; every value missing: float64;
- every value ``true`` / ``false`` in any case: bool; with a missing value
  pandas gives an object column, which raises ``ValueError`` here;
- any other column: str, each value as written.

Numbers parse as pandas' default C parser parses them (``precise_xstrtod``:
at most 17 digits, then one scaling by a power of ten), which is not
Python's correctly rounded ``float`` for long decimals.

Tables are stored by file extension: ``.npz`` (the port's own format, any
column), ``.csv`` (plain columns only) and ``.parquet`` (through pyarrow, in
the JAX package's layout, so either package reads the other's split; where
pyarrow is not installed it raises ``ImportError``).
"""

from __future__ import annotations

import csv
import io
import itertools
import json
import logging
import operator
import os
import re
import shutil
import zipfile
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
])
_SPACE = "[ \t\n\v\f\r]*"  # pandas' isspace_ascii
_INT = re.compile(f"{_SPACE}[+-]?[0-9]+{_SPACE}")
_FLOAT = re.compile(
    f"{_SPACE}[+-]?(?:[0-9]+\\.?[0-9]*|\\.[0-9]+)(?:[eE][+-]?[0-9]+)?{_SPACE}"
    "|[+-]?(?i:inf|infinity)"
)
_POW10 = [float(f"1e{k}") for k in range(309)]
_BOOL = {"true", "false"}
_LIST_PARTS = ("offsets", "codes", "tokens")
_NPZ_COLUMNS = "__columns__"


@dataclass(frozen=True)
class ListColumn:
    """A list of string tokens a row: row r holds
    ``tokens[codes[offsets[r]:offsets[r + 1]]]``."""

    offsets: np.ndarray  # (rows + 1,) int64, from 0
    codes: np.ndarray  # (offsets[-1],) int32 into tokens
    tokens: np.ndarray  # str

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def take(self, rows: np.ndarray) -> "ListColumn":
        """The rows at ``rows`` (indices or a boolean mask), in that order."""
        rows = np.arange(len(self))[rows] if np.asarray(rows).dtype == bool \
            else np.asarray(rows, np.int64)
        lens = (self.offsets[1:] - self.offsets[:-1])[rows]
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        src = (np.repeat(self.offsets[:-1][rows] - offsets[:-1], lens)
               + np.arange(offsets[-1], dtype=np.int64))
        return ListColumn(offsets, self.codes[src], self.tokens)

    def flat_tokens(self) -> np.ndarray:
        """Every row's tokens one after another (pandas' ``explode`` without
        the empty rows)."""
        return self.tokens[self.codes]

    def tolist(self) -> List[List[str]]:
        flat = self.flat_tokens().tolist()
        o = self.offsets.tolist()
        return [flat[a:b] for a, b in zip(o[:-1], o[1:])]


Column = Union[np.ndarray, ListColumn]
Table = Dict[str, Column]


# --- tables ------------------------------------------------------------------


def table_len(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: Table, rows) -> Table:
    """The rows at ``rows`` (indices or a boolean mask) of every column."""
    return {name: col.take(rows) if isinstance(col, ListColumn) else col[rows]
            for name, col in table.items()}


def select(table: Table, columns: Sequence[str]) -> Table:
    return {name: table[name] for name in columns}


def concat_tables(tables: Sequence[Table]) -> Table:
    """Rows of ``tables`` one after another; the columns of the first."""
    return {name: concat_columns([t[name] for t in tables])
            for name in tables[0]}


def concat_columns(cols: Sequence[Column]) -> Column:
    if not isinstance(cols[0], ListColumn):
        return np.concatenate(cols)
    tokens = cols[0].tokens
    if any(not np.array_equal(c.tokens, tokens) for c in cols[1:]):
        raise ValueError("list columns of other token lists cannot be joined")
    lens = np.concatenate([np.diff(c.offsets) for c in cols])
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return ListColumn(offsets, np.concatenate([c.codes for c in cols]),
                      tokens)


def isna(col: np.ndarray) -> np.ndarray:
    """Missing values of a plain column: NaN, or ``""`` in a str column."""
    if col.dtype.kind == "U":
        return col == ""
    if col.dtype.kind == "f":
        return np.isnan(col)
    return np.zeros(len(col), bool)


def drop_duplicates(table: Table, subset: str) -> Table:
    """Each row whose ``subset`` value has not appeared in an earlier row."""
    codes, _ = factorize(table[subset])
    _, first = np.unique(codes, return_index=True)
    return take(table, first)  # codes rise with first appearance


class Lookup(dict):
    """A dict that answers ``missing`` for an absent key, so that
    ``map(lookup.__getitem__, keys)`` codes a list at C speed."""

    def __init__(self, items=(), missing=-1):
        super().__init__(items)
        self.missing = missing

    def __missing__(self, key):
        return self.missing


def _ascii_words(values: np.ndarray) -> Optional[np.ndarray]:
    """(rows, k) big-endian uint64 words of an ASCII str array, 8 characters
    a word (equal words, equal strings); None if a character is not
    ASCII."""
    width = values.dtype.itemsize // 4
    chars = values.view(np.uint32).reshape(len(values), width)
    if chars.size and chars.max() > 127:
        return None
    k = -(-width // 8)
    out = np.zeros((len(values), 8 * k), np.uint8)
    out[:, :width] = chars
    return out.view(">u8")


def group_codes(values: np.ndarray) -> np.ndarray:
    """Int codes, equal for equal values (every NaN one value), in no
    particular order, from numpy sorts of integers where the values are
    ASCII strings (a string sort otherwise)."""
    words = _ascii_words(values) if values.dtype.kind == "U" else None
    if words is None:
        return np.unique(values, return_inverse=True)[1].reshape(-1)
    codes = np.zeros(len(values), np.int64)
    for j in range(words.shape[1]):
        uniq, inv = np.unique(words[:, j], return_inverse=True)
        codes = np.unique(codes * len(uniq) + inv.reshape(-1),
                          return_inverse=True)[1].reshape(-1)
    return codes


def factorize(values: np.ndarray):
    """(codes, uniques), uniques in order of first appearance, a missing
    value a value of its own: ``pd.factorize(use_na_sentinel=False)``."""
    n = len(values)
    codes = group_codes(values)
    m = int(codes.max()) + 1 if n else 0
    first = np.full(m, n, np.int64)
    np.minimum.at(first, codes, np.arange(n, dtype=np.int64))
    order = np.argsort(first, kind="stable")
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m)
    return rank[codes], values[first[order]]


def _token_strings(uniques: np.ndarray) -> np.ndarray:
    """History tokens as the JAX package writes them: ``astype(str)``, a
    missing value ``"nan"``."""
    if uniques.dtype.kind == "U":
        return np.where(uniques == "", "nan", uniques)
    return uniques.astype(str)


# --- CSV ---------------------------------------------------------------------


class _Kind:
    """What pd.read_csv would type a column as, from its values so far."""

    def __init__(self):
        self.rows = self.missing = 0
        self.int_ok = self.float_ok = self.bool_ok = True

    def update(self, values: List[str]) -> "_Kind":
        present = (values if NA_VALUES.isdisjoint(values)
                   else [v for v in values if v not in NA_VALUES])
        self.rows += len(values)
        self.missing += len(values) - len(present)
        if self.int_ok:
            self.int_ok = all(map(_INT.fullmatch, present))
        if self.float_ok and not self.int_ok:
            self.float_ok = all(map(_FLOAT.fullmatch, present))
        if self.bool_ok:
            self.bool_ok = all(v.lower() in _BOOL for v in present)
        return self

    def kind(self, name: str) -> str:
        if self.rows == 0:
            return "str"
        if self.missing == self.rows:
            return "float"
        if self.int_ok:
            return "float" if self.missing else "int"
        if self.float_ok:
            return "float"
        if self.bool_ok:
            if self.missing:
                raise ValueError(
                    f"column {name!r} would read as bool with missing values "
                    "(an object column in pandas)")
            return "bool"
        return "str"


def _xstrtod(text: str) -> float:
    """One value as pandas' default float parser reads it (precise_xstrtod
    in pandas' tokenizer.c): the first 17 digits accumulate in a double,
    the exponent scales it once by a power of ten."""
    t = text.strip(" \t\n\v\f\r")
    if t.lstrip("+-").lower() in ("inf", "infinity"):
        return float(t)
    i, n = 0, len(t)
    negative = t[0] == "-"
    i += t[0] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while i < n and "0" <= t[i] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(t[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and t[i] == ".":
        i += 1
        decimals = 0
        while digits < 17 and i < n and "0" <= t[i] <= "9":
            number = number * 10.0 + (ord(t[i]) - 48)
            i, digits, decimals = i + 1, digits + 1, decimals + 1
        while i < n and "0" <= t[i] <= "9":
            i += 1
        exponent -= decimals
    if negative:
        number = -number
    if i < n and t[i] in "eE":
        i += 1
        minus = t[i] == "-"
        i += t[i] in "+-"
        value = 0
        for c in t[i:i + 17]:
            value = value * 10 + (ord(c) - 48)
        exponent += -value if minus else value
    if exponent > 308:
        return float("inf") if number > 0 else -float("inf") if number else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _to_float(value: str) -> float:
    if value in NA_VALUES:
        return float("nan")
    # up to 15 digits and no exponent: one exact integer scaled once by an
    # exact power of ten, so pandas' result is the correctly rounded one
    if len(value) <= 15 and "e" not in value and "E" not in value:
        return float(value)
    return _xstrtod(value)


def _convert(name: str, values: List[str], kind: str) -> np.ndarray:
    if kind == "str":
        if not NA_VALUES.isdisjoint(values):
            values = [("" if v in NA_VALUES else v) for v in values]
        return np.asarray(values, dtype=str)
    if kind == "bool":
        return np.asarray([v.lower() == "true" for v in values], dtype=bool)
    if kind == "float":
        return np.fromiter(map(_to_float, values), np.float64, len(values))
    try:
        return np.asarray(values, dtype=str).astype(np.int64)
    except OverflowError:
        raise ValueError(f"column {name!r} overflows int64") from None


def _typed_column(name: str, values: List[str]) -> np.ndarray:
    """One CSV column as ``pd.read_csv`` would type it."""
    return _convert(name, values, _Kind().update(values).kind(name))


_BLOCK_BYTES = 1 << 25


def _text_blocks(f) -> Iterator[str]:
    """The rest of binary file ``f`` as decoded blocks of whole lines."""
    rest = b""
    while True:
        data = f.read(_BLOCK_BYTES)
        if not data:
            if rest:
                yield rest.decode()
            return
        data = rest + data
        cut = data.rfind(b"\n") + 1
        rest = data[cut:]
        if cut:
            yield data[:cut].decode()


def _split_fields(text: str, n: int):
    """The n fields of each line of ``text`` by ``str.split``, a list a
    column, where that is what the csv module gives: no quote, no carriage
    return and n fields on every line but blank ones (pandas skips those).
    None otherwise."""
    if '"' in text or "\r" in text:
        return None
    lines = text.split("\n")
    if lines[-1] == "":
        lines.pop()
    if "" in lines:
        lines = list(filter(None, lines))
    if lines and set(map(operator.methodcaller("count", ","), lines)) != {
            n - 1}:
        return None
    flat = ",".join(lines).split(",") if lines else []
    return [flat[c::n] for c in range(n)]


def _column_blocks(f, n: int) -> Iterator[list]:
    """Per-column field lists of the rest of binary file ``f``, a block at a
    time; from the first block ``str.split`` cannot read exactly, the csv
    module reads the rest (a short line's missing fields read as missing,
    as in pandas)."""
    blocks = _text_blocks(f)
    for text in blocks:
        cols = _split_fields(text, n)
        if cols is not None:
            yield cols
            continue
        lines = itertools.chain.from_iterable(
            io.StringIO(t, newline="") for t in itertools.chain([text], blocks))
        rows = filter(None, csv.reader(lines))  # blank lines are skipped
        while True:
            part = list(itertools.islice(rows, 1 << 20))
            if not part:
                return
            cols = list(itertools.zip_longest(*part, fillvalue=""))
            yield cols + [("",) * len(part)] * (n - len(cols))


def _csv_rows(filepath: str, columns: Optional[Sequence[str]], chunk_rows):
    """(column names, iterator of per-column value lists of ``chunk_rows``
    rows, the last one shorter, or of all rows when it is None)."""
    f = open(filepath, "rb")
    header = next(csv.reader([f.readline().decode()]), [])
    wanted = list(header) if columns is None else list(columns)
    missing = [c for c in wanted if c not in header]
    if missing:
        f.close()
        raise ValueError(f"columns {missing} not in {filepath}")
    pos = [header.index(c) for c in wanted]

    def chunks():
        with f:
            pending, n = [[] for _ in wanted], 0
            for cols in _column_blocks(f, len(header)):
                for out, p in zip(pending, pos):
                    out.extend(cols[p])
                n += len(cols[0]) if cols else 0
                while chunk_rows and n >= chunk_rows:
                    yield [c[:chunk_rows] for c in pending]
                    pending = [c[chunk_rows:] for c in pending]
                    n -= chunk_rows
            if n or not chunk_rows:
                yield pending

    return wanted, chunks()


def _read_csv(filepath: str, columns: Optional[Sequence[str]]) -> Table:
    wanted, chunks = _csv_rows(filepath, columns, None)
    cols = next(chunks)
    return {c: _typed_column(c, v) for c, v in zip(wanted, cols)}


def csv_kinds(filepath: str, columns: Optional[Sequence[str]] = None,
              chunk_rows: int = 1 << 20) -> Dict[str, str]:
    """Each column's type over the whole file, read ``chunk_rows`` rows at a
    time: what the JAX package's chunked ETL forces with its dtype pre-pass
    (trap p)."""
    wanted, chunks = _csv_rows(filepath, columns, chunk_rows)
    kinds = [_Kind() for _ in wanted]
    for cols in chunks:
        for k, v in zip(kinds, cols):
            k.update(v)
    return {c: k.kind(c) for c, k in zip(wanted, kinds)}


def iter_csv_chunks(filepath: str, columns: Optional[Sequence[str]],
                    chunk_rows: int) -> Iterator[Table]:
    """Tables of ``chunk_rows`` rows, each column typed over the whole
    file."""
    kinds = csv_kinds(filepath, columns, chunk_rows)
    wanted, chunks = _csv_rows(filepath, columns, chunk_rows)
    for cols in chunks:
        yield {c: _convert(c, v, kinds[c]) for c, v in zip(wanted, cols)}


def _write_csv(table: Table, filepath: str, header: bool = True) -> None:
    """The plain columns as pandas' ``to_csv(index=False)`` writes them,
    appended after an earlier table's rows when ``header`` is False."""
    lists = [name for name, col in table.items()
             if isinstance(col, ListColumn)]
    if lists:
        raise ValueError(
            f"list columns {lists} cannot be written to a CSV; write the "
            "table to .npz or .parquet")
    cols = []
    for col in table.values():
        text = col.astype(str)
        if col.dtype.kind == "f":
            text[np.isnan(col)] = ""
        cols.append(text.tolist())
    with open(filepath, "w" if header else "a", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(list(table))
        w.writerows(zip(*cols))


# --- npz: the port's own format -----------------------------------------------


def _npz_members(table: Table) -> Dict[str, np.ndarray]:
    out = {_NPZ_COLUMNS: np.asarray(
        [json.dumps([name, isinstance(col, ListColumn)])
         for name, col in table.items()], dtype=str)}
    for name, col in table.items():
        if isinstance(col, ListColumn):
            for part in _LIST_PARTS:
                out[f"{name}.{part}"] = getattr(col, part)
        else:
            out[name] = col
    return out


def _npz_layout(z) -> List[tuple]:
    return [tuple(json.loads(s)) for s in z[_NPZ_COLUMNS].tolist()]


def _read_npz(filepath: str, columns: Optional[Sequence[str]]) -> Table:
    with np.load(filepath, allow_pickle=False) as z:
        layout = dict(_npz_layout(z))
        wanted = list(layout) if columns is None else list(columns)
        missing = [c for c in wanted if c not in layout]
        if missing:
            raise ValueError(f"columns {missing} not in {filepath}")
        return {c: (ListColumn(*(z[f"{c}.{p}"] for p in _LIST_PARTS))
                    if layout[c] else z[c]) for c in wanted}


class _NpyStream:
    """Sequential reads of one ``.npy`` member of an uncompressed npz."""

    def __init__(self, zf: zipfile.ZipFile, member: str):
        self.fp = zf.open(member + ".npy")
        version = np.lib.format.read_magic(self.fp)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        self.shape, _, self.dtype = read(self.fp)

    def read(self, n: int) -> np.ndarray:
        data = self.fp.read(n * self.dtype.itemsize)
        return np.frombuffer(data, self.dtype).copy()


def _iter_npz_batches(filepath: str, columns: Sequence[str],
                      batch_rows: int) -> Iterator[Table]:
    with zipfile.ZipFile(filepath) as zf:
        with np.load(filepath, allow_pickle=False) as z:
            layout = dict(_npz_layout(z))
            tokens = {c: z[f"{c}.tokens"] for c in columns if layout[c]}
        streams = {}
        for c in columns:
            if layout[c]:
                streams[c] = (_NpyStream(zf, f"{c}.offsets"),
                              _NpyStream(zf, f"{c}.codes"))
                streams[c][0].read(1)  # offsets[0] == 0
            else:
                streams[c] = _NpyStream(zf, c)
        any_col = streams[columns[0]]
        n = (any_col[0].shape[0] - 1 if layout[columns[0]]
             else any_col.shape[0])
        done, last = 0, {c: 0 for c in columns}
        while done < n:
            m = min(batch_rows, n - done)
            batch = {}
            for c in columns:
                if not layout[c]:
                    batch[c] = streams[c].read(m)
                    continue
                ends = streams[c][0].read(m)
                codes = streams[c][1].read(int(ends[-1] - last[c]))
                offsets = np.concatenate([[last[c]], ends]) - last[c]
                batch[c] = ListColumn(offsets, codes, tokens[c])
                last[c] = int(ends[-1])
            done += m
            yield batch
        for s in streams.values():
            for fp in (s if isinstance(s, tuple) else (s,)):
                fp.fp.close()


def _write_npz_streamed(filepath: str, parts: Sequence[str]) -> None:
    """One npz from the npz tables ``parts`` (the same columns), written a
    member and a part at a time."""
    with np.load(parts[0], allow_pickle=False) as z:
        layout = _npz_layout(z)
    keys = [_NPZ_COLUMNS]
    for name, is_list in layout:
        keys += [f"{name}.{p}" for p in _LIST_PARTS] if is_list else [name]
    tmp = filepath + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as out:
        for key in keys:
            _write_member(out, key, parts)
    os.replace(tmp, filepath)


def _npy_header(path: str, key: str):
    with zipfile.ZipFile(path) as zf:
        s = _NpyStream(zf, key)
        s.fp.close()
    return s.shape, s.dtype


def _write_member(out: zipfile.ZipFile, key: str, parts: Sequence[str]):
    """Member ``key`` of every part, one after another; one copy of the
    column list and of a list column's tokens, which every part shares; a
    list column's offsets continued across the parts."""
    def load(path):
        with np.load(path, allow_pickle=False) as z:
            return z[key]

    if key == _NPZ_COLUMNS or key.endswith(".tokens"):
        first = load(parts[0])
        if any(not np.array_equal(load(p), first) for p in parts[1:]):
            raise ValueError(f"the parts' {key} differ")
        parts = parts[:1]
    heads = [_npy_header(p, key) for p in parts]
    dtype = np.result_type(*(d for _, d in heads))
    n = sum(shape[0] for shape, _ in heads)
    offsets = key.endswith(".offsets")
    if offsets:
        n -= len(parts) - 1
    with out.open(key + ".npy", "w", force_zip64=True) as fp:
        np.lib.format.write_array_header_1_0(fp, {
            "descr": np.lib.format.dtype_to_descr(dtype),
            "fortran_order": False, "shape": (n,) + heads[0][0][1:]})
        base = 0
        for i, path in enumerate(parts):
            a = load(path)
            if offsets:
                a = a[(1 if i else 0):] + base
                base = int(a[-1]) if len(a) else base
            fp.write(np.ascontiguousarray(a, dtype=dtype).tobytes())


# --- parquet, through pyarrow ------------------------------------------------


def _arrow_column(col: Column):
    import pyarrow as pa

    if isinstance(col, ListColumn):
        return pa.LargeListArray.from_arrays(
            pa.array(col.offsets, type=pa.int64()),
            pa.DictionaryArray.from_arrays(
                pa.array(col.codes, type=pa.int32()),
                pa.array(col.tokens, type=pa.string())))
    if col.dtype.kind == "U":
        return pa.array(col, type=pa.large_string(), mask=col == "")
    return pa.array(col, from_pandas=True)  # NaN is stored as null


def _from_arrow(arr) -> Column:
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        if arr.null_count:  # a missing list reads as an empty one
            arr = pa.array([x or [] for x in arr.to_pylist()], type=t)
        values = arr.values
        if not pa.types.is_dictionary(values.type):
            values = values.dictionary_encode()
        offsets = np.asarray(arr.offsets, np.int64)
        codes = np.asarray(values.indices, np.int64)[offsets[0]:offsets[-1]]
        tokens = np.asarray(values.dictionary.cast(pa.string())
                            .to_pylist(), dtype=str)
        return ListColumn(offsets - offsets[0], codes.astype(np.int32),
                          tokens)
    if pa.types.is_dictionary(t):
        arr, t = arr.cast(t.value_type), t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return np.asarray(pc.fill_null(arr, "").to_pylist(), dtype=str)
    if pa.types.is_integer(t) and arr.null_count:
        return arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
    out = arr.to_numpy(zero_copy_only=False)
    if out.dtype == object:
        raise ValueError(f"a {t} column with missing values has no plain type")
    return out.astype(np.int64) if out.dtype.kind in "iu" else out


def _pyarrow_parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError(
            "reading or writing .parquet needs pyarrow, which is not "
            "installed; use a .npz path (the port's own table format)"
        ) from exc
    return pq


def _arrow_table(table: Table):
    import pyarrow as pa

    return pa.table({name: _arrow_column(col) for name, col in table.items()})


def _read_parquet(filepath: str, columns: Optional[Sequence[str]]) -> Table:
    pq = _pyarrow_parquet()
    tbl = pq.read_table(filepath, columns=list(columns) if columns else None)
    return {name: _from_arrow(tbl.column(name)) for name in tbl.column_names}


def _iter_parquet_batches(filepath: str, columns: Sequence[str],
                          batch_rows: int) -> Iterator[Table]:
    # whole row groups, sliced: the JAX package's iter_parquet_batches
    pf = _pyarrow_parquet().ParquetFile(filepath)
    for g in range(pf.num_row_groups):
        tbl = pf.read_row_group(g, columns=list(columns))
        for off in range(0, len(tbl), batch_rows):
            part = tbl.slice(off, batch_rows).combine_chunks()
            yield {name: _from_arrow(part.column(name))
                   for name in part.column_names}


# --- reading and writing by extension ------------------------------------------


def load_dataframe(
    filepath: str, columns: Optional[Sequence[str]] = None
) -> Table:
    """A table from ``.npz``, ``.parquet`` or CSV by extension (ref:
    transformations.py:44-64), in ``columns`` order when given."""
    logger.info("Loading table from %s", filepath)
    if filepath.endswith(".npz"):
        table = _read_npz(filepath, columns)
    elif filepath.endswith(".parquet"):
        table = _read_parquet(filepath, columns)
    else:
        table = _read_csv(filepath, columns)
    logger.info("Loaded %d rows from %s", table_len(table), filepath)
    return table


def iter_table_batches(filepath: str, columns: Sequence[str],
                       batch_rows: int) -> Iterator[Table]:
    """Tables of at most ``batch_rows`` rows of ``columns``, in file order:
    an npz read a member slice at a time, a parquet file's row groups
    sliced (the JAX package's ``iter_parquet_batches``), a CSV typed over
    the whole file. Memory holds one batch."""
    columns = list(columns)
    if filepath.endswith(".npz"):
        return _iter_npz_batches(filepath, columns, batch_rows)
    if filepath.endswith(".parquet"):
        return _iter_parquet_batches(filepath, columns, batch_rows)
    return iter_csv_chunks(filepath, columns, batch_rows)


class TableWriter:
    """Appends tables of the same columns to one file; ``close`` finishes
    it. An npz is assembled from parts kept beside it, a member at a time;
    a parquet file takes one row group a table."""

    def __init__(self, filepath: str):
        self.filepath = filepath
        self.rows = 0
        self._parts: List[str] = []
        self._pq_writer = None
        self._first = True
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        if filepath.endswith(".parquet"):
            _pyarrow_parquet()
        self._parts_dir = filepath + ".parts"

    def write(self, table: Table) -> None:
        self.rows += table_len(table)
        if self.filepath.endswith(".npz"):
            if not self._parts:
                shutil.rmtree(self._parts_dir, ignore_errors=True)
                os.makedirs(self._parts_dir)
            path = os.path.join(self._parts_dir,
                                f"part_{len(self._parts):05d}.npz")
            np.savez(path, **_npz_members(table))
            self._parts.append(path)
        elif self.filepath.endswith(".parquet"):
            tbl = _arrow_table(table)
            if self._pq_writer is None:
                self._pq_writer = _pyarrow_parquet().ParquetWriter(
                    self.filepath, tbl.schema)
            self._pq_writer.write_table(tbl.cast(self._pq_writer.schema))
        else:
            _write_csv(table, self.filepath, header=self._first)
        self._first = False

    def close(self) -> None:
        if self._pq_writer is not None:
            self._pq_writer.close()
        if self._parts:
            if len(self._parts) == 1:
                os.replace(self._parts[0], self.filepath)
            else:
                _write_npz_streamed(self.filepath, self._parts)
            shutil.rmtree(self._parts_dir, ignore_errors=True)


def save_dataframe(
    table: Table, filepath: str, date_column: Optional[str] = None
) -> None:
    """mkdir, write by extension and log the covered date range (ref:
    transformations.py:67-95)."""
    n = table_len(table)
    if date_column is not None and n and logger.isEnabledFor(logging.INFO):
        dates = table[date_column]
        present = dates[~isna(dates)].tolist()
        logger.info("Saving %d rows covering %s..%s to %s", n,
                    min(present, default=None), max(present, default=None),
                    filepath)
    writer = TableWriter(filepath)
    writer.write(table)
    writer.close()


# --- transformations -----------------------------------------------------------


def date_filter(
    table: Table, date_column: str, start_date: str, end_date: str
) -> Table:
    """Rows with start_date <= table[date_column] <= end_date, inclusive at
    both ends, comparing the column as it was read; a missing date is in no
    range (ref: pkg/etl/transformations.py:9-41). A column read as numbers
    raises ``TypeError``, as pandas does."""
    col = table[date_column]
    mask = (col >= start_date) & (col <= end_date)
    if col.dtype.kind == "U":
        mask &= col != ""
    return take(table, mask)


class Join:
    """``left.merge(right, on=on, how="inner")`` (trap m) for any number of
    left tables against one right table, indexed once: left rows in order,
    each repeated once a matching right row, in the right table's order; a
    left row with no match is dropped; the left columns, then the right
    ones but ``on``, a name in both taking ``_x`` / ``_y``. A missing key
    joins a missing key, as in pandas."""

    def __init__(self, right: Table, on: str):
        self.right, self.on = right, on
        key = right[on]
        codes, uniq = factorize(key)
        self.unique_keys = len(uniq) == len(key)
        self.counts = np.bincount(codes, minlength=len(uniq))
        self.order = np.argsort(codes, kind="stable")
        self.starts = np.cumsum(self.counts) - self.counts
        self.uniq = uniq
        if key.dtype.kind != "f":
            self.index = Lookup(zip(uniq.tolist(), range(len(uniq))))

    def _codes(self, lk: np.ndarray) -> np.ndarray:
        """The right key code of each left key, -1 where none matches."""
        uniq = self.uniq
        if (lk.dtype.kind == "U") != (uniq.dtype.kind == "U"):
            raise ValueError(
                f"You are trying to merge on {lk.dtype} and {uniq.dtype} "
                f"columns for key {self.on!r}")
        if "f" not in (lk.dtype.kind, uniq.dtype.kind):
            return np.fromiter(map(self.index.__getitem__, lk.tolist()),
                               np.int64, len(lk))
        if not len(uniq):
            return np.full(len(lk), -1, np.int64)
        srt = np.argsort(uniq, kind="stable")  # NaN last
        p = np.minimum(np.searchsorted(uniq[srt], lk), len(uniq) - 1)
        found = uniq[srt][p]
        hit = (found == lk) | (np.isnan(lk) & np.isnan(found))
        return np.where(hit, srt[p], -1)

    def rows(self, left: Table):
        """(left rows, right rows) of the join's rows."""
        pos = self._codes(left[self.on])
        n_match = np.where(pos >= 0, self.counts[pos] if len(self.uniq)
                           else 0, 0)
        left_rows = np.repeat(np.arange(len(pos), dtype=np.int64), n_match)
        first = np.cumsum(n_match) - n_match
        j = (np.arange(len(left_rows), dtype=np.int64)
             - np.repeat(first, n_match))
        return left_rows, self.order[self.starts[pos[left_rows]] + j]

    def __call__(self, left: Table, rows=None) -> Table:
        left_rows, right_rows = self.rows(left) if rows is None else rows
        both = (set(left) & set(self.right)) - {self.on}
        out = {}
        for name, col in take(left, left_rows).items():
            out[name + "_x" if name in both else name] = col
        for name, col in take(self.right, right_rows).items():
            if name != self.on:
                out[name + "_y" if name in both else name] = col
        return out


def merge_inner(left: Table, right: Table, on: str) -> Table:
    """``left.merge(right, on=on, how="inner")``: see ``Join``."""
    return Join(right, on)(left)


def date_codes(values: np.ndarray) -> np.ndarray:
    """Sortable int codes of dates: ranks of the sorted distinct dates, a
    missing date above every real one (``sort_values``' NaN last)."""
    codes, uniq = factorize(values)
    missing = isna(uniq)
    rank = np.empty(len(uniq), np.int64)
    rank[np.flatnonzero(~missing)[np.argsort(uniq[~missing],
                                             kind="stable")]] = np.arange(
        int((~missing).sum()))
    rank[missing] = int((~missing).sum())
    return rank[codes]


def add_history_column(
    table: Table,
    user_col: str,
    item_col: str,
    out_col: str,
    max_len: int,
    date_col: Optional[str] = None,
) -> Table:
    """Per row: the user's previous ``max_len`` items, oldest to newest,
    without the row itself (no label leakage); rows ordered by ``date_col``
    (stable) within each user, missing dates last (trap p). Users and items
    take codes in order of first appearance, dates sorted codes; the windows
    come from ``build_history_state`` / ``history_flat_range``."""
    n = table_len(table)
    user_codes, _ = factorize(table[user_col])
    item_codes, item_uniques = factorize(table[item_col])
    dates = (date_codes(table[date_col]) if date_col is not None
             else np.zeros(n, np.int64))
    out = dict(table)
    if n == 0:
        out[out_col] = ListColumn(np.zeros(1, np.int64),
                                  np.zeros(0, np.int32),
                                  _token_strings(item_uniques))
        return out
    state = build_history_state(user_codes, dates, item_codes, max_len)
    offsets, flat = history_flat_range(state, 0, n)
    out[out_col] = ListColumn(offsets, flat, _token_strings(item_uniques))
    return out


def build_history_state(
    user_codes: np.ndarray,
    date_codes: np.ndarray,
    item_codes: np.ndarray,
    max_len: int,
) -> dict:
    """Vectorized history-window core over pre-coded arrays (the
    chunked ETL path feeds this with globally-consistent codes built
    incrementally across CSV chunks). One stable lexsort groups each
    user's rows in date order; cumulative group positions give every
    row's window into the sorted item sequence. O(N) ints, no
    strings."""
    n = len(user_codes)
    # stable: primary user, secondary date, ties keep original order —
    # within each user this is exactly sort_values(date, stable) +
    # groupby(user) encounter order
    perm = np.lexsort((date_codes, user_codes))
    inv_perm = np.empty(n, np.int64)
    inv_perm[perm] = np.arange(n)

    user_sorted = user_codes[perm]
    items_sorted = np.asarray(item_codes, np.int64)[perm]
    idx = np.arange(n, dtype=np.int64)
    starts = np.empty(n, bool)
    starts[0] = True
    np.not_equal(user_sorted[1:], user_sorted[:-1], out=starts[1:])
    group_start = np.maximum.accumulate(np.where(starts, idx, 0))
    lens_sorted = np.minimum(idx - group_start, max_len).astype(
        np.int64
    )
    return {
        "inv_perm": inv_perm,
        "items_sorted": items_sorted,
        "lens": lens_sorted[inv_perm],  # original row order
    }


def history_flat_range(state: dict, lo: int, hi: int):
    """Flat window item-codes for original rows [lo, hi): returns
    (offsets (hi-lo+1,) int64 starting at 0, flat int32). Emits
    windows directly in ORIGINAL row order: original row r sits at
    sorted position inv_perm[r], whose window is
    items_sorted[sp-L .. sp-1]. Per-range cost is O(rows*window) — the
    chunked writer attaches histories one chunk at a time without ever
    materializing the global flat vector."""
    inv_perm = state["inv_perm"]
    items_sorted = state["items_sorted"]
    lens = state["lens"][lo:hi]
    m = hi - lo
    offsets = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    row = np.repeat(np.arange(m, dtype=np.int64), lens)
    j = np.arange(total, dtype=np.int64) - offsets[:-1][row]
    src = inv_perm[lo + row] - lens[row] + j
    flat = items_sorted[src].astype(np.int32)
    return offsets, flat
