"""ETL primitives: date filtering and table IO, without pandas.

Counterpart of ``load_dataframe`` and ``date_filter`` in the JAX package's
``etl/transformations.py``, the two functions the popularity baseline reads.
A table here is a dict of column name -> 1-D numpy array, so the baseline
runs where pandas is not installed. The column types are those
``pd.read_csv`` gives for the columns the baseline reads:

- a column whose every value parses as an integer reads as int64, so
  ``"0108775015"`` becomes 108775015;
- a column that pandas would read as float or bool, or that has an empty
  value, raises ``ValueError`` naming it, rather than guessing;
- any other column is a string column, its values as written.

The rest of the JAX module (the history and feature columns of the ETL
stage) waits for the port's ETL stages, which will import pandas inside
those functions only.
"""

from __future__ import annotations

import csv
import logging
import re
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

Table = Dict[str, np.ndarray]

_INT = re.compile(r"\s*[+-]?\d+\s*")
_BOOL = {"true", "false"}


def _is_float(value: str) -> bool:
    try:
        float(value)
    except ValueError:
        return False
    return True


def _typed_column(name: str, values: Sequence[str]) -> np.ndarray:
    """One CSV column as ``pd.read_csv`` would type it: int64 or str."""
    if any(v == "" for v in values):
        raise ValueError(
            f"column {name!r} has an empty value, which pandas reads as NaN"
        )
    if values and all(_INT.fullmatch(v) for v in values):
        ints = [int(v) for v in values]
        if min(ints) < -(2**63) or max(ints) >= 2**63:
            raise ValueError(f"column {name!r} overflows int64")
        return np.asarray(ints, dtype=np.int64)
    if values and all(_is_float(v) for v in values):
        raise ValueError(f"column {name!r} would read as float")
    if values and all(v.strip().lower() in _BOOL for v in values):
        raise ValueError(f"column {name!r} would read as bool")
    return np.asarray(values, dtype=str)


def _read_csv(filepath: str, columns: Optional[Sequence[str]]) -> Table:
    with open(filepath, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        wanted = list(header) if columns is None else list(columns)
        missing = [c for c in wanted if c not in header]
        if missing:
            raise ValueError(f"columns {missing} not in {filepath}")
        pos = [header.index(c) for c in wanted]
        cols = [[] for _ in wanted]
        for row in reader:
            if not row:  # a blank line, which pandas skips
                continue
            for out, p in zip(cols, pos):
                out.append(row[p])
    return {c: _typed_column(c, v) for c, v in zip(wanted, cols)}


def _read_parquet(filepath: str, columns: Optional[Sequence[str]]) -> Table:
    import pyarrow.parquet as pq  # raises ImportError where it is missing

    tbl = pq.read_table(filepath, columns=list(columns) if columns else None)
    return {
        name: tbl.column(name).to_numpy(zero_copy_only=False)
        for name in tbl.column_names
    }


def load_dataframe(
    filepath: str, columns: Optional[Sequence[str]] = None
) -> Table:
    """CSV or parquet by extension (ref: transformations.py:44-64): a dict
    of column -> 1-D numpy array, in ``columns`` order when given."""
    logger.info("Loading table from %s", filepath)
    if filepath.endswith(".parquet"):
        table = _read_parquet(filepath, columns)
    else:
        table = _read_csv(filepath, columns)
    n = len(next(iter(table.values()))) if table else 0
    logger.info("Loaded %d rows from %s", n, filepath)
    return table


def date_filter(
    table: Table, date_column: str, start_date: str, end_date: str
) -> Table:
    """Rows with start_date <= table[date_column] <= end_date, inclusive at
    both ends, comparing the column as it was read (ref:
    pkg/etl/transformations.py:9-41)."""
    col = table[date_column]
    mask = (col >= start_date) & (col <= end_date)
    return {name: values[mask] for name, values in table.items()}
