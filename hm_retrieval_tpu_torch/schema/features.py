"""Feature specs with frequency-ordered vocabularies and int-id encoding.

Own copy of ``hm_retrieval_tpu/schema/features.py`` for the serving edge:
the same encoding contract and the same ``to_dict``/``from_dict`` payload,

    id 0                -> OOV (and the sequence pad id)
    id i+1 (1..V)       -> vocab[i], vocab frequency-ordered

so a schema saved by either package loads in the other. Vocabularies and
statistics are built from the port's tables (``etl/transformations.py``)
with numpy. ``encode`` and ``encode_sequence`` run the host library's C++
encoder (``native_ext.NativeSeqVocab``, one a vocab object); the
pure-Python dictionary paths stay as their plain versions,
``encode_plain`` and ``encode_sequence_plain``, which give the same ids.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from hm_retrieval_tpu_torch import native_ext
from hm_retrieval_tpu_torch.etl.transformations import Lookup, factorize

def present_strings(values) -> np.ndarray:
    """``Series.astype(str)`` of a column's present values: pandas 3 keeps a
    missing value (NaN, or ``""`` in a str column) missing, and
    ``value_counts`` drops it. A float reads ``"1.0"``, an int ``"12"``."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    elif values.dtype.kind == "U":
        values = values[values != ""]
    return values.astype(str)


def value_counts(values):
    """(tokens, counts) of ``Series.astype(str).value_counts()``: the
    distinct strings of the present values, count descending, ties in order
    of first appearance (trap j; ``np.unique`` alone orders ties by
    value)."""
    codes, uniq = factorize(present_strings(values))
    counts = np.bincount(codes, minlength=len(uniq))
    order = np.argsort(-counts, kind="stable")
    return uniq[order], counts[order]


class FeatureFamily(str, enum.Enum):
    """Which tower a feature feeds."""

    QUERY = "query"
    CANDIDATE = "candidate"


class FeatureKind(str, enum.Enum):
    """Categorical (string tokens, id-encoded), numeric (float32
    passthrough) or sequence (a fixed-length window of categorical
    tokens, e.g. last-N purchase history)."""

    CATEGORICAL = "categorical"
    NUMERIC = "numeric"
    SEQUENCE = "sequence"


@dataclass
class Feature:
    """One model input feature (fields as in the JAX package)."""

    name: str
    kind: FeatureKind
    family: FeatureFamily
    embedding_size: Optional[int] = None
    vocab: Optional[np.ndarray] = None  # frequency-ordered string tokens
    max_vocab_size: Optional[int] = None
    # Numeric-only standardization with train statistics.
    standardize: bool = False
    mean: Optional[float] = None
    std: Optional[float] = None
    # Sequence-only: window length (the LAST max_len tokens are kept,
    # right-padded with id 0, which pooling masks out).
    max_len: Optional[int] = None
    # Sequence-only: feature whose vocab this one shares (wired by Schema).
    shared_vocab_with: Optional[str] = None
    # Sequence-only: "mean" (masked mean) or "attention" pooling.
    pooling: str = "mean"
    # token -> id and id -> token tables, built lazily (not serialized)
    _token_to_id: Optional[Dict[str, int]] = field(
        default=None, repr=False, compare=False
    )
    _decode_table: object = field(default=None, repr=False, compare=False)
    _decode_table_for: object = field(
        default=None, repr=False, compare=False
    )
    # the native encoder and the vocab object it was built from
    _native: object = field(default=None, repr=False, compare=False)
    _native_for: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self.kind = FeatureKind(self.kind)
        self.family = FeatureFamily(self.family)
        if self.kind in (FeatureKind.CATEGORICAL, FeatureKind.SEQUENCE):
            if self.embedding_size is None or self.embedding_size <= 0:
                raise ValueError(
                    f"feature {self.name!r} requires a positive "
                    "embedding_size"
                )
        else:
            if self.embedding_size is not None:
                raise ValueError(
                    f"numeric feature {self.name!r} cannot have an "
                    "embedding_size"
                )
            if self.vocab is not None or self.max_vocab_size is not None:
                raise ValueError(
                    f"numeric feature {self.name!r} cannot have a vocab"
                )
        if self.standardize and self.kind != FeatureKind.NUMERIC:
            raise ValueError(
                f"standardize only applies to numeric features "
                f"({self.name!r})"
            )
        if self.kind == FeatureKind.SEQUENCE:
            if self.max_len is None or self.max_len <= 0:
                raise ValueError(
                    f"sequence feature {self.name!r} requires a "
                    "positive max_len"
                )
        elif self.max_len is not None:
            raise ValueError(
                f"max_len only applies to sequence features ({self.name!r})"
            )
        if self.pooling not in ("mean", "attention"):
            raise ValueError(
                f"unknown pooling {self.pooling!r} for {self.name!r} "
                "(expected 'mean' or 'attention')"
            )
        if self.pooling != "mean" and self.kind != FeatureKind.SEQUENCE:
            raise ValueError(
                f"pooling only applies to sequence features ({self.name!r})"
            )
        if self.vocab is not None:
            self.vocab = np.asarray(self.vocab, dtype=str)

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    @property
    def has_vocab(self) -> bool:
        return self.vocab is not None

    @property
    def num_embeddings(self) -> int:
        """Table rows: vocab size + 1 OOV row."""
        if self.vocab is None:
            raise ValueError(f"feature {self.name!r} has no vocab yet")
        return len(self.vocab) + 1

    def build_vocab_from_dataframe(self, table) -> None:
        """Frequency-ordered vocab of the table's column, truncated to the
        ``max_vocab_size`` most frequent tokens; missing values are never in
        it (ref: pkg/schema/features.py:106-127)."""
        if self.kind != FeatureKind.CATEGORICAL:
            raise ValueError(f"cannot build vocab for numeric {self.name!r}")
        tokens, _ = value_counts(table[self.name])
        if self.max_vocab_size is not None:
            tokens = tokens[: self.max_vocab_size]
        self.vocab = tokens
        self._token_to_id = None

    def build_stats_from_dataframe(self, table) -> None:
        """Train-split mean/std for numeric standardization: float64
        ``nanmean`` / ``nanstd`` (a zero std reads 1.0)."""
        if self.kind != FeatureKind.NUMERIC:
            raise ValueError(f"{self.name!r} is not numeric")
        col = np.asarray(table[self.name], dtype=np.float64)
        self.mean = float(np.nanmean(col))
        self.std = float(np.nanstd(col)) or 1.0

    def transform_numeric(self, values: np.ndarray) -> np.ndarray:
        """float32 passthrough, standardized when configured; NaN -> 0.0
        after standardization."""
        out = np.asarray(values, dtype=np.float32)
        if self.standardize:
            if self.mean is None or self.std is None:
                raise ValueError(f"numeric stats for {self.name!r} not built")
            out = (out - np.float32(self.mean)) / np.float32(self.std)
        return np.nan_to_num(out, nan=0.0)

    def _lookup(self) -> Dict[str, int]:
        if self._token_to_id is None:
            if self.vocab is None:
                raise ValueError(f"feature {self.name!r} has no vocab")
            self._token_to_id = Lookup(
                ((tok, i + 1) for i, tok in enumerate(self.vocab.tolist())),
                missing=0)
        return self._token_to_id

    def _native_encoder(self) -> "native_ext.NativeSeqVocab":
        """The C++ encoder of this vocab object, built once (a new vocab
        array, a new encoder)."""
        if self.vocab is None:
            raise ValueError(f"feature {self.name!r} has no vocab")
        if self._native is None or self._native_for is not self.vocab:
            self._native = native_ext.NativeSeqVocab(self.vocab)
            self._native_for = self.vocab
        return self._native

    def __getstate__(self):
        # the encoder holds a C pointer: a copy or a pickle builds its own
        return {**self.__dict__, "_native": None, "_native_for": None}

    def encode(self, values) -> np.ndarray:
        """String tokens -> int32 ids (0 = OOV), through the C++ encoder.
        An object array's tokens are read in place (a token that is not a
        ``str`` as ``str(tok)``); any other input is first taken as a str
        array and its ``tolist()`` read, the faster of the library's two
        encoders on the card's host for U and S input (``PERF.md``)."""
        raw = np.asarray(values)
        if raw.dtype.kind == "O":
            return self._native_encoder().encode_tokens(raw.ravel())
        arr = np.asarray(values, dtype=str).ravel()
        return self._native_encoder().encode_tokens(arr.tolist())

    def encode_plain(self, values) -> np.ndarray:
        """``encode``'s plain version: one dictionary lookup a token."""
        arr = np.asarray(values, dtype=str).ravel()
        return np.fromiter(map(self._lookup().__getitem__, arr.tolist()),
                           dtype=np.int32, count=arr.size)

    def encode_sequence(self, values) -> np.ndarray:
        """Iterable of token lists -> (B, max_len) int32, keeping the LAST
        ``max_len`` tokens, right-padded with 0, through the C++ encoder.
        Missing cells (None or float NaN) encode as all-pad rows; a bare
        ``str`` cell is read as its characters."""
        if self.kind != FeatureKind.SEQUENCE:
            raise ValueError(f"{self.name!r} is not a sequence feature")
        return self._native_encoder().encode_sequences(values, self.max_len)

    def encode_sequence_plain(self, values) -> np.ndarray:
        """``encode_sequence``'s plain version: rows cut in Python, then one
        ``encode_plain`` of every token."""
        if self.kind != FeatureKind.SEQUENCE:
            raise ValueError(f"{self.name!r} is not a sequence feature")
        n = len(values)
        out = np.zeros((n, self.max_len), np.int32)
        trunc = []
        for toks in values:
            if toks is None or (isinstance(toks, float) and np.isnan(toks)):
                trunc.append(())
            else:
                trunc.append(tuple(toks)[-self.max_len:])
        lens = np.fromiter((len(t) for t in trunc), np.int64, count=n)
        total = int(lens.sum())
        if total == 0:
            return out
        flat = np.fromiter(
            itertools.chain.from_iterable(trunc), dtype=object, count=total
        )
        ids = self.encode_plain(flat)
        row_idx = np.repeat(np.arange(n), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        col_idx = np.arange(total) - np.repeat(starts, lens)
        out[row_idx, col_idx] = ids
        return out

    def encode_sequence_ids(
        self, flat_ids: np.ndarray, offsets: np.ndarray
    ) -> np.ndarray:
        """Pre-encoded flat token ids + (B+1,) row offsets -> (B, max_len)
        int32 windows: the last ``max_len`` tokens per row, right-padded
        with 0, as ``encode_sequence`` after a flat ``encode``."""
        if self.kind != FeatureKind.SEQUENCE:
            raise ValueError(f"{self.name!r} is not a sequence feature")
        offsets = np.asarray(offsets, np.int64)
        n = len(offsets) - 1
        out = np.zeros((n, self.max_len), np.int32)
        lens = np.minimum(offsets[1:] - offsets[:-1], self.max_len)
        total = int(lens.sum())
        if total == 0:
            return out
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        starts = np.cumsum(lens) - lens
        j = np.arange(total, dtype=np.int64) - starts[row]
        src = offsets[1:][row] - lens[row] + j
        out[row, j] = np.asarray(flat_ids, np.int32)[src]
        return out

    def decode(self, ids: np.ndarray) -> np.ndarray:
        """Int ids -> string tokens; id 0 (and out-of-range) -> '<OOV>'."""
        if self.vocab is None:
            raise ValueError(f"feature {self.name!r} has no vocab")
        ids = np.asarray(ids)
        if self._decode_table is None or self._decode_table_for is not self.vocab:
            self._decode_table = np.concatenate(
                [np.array(["<OOV>"]), self.vocab]
            )
            self._decode_table_for = self.vocab
        padded = self._decode_table
        safe = np.where((ids >= 0) & (ids < len(padded)), ids, 0)
        return padded[safe]

    # ------------------------------------------------------------------
    # Serialization (vocab stored separately in an npz, see schema.py)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind.value,
            "family": self.family.value,
            "embedding_size": self.embedding_size,
            "max_vocab_size": self.max_vocab_size,
            "has_vocab": self.has_vocab,
            "standardize": self.standardize,
            "mean": self.mean,
            "std": self.std,
            "max_len": self.max_len,
            "shared_vocab_with": self.shared_vocab_with,
            "pooling": self.pooling,
        }

    @classmethod
    def from_dict(
        cls, payload: dict, vocab: Optional[np.ndarray] = None
    ) -> "Feature":
        return cls(
            name=payload["name"],
            kind=FeatureKind(payload["kind"]),
            family=FeatureFamily(payload["family"]),
            embedding_size=payload.get("embedding_size"),
            vocab=vocab,
            max_vocab_size=payload.get("max_vocab_size"),
            standardize=payload.get("standardize", False),
            mean=payload.get("mean"),
            std=payload.get("std"),
            max_len=payload.get("max_len"),
            shared_vocab_with=payload.get("shared_vocab_with"),
            pooling=payload.get("pooling", "mean"),
        )
