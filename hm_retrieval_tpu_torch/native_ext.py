"""The port's host library: token encoders, a row gather and the TFRecord
container's CRC, framing and scan, in C++ on the card's host.

Two sources under ``csrc/``, built with ``g++`` into ``build/`` on first use
by ``ops/_build.py``:

* ``shardio.cpp``, a plain-C library bound here with ``ctypes``:
  ``NativeVocab`` (tokens as fixed-width byte matrices, a hash map, lookups
  across threads), ``gather_rows``, ``tfrecord_masked_crc`` (slice-by-8
  CRC32C), ``tfrecord_scan`` and ``tfrecord_frame``;
* ``seqencode.cpp``, the CPython extension ``_seqencode``: ``NativeSeqVocab``
  reads Python ``str`` tokens in place and looks them up in a flat FNV-1a
  table with the GIL released, across threads.

Signatures and results are those of the JAX package's ``native_ext``, except
that nothing answers None: a function returns its result or raises (a
missing ``g++`` or a failed build raises ``RuntimeError``). The plain
versions stay in their modules: ``Feature.encode_plain`` and
``encode_sequence_plain`` (``schema/features.py``); ``_masked_crcs``,
``_scan`` and ``_frame`` (``data/tfrecord_compat.py``).

Every result is independent of the thread count (``n_threads`` <= 0 means
the host's hardware threads): each thread writes its own output slots.
``CALLS`` counts the calls into the library by function, so that a run can
show its main path went through it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np

from hm_retrieval_tpu_torch.ops import _build

_P_U64 = ctypes.POINTER(ctypes.c_uint64)
_P_I32 = ctypes.POINTER(ctypes.c_int32)
# (restype, argtypes) of the functions of shardio.cpp called here (its
# offset-buffer vocab_create / vocab_encode have no caller)
_SHARDIO = {
    "vocab_destroy": (None, [ctypes.c_void_p]),
    "vocab_size": (ctypes.c_uint32, [ctypes.c_void_p]),
    "vocab_create_fixed": (ctypes.c_void_p,
                           [ctypes.c_char_p, ctypes.c_uint64,
                            ctypes.c_uint32]),
    "vocab_encode_fixed": (None, [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64, _P_I32,
                                  ctypes.c_int]),
    "gather_rows": (None, [ctypes.c_void_p, ctypes.c_uint64, _P_I32,
                           ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]),
    "tfrecord_masked_crc": (ctypes.c_uint32,
                            [ctypes.c_char_p, ctypes.c_uint64]),
    "tfrecord_scan": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_int, _P_U64, _P_U64,
                                       ctypes.c_uint64]),
    "tfrecord_frame": (None, [ctypes.c_char_p, _P_U64, ctypes.c_uint64,
                              ctypes.c_void_p, ctypes.c_int]),
}
_bound_lock = threading.Lock()
CALLS: Dict[str, int] = dict.fromkeys(
    ("encode_tokens", "encode_sequences", "vocab_encode_fixed",
     "tfrecord_masked_crc", "tfrecord_scan", "tfrecord_frame",
     "gather_rows"), 0)


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def shardio() -> ctypes.CDLL:
    """``csrc/shardio.cpp``'s library, built if needed, every function's
    types declared."""
    lib = _build.load_host("shardio")
    with _bound_lock:
        if not getattr(lib, "_port_bound", False):
            for name, (restype, argtypes) in _SHARDIO.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            lib._port_bound = True
    return lib


def seqencode():
    """``csrc/seqencode.cpp``'s extension module, built if needed."""
    return _build.load_host("seqencode")


def _to_fixed_bytes(tokens: np.ndarray) -> np.ndarray:
    """str array -> contiguous fixed-width byte matrix (S dtype): ASCII
    through ``astype``, otherwise UTF-8; an all-empty array takes S1."""
    try:
        fixed = tokens.astype(np.bytes_)
    except UnicodeEncodeError:
        fixed = np.char.encode(tokens, "utf-8")
    if fixed.dtype.itemsize == 0:
        fixed = fixed.astype("S1")
    return np.ascontiguousarray(fixed)


class NativeSeqVocab:
    """token -> id map of the C extension; id 0 = OOV, ids 1..V in vocab
    order, the last of duplicated tokens winning. Lookups read Python
    ``str`` objects in place; any other token is looked up as ``str(tok)``."""

    def __init__(self, vocab: np.ndarray):
        self._mod = seqencode()
        fixed = _to_fixed_bytes(np.asarray(vocab, dtype=str))
        self._capsule = self._mod.vocab_create(
            fixed.tobytes(), fixed.dtype.itemsize, len(fixed))

    def encode_sequences(self, rows, max_len: int,
                         n_threads: int = 0) -> np.ndarray:
        """Sequence of per-row token sequences -> (B, max_len) int32,
        keeping the LAST max_len tokens, right-padded 0; a row that is None
        or a float NaN is all pad, a bare ``str`` row its characters."""
        out = np.zeros((len(rows), max_len), np.int32)
        if len(rows):
            self._mod.encode_sequences(self._capsule, rows, max_len, out,
                                       n_threads)
            CALLS["encode_sequences"] += 1
        return out

    def encode_tokens(self, tokens, n_threads: int = 0) -> np.ndarray:
        """Flat sequence of tokens -> (N,) int32 ids."""
        out = np.zeros(len(tokens), np.int32)
        if len(tokens):
            self._mod.encode_tokens(self._capsule, tokens, out, n_threads)
            CALLS["encode_tokens"] += 1
        return out


class NativeVocab:
    """token -> id map of ``shardio.cpp``'s hash map; id 0 = OOV.

    Tokens cross as fixed-width byte matrices (S dtype) and the NUL padding
    is dropped, so tokens with embedded NULs are out of scope."""

    def __init__(self, vocab: np.ndarray):
        self._lib = shardio()
        fixed = _to_fixed_bytes(np.asarray(vocab, dtype=str))
        self._handle = self._lib.vocab_create_fixed(
            fixed.ctypes.data_as(ctypes.c_char_p), fixed.dtype.itemsize,
            len(fixed))

    def encode(self, tokens: np.ndarray, n_threads: int = 0) -> np.ndarray:
        tokens = np.asarray(tokens, dtype=str).ravel()
        fixed = _to_fixed_bytes(tokens)
        out = np.empty(len(tokens), np.int32)
        if len(tokens):
            self._lib.vocab_encode_fixed(
                self._handle, fixed.ctypes.data_as(ctypes.c_char_p),
                fixed.dtype.itemsize, len(tokens),
                out.ctypes.data_as(_P_I32), n_threads)
            CALLS["vocab_encode_fixed"] += 1
        return out

    def __len__(self):
        return int(self._lib.vocab_size(self._handle))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.vocab_destroy(handle)
            self._handle = None


def tfrecord_masked_crc(data: bytes) -> int:
    """Masked CRC32C of ``data`` (the TFRecord framing checksum)."""
    data = bytes(data)
    crc = int(shardio().tfrecord_masked_crc(data, len(data)))
    CALLS["tfrecord_masked_crc"] += 1
    return crc


def tfrecord_scan(buf: bytes, verify: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, lengths), uint64, of the record payloads of a whole
    TFRecord file image. The whole image is scanned before anything is
    returned: a truncated record, or with ``verify`` a bad length or data
    CRC, raises ``ValueError("corrupt TFRecord data at byte N")``, N the
    faulty record's offset."""
    buf = bytes(buf)
    # every record takes at least its 16 framing bytes
    cap = max(1, len(buf) // 16)
    offsets = np.empty(cap, np.uint64)
    lengths = np.empty(cap, np.uint64)
    n = shardio().tfrecord_scan(buf, len(buf), 1 if verify else 0,
                                offsets.ctypes.data_as(_P_U64),
                                lengths.ctypes.data_as(_P_U64), cap)
    CALLS["tfrecord_scan"] += 1
    if n < 0:
        raise ValueError(f"corrupt TFRecord data at byte {-n - 1}")
    return offsets[:n], lengths[:n]


def tfrecord_frame(payloads_blob: bytes, offsets: np.ndarray,
                   n_threads: int = 0) -> bytes:
    """The TFRecord file image of the records concatenated in
    ``payloads_blob``, their boundaries in ``offsets`` ((m + 1,) uint64)."""
    payloads_blob = bytes(payloads_blob)
    offsets = np.ascontiguousarray(offsets, np.uint64)
    m = len(offsets) - 1
    if (m < 0 or offsets[0] != 0 or offsets[-1] != len(payloads_blob)
            or (offsets[1:] < offsets[:-1]).any()):
        raise ValueError("offsets must rise from 0 to the blob's length")
    out = ctypes.create_string_buffer(len(payloads_blob) + 16 * m)
    shardio().tfrecord_frame(payloads_blob, offsets.ctypes.data_as(_P_U64),
                             m, out, n_threads)
    CALLS["tfrecord_frame"] += 1
    return out.raw


def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """``src[idx]`` of a 1-D or 2-D array, rows copied across threads;
    an index outside ``[0, len(src))`` raises ``IndexError``."""
    lib = shardio()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int32)
    if src.ndim not in (1, 2) or idx.ndim != 1:
        raise ValueError("gather_rows takes a 1-D or 2-D src and 1-D idx")
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= len(src)):
        raise IndexError("gather_rows: an index is out of range")
    row_shape = src.shape[1:]
    out = np.empty((len(idx),) + row_shape, src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(row_shape or (1,)))
    lib.gather_rows(src.ctypes.data_as(ctypes.c_void_p), row_bytes,
                    idx.ctypes.data_as(_P_I32), len(idx),
                    out.ctypes.data_as(ctypes.c_void_p), n_threads)
    CALLS["gather_rows"] += 1
    return out
