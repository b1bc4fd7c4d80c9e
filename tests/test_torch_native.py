"""The port's host library (``hm_retrieval_tpu_torch/native_ext.py``, built
from ``csrc/shardio.cpp`` and ``csrc/seqencode.cpp``) against the JAX
package's ``native_ext`` and against the port's plain paths.

The same numpy-seeded inputs go through the port's C++ encoders
(``NativeVocab``, ``NativeSeqVocab``, ``Feature.encode`` and
``encode_sequence``), the JAX package's native ones and the port's plain
versions (``Feature.encode_plain``, ``encode_sequence_plain``): U-, S- and
object-dtype tokens, fixed-width padding, all-empty vocabs and tokens
(width S1), non-ASCII tokens (UTF-8), non-str tokens read as ``str(tok)``
(``1``, ``1.0``, ``None``, NaN, with ``"nan"`` in the vocab), duplicated
vocab tokens (the last wins), every kind of sequence row, empty and all-OOV
inputs, and 20,000-token inputs on the threaded path at several thread
counts. The TFRecord functions give the JAX native functions' bytes and
offsets and the port's numpy versions', with 0, 1 and 5,000 records of 0 to
2 KiB, and raise as JAX's native scan on every kind of corruption.
``gather_rows`` equals ``src[idx]``. Two processes build into an empty
build directory at once and both load the library. Every comparison is
exact.
"""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hm_retrieval_tpu import native_ext as jne
from hm_retrieval_tpu.schema.features import Feature as JaxFeature
from hm_retrieval_tpu_torch import native_ext as ne
from hm_retrieval_tpu_torch.data import tfrecord_compat as tfc
from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.schema.features import Feature
from tests.test_torch_tfrecord import CORRUPTIONS, corrupt

ROOT = Path(__file__).resolve().parent.parent
NAN = float("nan")


def features(vocab, kind="categorical", max_len=None):
    spec = dict(name="x", kind=kind, family="query", embedding_size=4,
                vocab=vocab, max_len=max_len)
    return Feature(**spec), JaxFeature(**spec)


def ids(x):
    return np.asarray(x, np.int32).tolist()


# --- flat encodes (traps b and c) --------------------------------------------

def _ascii_case(rng):
    vocab = np.array([f"tok_{i}" for i in range(300)])
    return vocab, vocab[rng.integers(0, 300, 200)].tolist() + [
        "tok_300", "tok_", "", "tok_1 "]


FLAT_CASES = {
    # varying widths: the padding of the shorter tokens is dropped
    "ascii": _ascii_case,
    "unicode": lambda rng: (np.array(["", "héllo", "☃", "日本語", "a"]),
                            ["☃", "", "héllo", "nope", "日本語", "a", "é"]),
    # width 0 in numpy's bytes: both sides take S1
    "all_empty_vocab_and_tokens": lambda rng: (np.array([""]),
                                               ["", "", ""]),
    "all_empty_tokens": lambda rng: (np.array(["a", "b"]), ["", ""]),
    "duplicated_vocab_tokens": lambda rng: (np.array(["a", "b", "a", "c",
                                                      "b"]),
                                            ["a", "b", "c", "zzz"]),
    "all_oov": lambda rng: (np.array(["a", "b"]), ["c", "d", "aa", "B"]),
    "empty": lambda rng: (np.array(["a", "b"]), []),
}


def as_dtype(tokens, dtype):
    if dtype == "U":
        return np.array(tokens, dtype=str)
    if dtype == "S":
        return np.array([t.encode("utf-8") for t in tokens], dtype=np.bytes_)
    return np.array(tokens, dtype=object)


@pytest.mark.parametrize("dtype", ["U", "S", "O"])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_encodes_equal_jax_native_and_the_plain_path(case, dtype):
    vocab, tokens = FLAT_CASES[case](np.random.default_rng(len(case)))
    values = as_dtype(tokens, dtype)
    port, jax = features(vocab)
    if dtype == "S" and any(not t.isascii() for t in tokens):
        # numpy reads S tokens back to str as ASCII only: every path raises
        for encode in (port.encode_plain, port.encode, jax.encode):
            with pytest.raises(UnicodeDecodeError):
                encode(values)
        return
    want = ids(port.encode_plain(values))
    assert ids(port.encode(values)) == want
    assert ids(jax.encode(values)) == want
    as_str = np.asarray(values, dtype=str)
    assert ids(ne.NativeVocab(vocab).encode(as_str)) == want
    assert ids(jne.NativeVocab(vocab).encode(as_str)) == want
    assert ids(ne.NativeSeqVocab(vocab).encode_tokens(as_str.tolist())) == want
    assert ids(jne.NativeSeqVocab(vocab).encode_tokens(
        as_str.tolist())) == want
    if case == "all_oov":
        assert set(want) == {0}


def test_non_str_tokens_read_as_their_str():
    """An object token that is not a ``str`` is looked up as ``str(tok)``:
    1 -> "1", 1.0 -> "1.0", None -> "None", NaN -> "nan" (trap q puts
    "nan" in a vocab); numpy scalars and bools as well. Integer and float
    arrays are taken as str arrays."""
    vocab = np.array(["nan", "1", "1.0", "None", "x", "True", "2.5"])
    port, jax = features(vocab)
    tokens = np.array([NAN, 1, 1.0, None, "x", np.float64("nan"), "y",
                       True, np.int64(1), np.float32(2.5), np.str_("x")],
                      dtype=object)
    want = ids(port.encode_plain(tokens))
    assert want == [1, 2, 3, 4, 5, 1, 0, 6, 2, 7, 5]
    assert ids(port.encode(tokens)) == want == ids(jax.encode(tokens))
    assert ids(ne.NativeSeqVocab(vocab).encode_tokens(tokens)) == want
    for numeric in (np.array([1, 2, 1]), np.array([1.0, NAN, 2.5]),
                    [[1.0, 2.5], [NAN, 1.0]]):
        want = ids(port.encode_plain(numeric))
        assert ids(port.encode(numeric)) == want == ids(jax.encode(numeric))


# --- sequences ---------------------------------------------------------------

def sequence_rows():
    """Every kind of row: list, tuple, object and U arrays, a bare str (its
    characters), None and NaN (all pad), empty, non-str tokens, rows past
    max_len (the last tokens kept)."""
    long = [f"a{i % 7}" for i in range(40)]
    return [["a1", "a2"], ("a2", "zz"),
            np.array(["a1", "a1", "a2"], dtype=object), np.array(["a3", "a1"]),
            "a1", None, NAN, [], [1, 1.0, None, NAN], long, tuple(long[:5]),
            ["日本", "a1"], np.float64("nan")]


def test_sequences_equal_jax_native_and_the_plain_path():
    vocab = np.array(["a1", "a2", "a", "1", "1.0", "None", "nan", "a3",
                      "a0", "a4", "a5", "a6", "日本"])
    port, jax = features(vocab, "sequence", max_len=4)
    rows = sequence_rows()
    want = port.encode_sequence_plain(rows)
    assert want.shape == (len(rows), 4) and want.dtype == np.int32
    assert want[4].tolist() == [3, 4, 0, 0]  # "a1" as "a", "1"
    assert want[5].tolist() == want[6].tolist() == [0, 0, 0, 0]
    assert np.array_equal(port.encode_sequence(rows), want)
    assert np.array_equal(jax.encode_sequence(rows), want)
    assert np.array_equal(ne.NativeSeqVocab(vocab).encode_sequences(rows, 4),
                          want)
    assert np.array_equal(jne.NativeSeqVocab(vocab).encode_sequences(rows, 4),
                          want)
    # the last max_len tokens of a long row
    long = [f"a{i % 7}" for i in range(40)]
    lookup = {t: i + 1 for i, t in enumerate(vocab.tolist())}
    assert want[9].tolist() == [lookup[t] for t in long[-4:]]


@pytest.mark.parametrize("rows", [[], [None, NAN, []], [["q", "r"]] * 3],
                         ids=["no_rows", "all_pad", "all_oov"])
def test_empty_and_all_oov_sequences(rows):
    port, jax = features(np.array(["a", "b"]), "sequence", max_len=3)
    want = port.encode_sequence_plain(rows)
    assert want.shape == (len(rows), 3) and not want.any()
    assert np.array_equal(port.encode_sequence(rows), want)
    assert np.array_equal(jax.encode_sequence(rows), want)


def test_one_encoder_a_vocab_object_and_copies_build_their_own():
    port, _ = features(np.array(["a", "b"]))
    assert ids(port.encode(np.array(["b", "a"]))) == [2, 1]
    first = port._native
    port.encode(np.array(["a"]))
    assert port._native is first
    port.vocab = np.array(["b", "a"])
    assert ids(port.encode(np.array(["b", "a"]))) == [1, 2]
    assert port._native is not first
    twin = copy.deepcopy(port)
    assert twin._native is None
    assert ids(twin.encode(np.array(["a", "c"]))) == [2, 0]


# --- the threaded paths (trap d) ---------------------------------------------

def test_twenty_thousand_tokens_at_every_thread_count():
    """Inputs past the 4096-token threshold split across threads; the ids
    do not depend on how many. 20,000 sequence rows cross the extension's
    16,384-row chunk."""
    rng = np.random.default_rng(7)
    vocab = np.array([f"v{i:05d}" for i in range(5000)])
    tokens = np.array([f"v{i:05d}" for i in rng.integers(0, 6000, 20_000)])
    port, jax = features(vocab)
    want = ids(port.encode_plain(tokens))
    assert ids(port.encode(tokens)) == want == ids(jax.encode(tokens))
    assert ids(port.encode(tokens.astype(object))) == want
    seq, fixed = ne.NativeSeqVocab(vocab), ne.NativeVocab(vocab)
    for n in (1, 2, 3, 7, 0):
        assert ids(seq.encode_tokens(tokens.tolist(), n_threads=n)) == want
        assert ids(fixed.encode(tokens, n_threads=n)) == want
    lens = rng.integers(0, 30, 20_000)
    starts = np.cumsum(lens) - lens
    flat = np.array([f"v{i:05d}" for i in rng.integers(0, 6000, lens.sum())],
                    dtype=object)
    rows = [flat[s:s + n].tolist() for s, n in zip(starts, lens)]
    sport, sjax = features(vocab, "sequence", max_len=16)
    want = sport.encode_sequence_plain(rows)
    assert np.array_equal(sport.encode_sequence(rows), want)
    assert np.array_equal(sjax.encode_sequence(rows), want)
    for n in (1, 3, 0):
        assert np.array_equal(seq.encode_sequences(rows, 16, n_threads=n),
                              want)


# --- TFRecord framing, scan and CRC ------------------------------------------

def random_payloads(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 2049, n)]


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_tfrecord_functions_equal_jax_native_and_numpy(n):
    payloads = random_payloads(n, n)
    lengths = np.array([len(p) for p in payloads], np.int64)
    offsets = np.zeros(n + 1, np.uint64)
    offsets[1:] = np.cumsum(lengths)
    blob = b"".join(payloads)
    want = tfc._frame(payloads)
    assert jne.tfrecord_frame(blob, offsets) == want
    for threads in (1, 2, 7, 0):
        assert ne.tfrecord_frame(blob, offsets, threads) == want
    got_off, got_len = ne.tfrecord_scan(want)
    jax_off, jax_len = jne.tfrecord_scan(want)
    starts, plain_len, error = tfc._scan("f", want, True)
    assert error is None
    assert got_off.tolist() == jax_off.tolist() == starts.tolist()
    assert got_len.tolist() == jax_len.tolist() == plain_len.tolist()
    assert got_off.dtype == got_len.dtype == np.uint64
    assert ne.tfrecord_scan(want, verify=False)[0].tolist() == starts.tolist()
    plain = tfc._masked_crcs(np.frombuffer(blob, np.uint8),
                             np.cumsum(lengths) - lengths, lengths)
    crcs = [ne.tfrecord_masked_crc(p) for p in payloads]
    assert crcs == [jne.tfrecord_masked_crc(p) for p in payloads]
    assert crcs == plain.tolist()


@pytest.mark.parametrize("what", CORRUPTIONS)
@pytest.mark.parametrize("verify", [True, False])
def test_scan_raises_as_jax_native_scan(what, verify):
    """Each corruption of ``test_torch_tfrecord.corrupt``: the port's scan
    raises where JAX's native scan raises, with its message, or returns
    its offsets; the truncations raise without ``verify`` too."""
    payloads = [b"a" * 13, bytes(range(7)), b"\xfe" * 20]
    raw = corrupt(tfc._frame(payloads), what)

    def scan(fn):
        try:
            off, ln = fn(raw, verify=verify)
        except ValueError as exc:
            return str(exc)
        return off.tolist(), ln.tolist()

    got = scan(ne.tfrecord_scan)
    assert got == scan(jne.tfrecord_scan)
    if what.startswith("truncated") or what == "length":
        assert isinstance(got, str)
    if not verify and what in ("length_crc", "data_crc", "trailer"):
        assert got == ([12, 41, 64], [13, 7, 20])


def test_frame_refuses_offsets_that_do_not_match_the_blob():
    with pytest.raises(ValueError, match="offsets"):
        ne.tfrecord_frame(b"abc", np.array([0, 2], np.uint64))
    with pytest.raises(ValueError, match="offsets"):
        ne.tfrecord_frame(b"abc", np.array([0, 2, 1, 3], np.uint64))
    assert ne.tfrecord_frame(b"", np.array([0], np.uint64)) == b""


# --- gather_rows ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (1000, 16), (6000, 3)])
def test_gather_rows_equals_numpy(shape):
    rng = np.random.default_rng(len(shape))
    src = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, shape[0], 5000).astype(np.int32)
    for threads in (1, 3, 0):
        got = ne.gather_rows(src, idx, threads)
        assert got.dtype == src.dtype and np.array_equal(got, src[idx])
    assert np.array_equal(ne.gather_rows(src, idx), jne.gather_rows(src, idx))
    assert ne.gather_rows(src, idx[:0]).shape == (0,) + shape[1:]
    with pytest.raises(IndexError):
        ne.gather_rows(src, np.array([shape[0]]))
    with pytest.raises(IndexError):
        ne.gather_rows(src, np.array([-1]))


# --- the build -------------------------------------------------------------------

def test_two_processes_build_into_an_empty_directory_at_once(tmp_path):
    """Both processes compile every host source into the same empty
    ``build/`` at once, each publishing with ``os.replace``; both load the
    library and encode, and nothing half-written is left."""
    build = tmp_path / "build"
    code = f"""
import sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
from hm_retrieval_tpu_torch.ops import _build
_build.BUILD_DIR = Path({str(build)!r})
from hm_retrieval_tpu_torch import native_ext
print(native_ext.NativeSeqVocab(["a", "b"]).encode_tokens(["b", "x", "a"])
      .tolist(), native_ext.tfrecord_masked_crc(b"123456789"))
"""
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["[2,", "0,", "1]",
                               str(tfc._masked_crcs(
                                   np.frombuffer(b"123456789", np.uint8),
                                   [0], [9])[0])]
    names = sorted(p.name for p in build.iterdir())
    assert names == sorted(
        _build.host_lib_path(n).name for n in _build.host_sources())
