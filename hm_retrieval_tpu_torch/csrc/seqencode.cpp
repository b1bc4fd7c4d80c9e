// CPython extension of the port: token -> id encoding that reads Python str
// objects in place. Built with g++ (and Python's headers) into build/ by
// hm_retrieval_tpu_torch/ops/_build.py and loaded as module _seqencode by
// hm_retrieval_tpu_torch/native_ext.py. No GPU code: it runs on the card's
// host, under schema/features.py's Feature.encode and encode_sequence.
//
// Why a C extension and not ctypes (like shardio.cpp): the inputs are
// Python lists of Python str tokens. Any numpy route pays one full
// materialization per token (object -> U-dtype or S-dtype copies); here
// tokens are read IN PLACE from the compact-unicode representation
// (PyUnicode_1BYTE_DATA for ASCII, PyUnicode_AsUTF8AndSize otherwise),
// batched into (ptr, len, out_slot) triples, and looked up in an
// open-addressing FNV-1a hash table with the GIL RELEASED and the work
// split across threads. Rows are processed in bounded chunks so peak
// side-buffer memory stays ~tens of MB regardless of input size.
//
// Exposed functions (module _seqencode):
//   vocab_create(fixed_bytes, width, n)       -> capsule  (ids are 1..n)
//   encode_sequences(capsule, rows, max_len, out_memoryview[, n_threads])
//       rows: sequence of per-row token sequences (list/tuple/ndarray/
//       str/None/NaN); keeps the LAST max_len tokens, right-padded 0.
//       Matches Feature.encode_sequence_plain exactly (str(tok) lookup,
//       0 = OOV/pad).
//   encode_tokens(capsule, tokens, out_memoryview[, n_threads])
//       flat 1-D variant (scalar categorical columns).
// n_threads <= 0 (the default) means std::thread::hardware_concurrency();
// each thread writes its own output slots, so the ids do not depend on it.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Open-addressing token -> id table (linear probing, FNV-1a).
// Vocabularies are build-once/lookup-many, so a flat pow2 table with the
// token bytes pooled contiguously beats std::unordered_map (no per-find
// std::string allocation, one cache line per probe).
// ---------------------------------------------------------------------
struct Slot {
  uint32_t off = 0;   // offset into pool
  uint32_t len = 0;
  int32_t id = 0;     // 0 = empty (real ids are 1-based)
};

struct SeqVocab {
  std::vector<char> pool;
  std::vector<Slot> slots;
  uint64_t mask = 0;
};

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

inline int32_t vocab_find(const SeqVocab& v, const char* s, size_t n) {
  uint64_t i = fnv1a(s, n) & v.mask;
  for (;;) {
    const Slot& sl = v.slots[i];
    if (sl.id == 0) return 0;
    if (sl.len == n &&
        std::memcmp(v.pool.data() + sl.off, s, n) == 0)
      return sl.id;
    i = (i + 1) & v.mask;
  }
}

void vocab_insert(SeqVocab& v, const char* s, size_t n, int32_t id) {
  uint64_t i = fnv1a(s, n) & v.mask;
  while (v.slots[i].id != 0) {
    Slot& sl = v.slots[i];
    if (sl.len == n &&
        std::memcmp(v.pool.data() + sl.off, s, n) == 0) {
      // duplicate vocab token: LAST id wins, as in the plain path's dict
      // (schema/features.py Feature._lookup)
      sl.id = id;
      return;
    }
    i = (i + 1) & v.mask;
  }
  Slot& sl = v.slots[i];
  sl.off = static_cast<uint32_t>(v.pool.size());
  sl.len = static_cast<uint32_t>(n);
  sl.id = id;
  v.pool.insert(v.pool.end(), s, s + n);
}

void vocab_free(PyObject* capsule) {
  delete static_cast<SeqVocab*>(
      PyCapsule_GetPointer(capsule, "seqencode.vocab"));
}

// ---------------------------------------------------------------------
// Token extraction: borrowed view into the unicode object when possible.
// `owned` collects temporary PyObject*s (non-str tokens stringified, or
// non-ASCII needing a utf8 buffer kept alive until lookups finish).
// ---------------------------------------------------------------------
struct TokRef {
  const char* ptr;
  Py_ssize_t len;
  int64_t out_idx;
};

inline bool token_view(PyObject* tok, std::vector<PyObject*>& owned,
                       const char** ptr, Py_ssize_t* len) {
  if (PyUnicode_Check(tok)) {
    if (PyUnicode_IS_COMPACT_ASCII(tok)) {  // common case: zero copy
      *ptr = reinterpret_cast<const char*>(PyUnicode_1BYTE_DATA(tok));
      *len = PyUnicode_GET_LENGTH(tok);
      return true;
    }
    *ptr = PyUnicode_AsUTF8AndSize(tok, len);  // cached on the object
    return *ptr != nullptr;
  }
  PyObject* s = PyObject_Str(tok);  // str(tok), as the plain path reads it
  if (s == nullptr) return false;
  owned.push_back(s);  // keep alive until the chunk's lookups are done
  *ptr = PyUnicode_AsUTF8AndSize(s, len);
  return *ptr != nullptr;
}

void parallel_lookup(const SeqVocab& v, const std::vector<TokRef>& toks,
                     int32_t* out, Py_ssize_t n_threads) {
  size_t m = toks.size();
  unsigned nt = n_threads > 0 ? static_cast<unsigned>(n_threads)
                              : std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (m < 4096 || nt == 1) {
    for (size_t i = 0; i < m; ++i)
      out[toks[i].out_idx] = vocab_find(v, toks[i].ptr, toks[i].len);
    return;
  }
  std::vector<std::thread> threads;
  size_t per = (m + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    size_t lo = t * per, hi = std::min(m, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi]() {
      for (size_t i = lo; i < hi; ++i)
        out[toks[i].out_idx] = vocab_find(v, toks[i].ptr, toks[i].len);
    });
  }
  for (auto& th : threads) th.join();
}

inline bool is_missing(PyObject* row) {
  if (row == Py_None) return true;
  if (PyFloat_Check(row))
    return std::isnan(PyFloat_AS_DOUBLE(row));
  return false;
}

// ---------------------------------------------------------------------
// Module functions
// ---------------------------------------------------------------------
PyObject* py_vocab_create(PyObject*, PyObject* args) {
  Py_buffer buf;
  Py_ssize_t width, n;
  if (!PyArg_ParseTuple(args, "y*nn", &buf, &width, &n))
    return nullptr;
  if (width <= 0 || n < 0 ||
      static_cast<Py_ssize_t>(width * n) > buf.len) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "bad vocab buffer shape");
    return nullptr;
  }
  auto* v = new SeqVocab();
  uint64_t cap = 8;
  while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
  v->slots.assign(cap, Slot{});
  v->mask = cap - 1;
  v->pool.reserve(static_cast<size_t>(width) * n);
  const char* data = static_cast<const char*>(buf.buf);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* tok = data + i * width;
    size_t len = strnlen(tok, width);  // strip NUL padding (S dtype)
    vocab_insert(*v, tok, len, static_cast<int32_t>(i + 1));
  }
  PyBuffer_Release(&buf);
  return PyCapsule_New(v, "seqencode.vocab", vocab_free);
}

// Shared core: encode `rows` (each a token sequence; for the flat
// variant each "row" IS one token) into `out`.
PyObject* encode_impl(PyObject* args, bool flat) {
  PyObject *capsule, *rows_obj;
  Py_ssize_t max_len = 1;
  Py_ssize_t n_threads = 0;
  Py_buffer out_buf;
  if (flat) {
    if (!PyArg_ParseTuple(args, "OOw*|n", &capsule, &rows_obj,
                          &out_buf, &n_threads))
      return nullptr;
  } else {
    if (!PyArg_ParseTuple(args, "OOnw*|n", &capsule, &rows_obj,
                          &max_len, &out_buf, &n_threads))
      return nullptr;
  }
  auto* v = static_cast<SeqVocab*>(
      PyCapsule_GetPointer(capsule, "seqencode.vocab"));
  if (v == nullptr) {
    PyBuffer_Release(&out_buf);
    return nullptr;
  }
  PyObject* rows = PySequence_Fast(rows_obj, "rows must be a sequence");
  if (rows == nullptr) {
    PyBuffer_Release(&out_buf);
    return nullptr;
  }
  Py_ssize_t n_rows = PySequence_Fast_GET_SIZE(rows);
  auto* out = static_cast<int32_t*>(out_buf.buf);
  Py_ssize_t need = flat ? n_rows : n_rows * max_len;
  if (max_len <= 0 ||
      out_buf.len < static_cast<Py_ssize_t>(need * sizeof(int32_t))) {
    Py_DECREF(rows);
    PyBuffer_Release(&out_buf);
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    return nullptr;
  }

  // Chunked two-phase pipeline: collect (ptr, len, out_idx) holding the
  // GIL, then look up with the GIL released across threads.
  const Py_ssize_t CHUNK_ROWS = flat ? 262144 : 16384;
  std::vector<TokRef> toks;
  std::vector<PyObject*> owned;
  bool fail = false;
  for (Py_ssize_t r0 = 0; r0 < n_rows && !fail; r0 += CHUNK_ROWS) {
    Py_ssize_t r1 = std::min(n_rows, r0 + CHUNK_ROWS);
    toks.clear();
    for (Py_ssize_t r = r0; r < r1; ++r) {
      PyObject* row = PySequence_Fast_GET_ITEM(rows, r);  // borrowed
      if (flat) {
        const char* p;
        Py_ssize_t l;
        if (!token_view(row, owned, &p, &l)) { fail = true; break; }
        toks.push_back({p, l, r});
        continue;
      }
      if (is_missing(row)) continue;
      PyObject* seq =
          PySequence_Fast(row, "history cell must be a sequence");
      if (seq == nullptr) { fail = true; break; }
      Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
      Py_ssize_t start = n > max_len ? n - max_len : 0;
      for (Py_ssize_t j = start; j < n; ++j) {
        PyObject* tok = PySequence_Fast_GET_ITEM(seq, j);
        const char* p;
        Py_ssize_t l;
        if (!token_view(tok, owned, &p, &l)) { fail = true; break; }
        toks.push_back({p, l, r * max_len + (j - start)});
      }
      if (PyList_CheckExact(row) || PyTuple_CheckExact(row)) {
        // seq IS row (new ref); items stay alive via `rows`
        Py_DECREF(seq);
      } else {
        // seq is a fresh list (ndarray/str/... rows) holding the only
        // reference to freshly created item objects — the TokRef
        // pointers view their storage, so keep the list alive until
        // this chunk's lookups finish
        owned.push_back(seq);
      }
      if (fail) break;
    }
    if (fail) break;
    Py_BEGIN_ALLOW_THREADS
    parallel_lookup(*v, toks, out, n_threads);
    Py_END_ALLOW_THREADS
    for (PyObject* o : owned) Py_DECREF(o);
    owned.clear();
  }
  for (PyObject* o : owned) Py_DECREF(o);
  Py_DECREF(rows);
  PyBuffer_Release(&out_buf);
  if (fail) return nullptr;
  Py_RETURN_NONE;
}

PyObject* py_encode_sequences(PyObject*, PyObject* args) {
  return encode_impl(args, /*flat=*/false);
}

PyObject* py_encode_tokens(PyObject*, PyObject* args) {
  return encode_impl(args, /*flat=*/true);
}

PyMethodDef methods[] = {
    {"vocab_create", py_vocab_create, METH_VARARGS,
     "vocab_create(fixed_bytes, width, n) -> capsule"},
    {"encode_sequences", py_encode_sequences, METH_VARARGS,
     "encode_sequences(capsule, rows, max_len, out[, n_threads]) -> None"},
    {"encode_tokens", py_encode_tokens, METH_VARARGS,
     "encode_tokens(capsule, tokens, out[, n_threads]) -> None"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_seqencode",
                         "native token/sequence encoder", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__seqencode(void) {
  return PyModule_Create(&moduledef);
}
