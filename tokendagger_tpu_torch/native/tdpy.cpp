// CPython extension binding for the native engine (optional fast layer):
// the JAX package's native/tdpy.cpp, with its id -> int loops folded into
// one helper (id_long) and one entry point of the port's own,
// assemble_lists, which builds the device path's result lists.
//
// The ctypes binding (see __init__.py) is the portable path; this module
// removes the remaining Python-side costs for the list-returning APIs:
// the GIL is released for the whole C++ encode (like the reference's
// pybind11 gil_scoped_release, src/py_binding.cpp:26-44 —
// behavior studied, binding written fresh for the CPython C API), and the
// result list is built directly with PyList_SET_ITEM instead of
// numpy->tolist.
//
// Build (see __init__.py): compiled together with tdnative.cpp into one
// shared object exposing PyInit_tdpy.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {
void* td_create(const uint8_t*, const int8_t*, const int32_t*, int64_t,
                int32_t, const int32_t*, int);
void td_destroy(void*);
void td_set_vocab(void*, const uint8_t*, const int64_t*, const int32_t*,
                  const int32_t*, int64_t);
void td_set_specials(void*, const uint8_t*, const int64_t*, const int32_t*,
                     const int32_t*, int64_t);
int64_t td_scan(const void*, const uint8_t*, int64_t, int32_t*, int64_t);
int64_t td_encode(const void*, const uint8_t*, int64_t, int32_t*, int64_t);
int64_t td_encode_batch(const void*, const uint8_t*, const int64_t*, int64_t,
                        int32_t*, int64_t*, int);
int64_t td_decode(const int64_t*, int64_t, const int64_t*, const int32_t*,
                  const uint8_t*, int64_t, uint8_t*, int64_t, int);
int64_t td_find_specials_l(const void*, const uint8_t*, int64_t, int64_t*,
                           int32_t*, int32_t*, int64_t);
int32_t td_specials_min_len(const void*);
}

namespace {

// Immortal id->PyLong cache. Token ids are dense and bounded by the vocab
// size, so result lists are materialized from shared PyLong objects
// (INCREF + SET_ITEM) instead of allocating a fresh PyLong per token.
// Beyond ~30M alive small objects, CPython's object allocator degrades
// hard (measured on this VM: 77 -> 950 ns per fresh PyLong once a few GB
// of ids are held by the caller, the GB-corpus wall in docs/PERF.md);
// shared ints hold a flat rate at any scale, and cut result memory from
// ~36 to 8 bytes per token. Ints are immutable so sharing is invisible
// (CPython itself does this for -5..256). Cache entries are never freed.
PyObject** g_longs = nullptr;
Py_ssize_t g_nlongs = 0;
constexpr Py_ssize_t kMaxLongCache = 1 << 22;  // 4M ids ~ 117 MB cap

// Whether the table holds ``id`` (a negative id does not).
inline bool is_shared(long long id) {
  return (unsigned long long)id < (unsigned long long)g_nlongs;
}

// A new reference to the int ``id``: the shared object where the table
// holds it, else a fresh int (nullptr, with the error set, if that fails).
inline PyObject* id_long(long long id) {
  if (is_shared(id)) {
    PyObject* v = g_longs[id];
    Py_INCREF(v);
    return v;
  }
  return PyLong_FromLongLong(id);
}

// tdpy.prime_longs(n): ensure ids [0, n) are cached. Called under the GIL.
PyObject* py_prime_longs(PyObject*, PyObject* args) {
  long long n;
  if (!PyArg_ParseTuple(args, "L", &n)) return nullptr;
  if (n > kMaxLongCache) n = kMaxLongCache;
  if (n <= g_nlongs) Py_RETURN_NONE;
  PyObject** grown =
      (PyObject**)PyMem_Realloc(g_longs, sizeof(PyObject*) * n);
  if (!grown) return PyErr_NoMemory();
  g_longs = grown;
  for (Py_ssize_t i = g_nlongs; i < n; ++i) {
    g_longs[i] = PyLong_FromSsize_t(i);
    if (!g_longs[i]) {
      g_nlongs = i;
      return nullptr;
    }
  }
  g_nlongs = n;
  Py_RETURN_NONE;
}

void capsule_destructor(PyObject* cap) {
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (h) td_destroy(h);
}

const void* buf_ptr(Py_buffer* view) { return view->buf; }

// tdpy.create(classes, fold, pair_rows, nbuckets, mask, byte_rank,
//             contractions) -> capsule
// All buffers must outlive the capsule (the Python side keeps references).
PyObject* py_create(PyObject*, PyObject* args) {
  Py_buffer classes, fold, pair_rows, byte_rank;
  long long nbuckets;
  int mask, contractions;
  if (!PyArg_ParseTuple(args, "y*y*y*Liy*i", &classes, &fold, &pair_rows,
                        &nbuckets, &mask, &byte_rank, &contractions))
    return nullptr;
  void* h = td_create((const uint8_t*)classes.buf, (const int8_t*)fold.buf,
                      (const int32_t*)pair_rows.buf, nbuckets, mask,
                      (const int32_t*)byte_rank.buf, contractions);
  PyBuffer_Release(&classes);
  PyBuffer_Release(&fold);
  PyBuffer_Release(&pair_rows);
  PyBuffer_Release(&byte_rank);
  if (!h) {
    PyErr_SetString(PyExc_RuntimeError, "td_create failed");
    return nullptr;
  }
  return PyCapsule_New(h, "tdpy.engine", capsule_destructor);
}

PyObject* py_set_vocab(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer blob, offs, lens, ranks;
  long long n;
  if (!PyArg_ParseTuple(args, "Oy*y*y*y*L", &cap, &blob, &offs, &lens,
                        &ranks, &n))
    return nullptr;
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (h) {
    td_set_vocab(h, (const uint8_t*)blob.buf, (const int64_t*)offs.buf,
                 (const int32_t*)lens.buf, (const int32_t*)ranks.buf, n);
  }
  PyBuffer_Release(&blob);
  PyBuffer_Release(&offs);
  PyBuffer_Release(&lens);
  PyBuffer_Release(&ranks);
  if (!h) return nullptr;  // PyCapsule_GetPointer set the error
  Py_RETURN_NONE;
}

// tdpy.set_specials(capsule, blob, offs, lens, ids, n) — install the
// special-token scan table on this binding's engine (mirrors
// native/__init__.py set_specials for the ctypes engine).
PyObject* py_set_specials(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer blob, offs, lens, ids;
  long long n;
  if (!PyArg_ParseTuple(args, "Oy*y*y*y*L", &cap, &blob, &offs, &lens,
                        &ids, &n))
    return nullptr;
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (h) {
    td_set_specials(h, (const uint8_t*)blob.buf, (const int64_t*)offs.buf,
                    (const int32_t*)lens.buf, (const int32_t*)ids.buf, n);
  }
  PyBuffer_Release(&blob);
  PyBuffer_Release(&offs);
  PyBuffer_Release(&lens);
  PyBuffer_Release(&ids);
  if (!h) return nullptr;
  Py_RETURN_NONE;
}

// tdpy.encode_list(capsule, data: bytes) -> list[int]
PyObject* py_encode_list(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer data;
  if (!PyArg_ParseTuple(args, "Oy*", &cap, &data)) return nullptr;
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (!h) {
    PyBuffer_Release(&data);
    return nullptr;
  }
  int64_t n = data.len;
  int32_t* out = (int32_t*)PyMem_Malloc(sizeof(int32_t) * (n ? n : 1));
  if (!out) {
    PyBuffer_Release(&data);
    return PyErr_NoMemory();
  }
  int64_t count;
  Py_BEGIN_ALLOW_THREADS
  count = td_encode(h, (const uint8_t*)data.buf, n, out, n);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data);
  if (count < 0) {
    PyMem_Free(out);
    if (count == -2) {
      // vocab not installed / missing byte ranks: signal fallback
      Py_RETURN_NONE;
    }
    PyErr_SetString(PyExc_RuntimeError, "td_encode failed");
    return nullptr;
  }
  PyObject* list = PyList_New(count);
  if (!list) {
    PyMem_Free(out);
    return nullptr;
  }
  for (int64_t i = 0; i < count; ++i) {
    PyObject* v = id_long(out[i]);
    if (!v) {
      Py_DECREF(list);
      PyMem_Free(out);
      return nullptr;
    }
    PyList_SET_ITEM(list, i, v);
  }
  PyMem_Free(out);
  // Untrack from the cyclic GC: the list holds only ints, so it can never
  // participate in a reference cycle. Without this, full collections
  // traverse every token of every result list — at corpus scale (tens of
  // millions of ids alive) GC dominates the runtime (measured 7x).
  PyObject_GC_UnTrack(list);
  return list;
}

// tdpy.encode_batch_lists(capsule, blob: bytes, offs: int64 buffer,
//                         n_texts, nthreads) -> list[list[int]] | None
//
// The list-mode throughput path: ALL texts are encoded in one GIL-free
// OpenMP region (the ThreadPoolExecutor equivalent without Python threads
// or GIL handoffs), then every result list is materialized in a single
// pass from the shared PyLong cache. This keeps the GIL-serialized part
// at a few ns/token, so list-mode batch throughput scales with cores the
// way the reference's GIL-released pybind11 calls do
// (src/py_binding.cpp:26-44 — behavior studied, written
// fresh).
PyObject* py_encode_batch_lists(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer data, offs;
  long long n_texts;
  int nthreads;
  if (!PyArg_ParseTuple(args, "Oy*y*Li", &cap, &data, &offs, &n_texts,
                        &nthreads))
    return nullptr;
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (!h || (Py_ssize_t)(sizeof(int64_t) * (n_texts + 1)) > offs.len) {
    if (h) PyErr_SetString(PyExc_ValueError, "offs buffer too small");
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    return nullptr;
  }
  const int64_t* off = (const int64_t*)offs.buf;
  int64_t total = off[n_texts];
  int32_t* out = (int32_t*)PyMem_Malloc(sizeof(int32_t) * (total ? total : 1));
  int64_t* counts =
      (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n_texts ? n_texts : 1));
  if (!out || !counts) {
    PyMem_Free(out);
    PyMem_Free(counts);
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    return PyErr_NoMemory();
  }
  // Overlap pipeline: a worker thread runs the GIL-free OpenMP encode of
  // all texts; this (GIL-holding) thread materializes each text's result
  // list as soon as its flag flips. Wall time becomes
  // max(parallel encode, serial materialize) instead of their sum; the
  // encode threads never touch Python state, so holding the GIL while
  // building lists steals nothing from them.
  std::vector<std::atomic<uint8_t>> done(n_texts);
  for (auto& d : done) d.store(0, std::memory_order_relaxed);
  std::atomic<int64_t> err{0};
  const uint8_t* base = (const uint8_t*)data.buf;
  std::thread worker([&] {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) num_threads(nthreads)
#endif
    for (int64_t i = 0; i < n_texts; ++i) {
      int64_t n = off[i + 1] - off[i];
      int64_t r = td_encode(h, base + off[i], n, out + off[i], n);
      counts[i] = r >= 0 ? r : 0;
      if (r < 0) err.store(r, std::memory_order_relaxed);
      done[i].store(1, std::memory_order_release);
    }
  });

  PyObject* outer = PyList_New(n_texts);
  bool failed = outer == nullptr;
  for (int64_t t = 0; t < n_texts && !failed; ++t) {
    while (!done[t].load(std::memory_order_acquire)) {
      Py_BEGIN_ALLOW_THREADS
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      Py_END_ALLOW_THREADS
    }
    int64_t cnt = counts[t];
    PyObject* list = PyList_New(cnt);
    if (!list) {
      failed = true;
      break;
    }
    const int32_t* ids = out + off[t];
    for (int64_t i = 0; i < cnt; ++i) {
      PyObject* v = id_long(ids[i]);
      if (!v) {
        Py_DECREF(list);
        failed = true;
        break;
      }
      PyList_SET_ITEM(list, i, v);
    }
    if (failed) break;
    PyObject_GC_UnTrack(list);  // holds only ints; see encode_list
    PyList_SET_ITEM(outer, t, list);
  }
  Py_BEGIN_ALLOW_THREADS
  worker.join();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data);
  PyBuffer_Release(&offs);
  PyMem_Free(out);
  PyMem_Free(counts);
  int64_t e = err.load(std::memory_order_relaxed);
  if (failed) {
    Py_XDECREF(outer);
    return nullptr;
  }
  if (e < 0) {
    Py_DECREF(outer);
    if (e == -2) Py_RETURN_NONE;  // vocab not installed: signal fallback
    PyErr_SetString(PyExc_RuntimeError, "td_encode_batch failed");
    return nullptr;
  }
  return outer;
}

// tdpy.encode_with_specials(capsule, data: bytes, nthreads)
//   -> list[int] | None
//
// The full-allowed-set encode of one text in ONE extension call: native
// special scan (td_find_specials_l), GIL-free OpenMP encode of every
// ordinary segment, then a single interleaved materialization from the
// shared PyLong cache. Special-dense chat text has ~30k tiny segments
// per MB — driving them through per-segment extension calls (or even
// one batched call fed by a Python segment-building loop) pays microsecond
// per-segment Python costs that dwarf the actual encoding. Returns None
// when the engine has no specials table or no vocab (caller falls back).
PyObject* py_encode_with_specials(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer data;
  int nthreads;
  if (!PyArg_ParseTuple(args, "Oy*i", &cap, &data, &nthreads))
    return nullptr;
  void* h = PyCapsule_GetPointer(cap, "tdpy.engine");
  if (!h) {
    PyBuffer_Release(&data);
    return nullptr;
  }
  const uint8_t* buf = (const uint8_t*)data.buf;
  int64_t n = data.len;
  // matches never overlap, so the shortest installed special bounds the
  // match count (n+1 worst case would be 16 bytes of scratch per input
  // byte on special-free multi-MB texts)
  int32_t min_len = td_specials_min_len(h);
  if (min_len < 1) {
    PyBuffer_Release(&data);
    Py_RETURN_NONE;  // no specials table: caller falls back
  }
  int64_t cap_m = n / min_len + 2;
  int64_t* sp_pos = (int64_t*)PyMem_Malloc(sizeof(int64_t) * cap_m);
  int32_t* sp_id = (int32_t*)PyMem_Malloc(sizeof(int32_t) * cap_m);
  int32_t* sp_len = (int32_t*)PyMem_Malloc(sizeof(int32_t) * cap_m);
  if (!sp_pos || !sp_id || !sp_len) {
    PyMem_Free(sp_pos);
    PyMem_Free(sp_id);
    PyMem_Free(sp_len);
    PyBuffer_Release(&data);
    return PyErr_NoMemory();
  }
  int64_t n_sp;
  Py_BEGIN_ALLOW_THREADS
  n_sp = td_find_specials_l(h, buf, n, sp_pos, sp_id, sp_len, cap_m);
  Py_END_ALLOW_THREADS
  if (n_sp < 0) {  // -3: no table installed (or scan unavailable)
    PyMem_Free(sp_pos);
    PyMem_Free(sp_id);
    PyMem_Free(sp_len);
    PyBuffer_Release(&data);
    Py_RETURN_NONE;
  }
  // ordinary segment table + interleave plan (plan[k] >= 0: segment
  // index; < 0: special index as -1-i)
  int64_t max_items = 2 * n_sp + 1;
  int64_t* seg_s = (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n_sp + 2));
  int64_t* seg_o = (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n_sp + 2));
  int64_t* seg_e = (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n_sp + 2));
  int64_t* counts = (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n_sp + 2));
  int64_t* plan = (int64_t*)PyMem_Malloc(
      sizeof(int64_t) * (max_items ? max_items : 1));
  if (!seg_s || !seg_e || !seg_o || !counts || !plan) {
    PyMem_Free(sp_pos); PyMem_Free(sp_id); PyMem_Free(sp_len);
    PyMem_Free(seg_s); PyMem_Free(seg_e); PyMem_Free(seg_o);
    PyMem_Free(counts); PyMem_Free(plan);
    PyBuffer_Release(&data);
    return PyErr_NoMemory();
  }
  int64_t n_seg = 0, n_items = 0, prev = 0, out_total = 0;
  for (int64_t i = 0; i < n_sp; ++i) {
    if (prev < sp_pos[i]) {
      seg_s[n_seg] = prev;
      seg_e[n_seg] = sp_pos[i];
      seg_o[n_seg] = out_total;
      out_total += sp_pos[i] - prev;
      plan[n_items++] = n_seg++;
    }
    plan[n_items++] = -1 - i;
    prev = sp_pos[i] + sp_len[i];
  }
  if (prev < n) {
    seg_s[n_seg] = prev;
    seg_e[n_seg] = n;
    seg_o[n_seg] = out_total;
    out_total += n - prev;
    plan[n_items++] = n_seg++;
  }
  int32_t* out =
      (int32_t*)PyMem_Malloc(sizeof(int32_t) * (out_total ? out_total : 1));
  if (!out) {
    PyMem_Free(sp_pos); PyMem_Free(sp_id); PyMem_Free(sp_len);
    PyMem_Free(seg_s); PyMem_Free(seg_e); PyMem_Free(seg_o);
    PyMem_Free(counts); PyMem_Free(plan);
    PyBuffer_Release(&data);
    return PyErr_NoMemory();
  }
  int64_t err = 0;
  Py_BEGIN_ALLOW_THREADS
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(nthreads)
#endif
  for (int64_t i = 0; i < n_seg; ++i) {
    int64_t len = seg_e[i] - seg_s[i];
    int64_t r = td_encode(h, buf + seg_s[i], len, out + seg_o[i], len);
    counts[i] = r >= 0 ? r : 0;
    if (r < 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
      err = r;
    }
  }
  Py_END_ALLOW_THREADS
  PyObject* res = nullptr;
  if (err == 0) {
    int64_t total = n_sp;
    for (int64_t i = 0; i < n_seg; ++i) total += counts[i];
    res = PyList_New(total);
    int64_t w = 0;
    for (int64_t k = 0; res && k < n_items; ++k) {
      if (plan[k] < 0) {
        PyObject* v = id_long(sp_id[-1 - plan[k]]);
        if (!v) { Py_CLEAR(res); break; }
        PyList_SET_ITEM(res, w++, v);
      } else {
        const int32_t* ids = out + seg_o[plan[k]];
        int64_t cnt = counts[plan[k]];
        for (int64_t i = 0; i < cnt; ++i) {
          PyObject* v = id_long(ids[i]);
          if (!v) { Py_CLEAR(res); break; }
          PyList_SET_ITEM(res, w++, v);
        }
      }
    }
    if (res) PyObject_GC_UnTrack(res);  // holds only ints
  }
  PyMem_Free(sp_pos); PyMem_Free(sp_id); PyMem_Free(sp_len);
  PyMem_Free(seg_s); PyMem_Free(seg_e); PyMem_Free(seg_o);
  PyMem_Free(counts); PyMem_Free(plan);
  PyMem_Free(out);
  PyBuffer_Release(&data);
  if (err == -2) {
    Py_XDECREF(res);
    Py_RETURN_NONE;  // vocab not installed: caller falls back
  }
  if (err < 0) {
    Py_XDECREF(res);
    PyErr_SetString(PyExc_RuntimeError, "td_encode failed");
    return nullptr;
  }
  return res;
}

// A buffer format of signed 64-bit ints in this host's byte order ('@',
// '=' or '<' on the little-endian hosts this builds for).
bool is_int64_format(const char* f) {
  if (!f) return false;  // no format: unsigned bytes
  if (*f == '@' || *f == '=' || *f == '<') ++f;
  return (f[0] == 'q' || f[0] == 'l') && f[1] == '\0';
}

// One part of a text: a special's id, or the index of a segment's buffer.
struct Part {
  long long id;
  Py_ssize_t view;  // < 0: the part is ``id``
};

// One text's list (a new reference, or nullptr with the error set). The
// parts are read whole, from a tuple of them, before the list is
// allocated, so nothing that an allocation may run (a collection and its
// finalizers) can change what is filled in; ``views`` and ``plan`` are the
// caller's scratch, and every buffer taken is released before this
// returns.
PyObject* assemble_one(PyObject* text, std::vector<Py_buffer>& views,
                       std::vector<Part>& plan, long long* shared) {
  PyObject* parts = PySequence_Tuple(text);  // immutable while read
  if (!parts) return nullptr;
  const Py_ssize_t n_parts = PyTuple_GET_SIZE(parts);
  PyObject** items = &PyTuple_GET_ITEM(parts, 0);
  views.clear();
  plan.clear();
  Py_ssize_t total = 0;
  bool ok = true;
  for (Py_ssize_t k = 0; k < n_parts && ok; ++k) {
    if (PyLong_Check(items[k])) {
      long long id = PyLong_AsLongLong(items[k]);
      ok = !(id == -1 && PyErr_Occurred());
      plan.push_back({id, -1});
      ++total;
      continue;
    }
    Py_buffer v;
    if (PyObject_GetBuffer(items[k], &v,
                           PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
      ok = false;
      break;
    }
    views.push_back(v);
    if (v.itemsize != 8 || !is_int64_format(v.format)) {
      PyErr_Format(PyExc_TypeError,
                   "a segment's ids must be int64, not format '%s'",
                   v.format ? v.format : "B");
      ok = false;
      break;
    }
    plan.push_back({0, (Py_ssize_t)views.size() - 1});
    total += v.len / 8;
  }
  Py_DECREF(parts);
  PyObject* list = ok ? PyList_New(total) : nullptr;
  Py_ssize_t w = 0;
  long long hits = 0;
  for (size_t k = 0; list && k < plan.size(); ++k) {
    const long long* ids = &plan[k].id;
    Py_ssize_t n = 1;
    if (plan[k].view >= 0) {
      const Py_buffer& v = views[plan[k].view];
      ids = (const long long*)v.buf;
      n = v.len / 8;
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
      hits += is_shared(ids[i]);
      PyObject* o = id_long(ids[i]);
      if (!o) {
        Py_CLEAR(list);  // its unfilled slots are NULL, which it skips
        break;
      }
      PyList_SET_ITEM(list, w++, o);
    }
  }
  for (Py_buffer& v : views) PyBuffer_Release(&v);
  views.clear();
  if (!list) return nullptr;
  PyObject_GC_UnTrack(list);  // holds only ints; see encode_list
  *shared += hits;
  return list;
}

// tdpy.assemble_lists(texts) -> (list[list[int]], n_shared)
//
// The device path's result lists in one pass. ``texts`` holds one
// sequence of parts a text; a part is a special's id (an int) or one
// segment's ids (a C-contiguous buffer of int64, as the engine's
// encode_streams returns them). Each text's list is allocated once at its
// full length and filled from the shared PyLong cache (prime_longs), a
// fresh int for an id outside it; ``n_shared`` counts the ids the cache
// gave. A buffer of another item type raises TypeError, one that is not
// C-contiguous the exporter's error (ValueError for numpy). Unlike
// tolist() and extend, no id is allocated twice, and dropping the lists
// frees no ints the cache holds.
PyObject* py_assemble_lists(PyObject*, PyObject* arg) {
  PyObject* texts = PySequence_Tuple(arg);  // immutable while read
  if (!texts) return nullptr;
  const Py_ssize_t n_texts = PyTuple_GET_SIZE(texts);
  PyObject* outer = PyList_New(n_texts);
  std::vector<Py_buffer> views;
  std::vector<Part> plan;
  long long shared = 0;
  for (Py_ssize_t t = 0; outer && t < n_texts; ++t) {
    PyObject* list = assemble_one(PyTuple_GET_ITEM(texts, t), views, plan,
                                  &shared);
    if (!list) {
      Py_CLEAR(outer);
      break;
    }
    PyList_SET_ITEM(outer, t, list);
  }
  Py_DECREF(texts);
  if (!outer) return nullptr;
  return Py_BuildValue("(NL)", outer, shared);
}

// tdpy.decode_list(ids, offs, lens, blob, n_vocab, nthreads) -> bytes
//
// Decode a Python list/tuple of token ids straight to bytes: the PyLong
// extraction + validation + total-length pass runs under the GIL over
// PySequence_Fast items (no numpy conversion — np.asarray on a 15M-id
// list alone costs ~0.43 s on this VM), then the concat fill runs
// GIL-free and OpenMP-parallel in td_decode. Mirrors the reference's
// decode_bytes semantics (tiktoken.cpp:236-255): unknown id raises
// KeyError with the same message as the numpy path.
PyObject* py_decode_list(PyObject*, PyObject* args) {
  PyObject* seq;
  Py_buffer offs, lens, blob;
  long long n_vocab;
  int nthreads;
  if (!PyArg_ParseTuple(args, "Oy*y*y*Li", &seq, &offs, &lens, &blob,
                        &n_vocab, &nthreads))
    return nullptr;
  PyObject* fast = PySequence_Fast(seq, "ids must be a sequence");
  PyObject* res = nullptr;
  int64_t* ids = nullptr;
  if (fast) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject** items = PySequence_Fast_ITEMS(fast);
    const int32_t* ln = (const int32_t*)lens.buf;
    const int64_t* of = (const int64_t*)offs.buf;
    ids = (int64_t*)PyMem_Malloc(sizeof(int64_t) * (n ? n : 1));
    if (!ids) {
      PyErr_NoMemory();
    } else {
      int64_t total = 0;
      bool ok = true;
      for (Py_ssize_t i = 0; i < n; ++i) {
        long long v = PyLong_AsLongLong(items[i]);
        if (v == -1 && PyErr_Occurred()) {
          ok = false;
          break;
        }
        if (v < 0 || v >= n_vocab || ln[v] < 0) {
          PyErr_Format(PyExc_KeyError, "Unknown token id: %lld", v);
          ok = false;
          break;
        }
        ids[i] = v;
        total += ln[v];
      }
      if (ok) {
        res = PyBytes_FromStringAndSize(nullptr, total);
        if (res && total) {
          uint8_t* out = (uint8_t*)PyBytes_AS_STRING(res);
          const uint8_t* bl = (const uint8_t*)blob.buf;
          Py_BEGIN_ALLOW_THREADS
          td_decode(ids, n, of, ln, bl, n_vocab, out, total, nthreads);
          Py_END_ALLOW_THREADS
        }
      }
    }
  }
  PyMem_Free(ids);
  Py_XDECREF(fast);
  PyBuffer_Release(&offs);
  PyBuffer_Release(&lens);
  PyBuffer_Release(&blob);
  return res;
}

PyMethodDef methods[] = {
    {"create", py_create, METH_VARARGS, "create engine"},
    {"set_vocab", py_set_vocab, METH_VARARGS, "install vocab hash"},
    {"set_specials", py_set_specials, METH_VARARGS,
     "install special-token scan table"},
    {"encode_list", py_encode_list, METH_VARARGS,
     "encode bytes -> list of token ids (GIL-free encode)"},
    {"prime_longs", py_prime_longs, METH_VARARGS,
     "pre-build shared PyLongs for ids [0, n)"},
    {"decode_list", py_decode_list, METH_VARARGS,
     "decode a list of ids to bytes (GIL-free parallel fill)"},
    {"encode_batch_lists", py_encode_batch_lists, METH_VARARGS,
     "batch encode -> list of id lists (OpenMP, one GIL-free region)"},
    {"encode_with_specials", py_encode_with_specials, METH_VARARGS,
     "full-allowed-set encode of one text: scan + parallel segment "
     "encode + interleaved list, one call"},
    {"assemble_lists", py_assemble_lists, METH_O,
     "texts of special ids and int64 segment buffers -> (id lists, ids "
     "taken from the shared cache)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "tdpy", "native engine CPython binding",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_tdpy(void) { return PyModule_Create(&moduledef); }
