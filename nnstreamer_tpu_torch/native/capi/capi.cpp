/**
 * capi.cpp — implementation of the nnstreamer_tpu_torch C application API.
 *
 * Embeds CPython and drives nnstreamer_tpu_torch.api.capi_glue: the port's
 * copy of the JAX package's C API, the same ABI over its own glue module.
 * The reference's C API (api/capi/src/nnstreamer-capi-*.c) sits on
 * GStreamer the same way
 * this sits on the Python framework: handles are thin native structs, all
 * heavy lifting happens in the runtime underneath, payloads are copied once
 * at the app boundary.
 *
 * Dual-mode: works both from a plain C program (we initialize the
 * interpreter) and when loaded into an existing Python process via
 * ctypes/cffi (we only take the GIL).
 */

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "nnstreamer-capi.h"

/* ------------------------------------------------------------------ state */

static PyObject *g_glue = nullptr; /* nnstreamer_tpu_torch.api.capi_glue */
static std::mutex g_init_lock;
static bool g_we_initialized = false;

struct ml_tensors_info_s {
  unsigned int count;
  ml_tensor_type_e types[ML_TENSOR_SIZE_LIMIT];
  unsigned int ranks[ML_TENSOR_SIZE_LIMIT];
  ml_tensor_dimension dims[ML_TENSOR_SIZE_LIMIT];
};

struct ml_tensors_data_s {
  ml_tensors_info_s info;
  void *buffers[ML_TENSOR_SIZE_LIMIT];
  size_t sizes[ML_TENSOR_SIZE_LIMIT];
};

struct ml_single_s {
  PyObject *obj; /* SingleShot */
};

struct ml_pipeline_s {
  PyObject *obj; /* PipelineHandle */
};

struct ml_pipeline_sink_s {
  ml_pipeline_s *pipe;
  std::string name;
  PyObject *py_cb;      /* callback registered on the Python sink */
  PyObject *trampoline; /* the C-side callable */
};

/* ------------------------------------------------------------- type table */

static const char *type_names[] = {
  "int32", "uint32", "int16", "uint16", "int8", "uint8",
  "float64", "float32", "int64", "uint64", "float16", "bfloat16",
};

static const size_t type_sizes[] = {4, 4, 2, 2, 1, 1, 8, 4, 8, 8, 2, 2};

static ml_tensor_type_e type_from_name (const char *name) {
  if (name != nullptr)
    for (unsigned i = 0; i < ML_TENSOR_TYPE_UNKNOWN; ++i)
      if (!strcmp (name, type_names[i]))
        return (ml_tensor_type_e) i;
  return ML_TENSOR_TYPE_UNKNOWN;
}

/* Name for a (possibly out-of-range) type value; never indexes OOB. */
static const char *type_name_safe (ml_tensor_type_e t) {
  return (t < ML_TENSOR_TYPE_UNKNOWN) ? type_names[t] : "unknown";
}

/* ------------------------------------------------------- interpreter init */

static int ensure_python (void) {
  std::lock_guard<std::mutex> guard (g_init_lock);
  if (g_glue != nullptr)
    return ML_ERROR_NONE;
  if (!Py_IsInitialized ()) {
    Py_InitializeEx (0);
    g_we_initialized = true;
    /* Release the GIL the init path acquired; all entry points use
     * PyGILState_Ensure from here on. */
    PyEval_SaveThread ();
  }
  PyGILState_STATE gil = PyGILState_Ensure ();
  PyObject *mod = PyImport_ImportModule ("nnstreamer_tpu_torch.api.capi_glue");
  if (mod == nullptr) {
    PyErr_Print ();
    PyGILState_Release (gil);
    return ML_ERROR_NOT_SUPPORTED;
  }
  g_glue = mod;
  PyGILState_Release (gil);
  return ML_ERROR_NONE;
}

int ml_tpu_initialize (void) { return ensure_python (); }

int ml_tpu_finalize (void) {
  std::lock_guard<std::mutex> guard (g_init_lock);
  if (g_glue != nullptr && g_we_initialized) {
    PyGILState_Ensure ();
    Py_CLEAR (g_glue);
    Py_Finalize ();
    g_we_initialized = false;
  }
  return ML_ERROR_NONE;
}

/* RAII GIL holder; also guarantees glue is importable. */
struct Gil {
  PyGILState_STATE st;
  bool ok;
  Gil () : ok (ensure_python () == ML_ERROR_NONE) {
    if (ok)
      st = PyGILState_Ensure ();
  }
  ~Gil () {
    if (ok)
      PyGILState_Release (st);
  }
};

/* Classification of the last failed glue_call on this thread, so callers
 * can map distinct Python exception types to distinct ml_error codes (the
 * reference's C API distinguishes timeout vs invalid-arg vs pipe errors). */
static thread_local int g_last_err = ML_ERROR_NONE;

static int classify_pending_exception (void) {
  if (PyErr_ExceptionMatches (PyExc_TimeoutError))
    return ML_ERROR_TIMED_OUT; /* covers InvokeTimeout */
  if (PyErr_ExceptionMatches (PyExc_ValueError)
      || PyErr_ExceptionMatches (PyExc_TypeError)
      || PyErr_ExceptionMatches (PyExc_KeyError))
    return ML_ERROR_INVALID_PARAMETER;
  return ML_ERROR_STREAMS_PIPE;
}

/* Call glue.<name>(args); returns new ref or nullptr (prints the error and
 * records its classification in g_last_err). */
static PyObject *glue_call (const char *name, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString (g_glue, name);
  PyObject *res = nullptr;
  if (fn != nullptr) {
    res = PyObject_CallObject (fn, args);
    Py_DECREF (fn);
  }
  Py_XDECREF (args);
  if (res == nullptr) {
    g_last_err = classify_pending_exception ();
    PyErr_Print ();
  }
  return res;
}

/* ------------------------------------------------- wire format conversion */

/* info+data -> [(bytes, dtype, shape), ...] */
static PyObject *data_to_wire (const ml_tensors_data_s *d) {
  PyObject *list = PyList_New (d->info.count);
  for (unsigned i = 0; i < d->info.count; ++i) {
    PyObject *buf = PyBytes_FromStringAndSize ((const char *) d->buffers[i],
                                               (Py_ssize_t) d->sizes[i]);
    PyObject *shape = PyTuple_New (d->info.ranks[i]);
    for (unsigned r = 0; r < d->info.ranks[i]; ++r)
      PyTuple_SET_ITEM (shape, r, PyLong_FromUnsignedLong (d->info.dims[i][r]));
    PyObject *dtype = PyUnicode_FromString (type_name_safe (d->info.types[i]));
    PyObject *triple = PyTuple_Pack (3, buf, dtype, shape);
    Py_DECREF (buf);
    Py_DECREF (dtype);
    Py_DECREF (shape);
    PyList_SET_ITEM (list, i, triple);
  }
  return list;
}

/* [(bytes, dtype, shape), ...] -> freshly allocated data (caller owns). */
static ml_tensors_data_s *wire_to_data (PyObject *list) {
  if (!PyList_Check (list))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE (list);
  if (n > ML_TENSOR_SIZE_LIMIT)
    return nullptr;
  auto *d = (ml_tensors_data_s *) calloc (1, sizeof (ml_tensors_data_s));
  if (d == nullptr)
    return nullptr;
  d->info.count = (unsigned) n;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *triple = PyList_GET_ITEM (list, i);
    PyObject *buf = PyTuple_GetItem (triple, 0);
    PyObject *dtype = PyTuple_GetItem (triple, 1);
    PyObject *shape = PyTuple_GetItem (triple, 2);
    char *raw;
    Py_ssize_t size;
    if (PyBytes_AsStringAndSize (buf, &raw, &size) != 0)
      goto fail;
    d->info.types[i] = type_from_name (PyUnicode_AsUTF8 (dtype));
    if (d->info.types[i] == ML_TENSOR_TYPE_UNKNOWN)
      goto fail;
    d->info.ranks[i] = (unsigned) PyTuple_GET_SIZE (shape);
    if (d->info.ranks[i] > ML_TENSOR_RANK_LIMIT)
      goto fail;
    for (unsigned r = 0; r < d->info.ranks[i]; ++r)
      d->info.dims[i][r] =
          (unsigned) PyLong_AsUnsignedLong (PyTuple_GET_ITEM (shape, r));
    d->buffers[i] = malloc ((size_t) size);
    if (d->buffers[i] == nullptr)
      goto fail;
    d->sizes[i] = (size_t) size;
    memcpy (d->buffers[i], raw, (size_t) size);
  }
  return d;
fail:
  PyErr_Clear (); /* e.g. non-string dtype from PyUnicode_AsUTF8 */
  for (unsigned i = 0; i < d->info.count; ++i)
    free (d->buffers[i]);
  free (d);
  return nullptr;
}

/* info -> [(dtype, shape), ...] for glue spec args. */
static PyObject *info_to_wire (const ml_tensors_info_s *info) {
  PyObject *list = PyList_New (info->count);
  for (unsigned i = 0; i < info->count; ++i) {
    PyObject *shape = PyTuple_New (info->ranks[i]);
    for (unsigned r = 0; r < info->ranks[i]; ++r)
      PyTuple_SET_ITEM (shape, r, PyLong_FromUnsignedLong (info->dims[i][r]));
    PyObject *dtype = PyUnicode_FromString (type_name_safe (info->types[i]));
    PyObject *pair = PyTuple_Pack (2, dtype, shape);
    Py_DECREF (dtype);
    Py_DECREF (shape);
    PyList_SET_ITEM (list, i, pair);
  }
  return list;
}

/* glue [(dtype, shape), ...] -> info (returns 0 / -1). */
static int wire_to_info (PyObject *list, ml_tensors_info_s *info) {
  if (!PyList_Check (list) || PyList_GET_SIZE (list) > ML_TENSOR_SIZE_LIMIT)
    return -1;
  memset (info, 0, sizeof (*info));
  info->count = (unsigned) PyList_GET_SIZE (list);
  for (unsigned i = 0; i < info->count; ++i) {
    PyObject *pair = PyList_GET_ITEM (list, i);
    PyObject *dtype = PyTuple_GetItem (pair, 0);
    PyObject *shape = PyTuple_GetItem (pair, 1);
    if (dtype == nullptr || shape == nullptr) {
      PyErr_Clear (); /* PyTuple_GetItem set IndexError */
      return -1;
    }
    info->types[i] = type_from_name (PyUnicode_AsUTF8 (dtype));
    if (info->types[i] == ML_TENSOR_TYPE_UNKNOWN) {
      PyErr_Clear (); /* non-string dtype: AsUTF8 may have raised */
      return -1;      /* partial spec (e.g. dtype "") — not representable */
    }
    info->ranks[i] = (unsigned) PyTuple_GET_SIZE (shape);
    if (info->ranks[i] > ML_TENSOR_RANK_LIMIT)
      return -1;
    for (unsigned r = 0; r < info->ranks[i]; ++r)
      info->dims[i][r] =
          (unsigned) PyLong_AsUnsignedLong (PyTuple_GET_ITEM (shape, r));
  }
  return 0;
}

/* --------------------------------------------------------- tensors_info_* */

int ml_tensors_info_create (ml_tensors_info_h *info) {
  if (!info)
    return ML_ERROR_INVALID_PARAMETER;
  *info = calloc (1, sizeof (ml_tensors_info_s));
  return *info ? ML_ERROR_NONE : ML_ERROR_OUT_OF_MEMORY;
}

int ml_tensors_info_destroy (ml_tensors_info_h info) {
  free (info);
  return ML_ERROR_NONE;
}

int ml_tensors_info_set_count (ml_tensors_info_h info, unsigned int count) {
  if (!info || count > ML_TENSOR_SIZE_LIMIT)
    return ML_ERROR_INVALID_PARAMETER;
  ((ml_tensors_info_s *) info)->count = count;
  return ML_ERROR_NONE;
}

int ml_tensors_info_get_count (ml_tensors_info_h info, unsigned int *count) {
  if (!info || !count)
    return ML_ERROR_INVALID_PARAMETER;
  *count = ((ml_tensors_info_s *) info)->count;
  return ML_ERROR_NONE;
}

int ml_tensors_info_set_tensor_type (ml_tensors_info_h info,
    unsigned int index, ml_tensor_type_e type) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || index >= s->count || type >= ML_TENSOR_TYPE_UNKNOWN)
    return ML_ERROR_INVALID_PARAMETER;
  s->types[index] = type;
  return ML_ERROR_NONE;
}

int ml_tensors_info_get_tensor_type (ml_tensors_info_h info,
    unsigned int index, ml_tensor_type_e *type) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || !type || index >= s->count)
    return ML_ERROR_INVALID_PARAMETER;
  *type = s->types[index];
  return ML_ERROR_NONE;
}

int ml_tensors_info_set_tensor_dimension (ml_tensors_info_h info,
    unsigned int index, unsigned int rank, const ml_tensor_dimension dim) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || index >= s->count || rank > ML_TENSOR_RANK_LIMIT)
    return ML_ERROR_INVALID_PARAMETER;
  s->ranks[index] = rank;
  for (unsigned r = 0; r < rank; ++r)
    s->dims[index][r] = dim[r];
  return ML_ERROR_NONE;
}

int ml_tensors_info_get_tensor_dimension (ml_tensors_info_h info,
    unsigned int index, unsigned int *rank, ml_tensor_dimension dim) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || !rank || index >= s->count)
    return ML_ERROR_INVALID_PARAMETER;
  *rank = s->ranks[index];
  for (unsigned r = 0; r < s->ranks[index]; ++r)
    dim[r] = s->dims[index][r];
  return ML_ERROR_NONE;
}

int ml_tensors_info_get_tensor_size (ml_tensors_info_h info,
    unsigned int index, size_t *size) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || !size || index >= s->count
      || s->types[index] >= ML_TENSOR_TYPE_UNKNOWN)
    return ML_ERROR_INVALID_PARAMETER;
  size_t n = type_sizes[s->types[index]];
  for (unsigned r = 0; r < s->ranks[index]; ++r)
    n *= s->dims[index][r];
  *size = n;
  return ML_ERROR_NONE;
}

/* --------------------------------------------------------- tensors_data_* */

int ml_tensors_data_create (ml_tensors_info_h info, ml_tensors_data_h *data) {
  auto *s = (ml_tensors_info_s *) info;
  if (!s || !data || s->count == 0)
    return ML_ERROR_INVALID_PARAMETER;
  auto *d = (ml_tensors_data_s *) calloc (1, sizeof (ml_tensors_data_s));
  if (!d)
    return ML_ERROR_OUT_OF_MEMORY;
  d->info = *s;
  for (unsigned i = 0; i < s->count; ++i) {
    size_t sz;
    ml_tensors_info_get_tensor_size (info, i, &sz);
    d->buffers[i] = calloc (1, sz ? sz : 1);
    d->sizes[i] = sz;
  }
  *data = d;
  return ML_ERROR_NONE;
}

int ml_tensors_data_destroy (ml_tensors_data_h data) {
  auto *d = (ml_tensors_data_s *) data;
  if (d) {
    for (unsigned i = 0; i < d->info.count; ++i)
      free (d->buffers[i]);
    free (d);
  }
  return ML_ERROR_NONE;
}

int ml_tensors_data_get_tensor_data (ml_tensors_data_h data,
    unsigned int index, void **raw, size_t *size) {
  auto *d = (ml_tensors_data_s *) data;
  if (!d || !raw || !size || index >= d->info.count)
    return ML_ERROR_INVALID_PARAMETER;
  *raw = d->buffers[index];
  *size = d->sizes[index];
  return ML_ERROR_NONE;
}

int ml_tensors_data_set_tensor_data (ml_tensors_data_h data,
    unsigned int index, const void *raw, size_t size) {
  auto *d = (ml_tensors_data_s *) data;
  if (!d || !raw || index >= d->info.count || size > d->sizes[index])
    return ML_ERROR_INVALID_PARAMETER;
  memcpy (d->buffers[index], raw, size);
  return ML_ERROR_NONE;
}

/* -------------------------------------------------------------- ml_single */

int ml_single_open (ml_single_h *single, const char *model,
    const char *framework, const char *custom, ml_tensors_info_h in_info) {
  if (!single || !model || !framework)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *info_arg;
  if (in_info != nullptr)
    info_arg = info_to_wire ((ml_tensors_info_s *) in_info);
  else {
    info_arg = Py_None;
    Py_INCREF (Py_None);
  }
  PyObject *res = glue_call ("single_open",
      Py_BuildValue ("(sssN)", framework, model, custom ? custom : "",
                     info_arg));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  auto *s = (ml_single_s *) malloc (sizeof (ml_single_s));
  if (s == nullptr) {
    Py_DECREF (res);
    return ML_ERROR_OUT_OF_MEMORY;
  }
  s->obj = res;
  *single = s;
  return ML_ERROR_NONE;
}

int ml_single_close (ml_single_h single) {
  auto *s = (ml_single_s *) single;
  if (!s)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (gil.ok) {
    PyObject *res = glue_call ("single_close", Py_BuildValue ("(O)", s->obj));
    Py_XDECREF (res);
    Py_DECREF (s->obj);
  }
  free (s);
  return ML_ERROR_NONE;
}

int ml_single_invoke (ml_single_h single, const ml_tensors_data_h in,
    ml_tensors_data_h *out) {
  auto *s = (ml_single_s *) single;
  auto *d = (ml_tensors_data_s *) in;
  if (!s || !d || !out)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("single_invoke",
      Py_BuildValue ("(ON)", s->obj, data_to_wire (d)));
  if (res == nullptr)
    return g_last_err; /* TIMED_OUT / INVALID_PARAMETER / STREAMS_PIPE */
  ml_tensors_data_s *od = wire_to_data (res);
  Py_DECREF (res);
  if (od == nullptr)
    return ML_ERROR_UNKNOWN;
  *out = od;
  return ML_ERROR_NONE;
}

static int single_info (const char *fn, ml_single_h single,
    ml_tensors_info_h *info) {
  auto *s = (ml_single_s *) single;
  if (!s || !info)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call (fn, Py_BuildValue ("(O)", s->obj));
  if (res == nullptr || res == Py_None) {
    Py_XDECREF (res);
    return ML_ERROR_TRY_AGAIN; /* spec not negotiated yet */
  }
  int rc = ml_tensors_info_create (info);
  if (rc == ML_ERROR_NONE &&
      wire_to_info (res, (ml_tensors_info_s *) *info) != 0) {
    ml_tensors_info_destroy (*info);
    rc = ML_ERROR_UNKNOWN;
  }
  Py_DECREF (res);
  return rc;
}

int ml_single_get_input_info (ml_single_h single, ml_tensors_info_h *info) {
  return single_info ("single_input_info", single, info);
}

int ml_single_get_output_info (ml_single_h single, ml_tensors_info_h *info) {
  return single_info ("single_output_info", single, info);
}

int ml_single_set_input_info (ml_single_h single, ml_tensors_info_h info) {
  auto *s = (ml_single_s *) single;
  if (!s || !info)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("single_set_input_info",
      Py_BuildValue ("(ON)", s->obj, info_to_wire ((ml_tensors_info_s *) info)));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_single_set_timeout (ml_single_h single, unsigned int ms) {
  auto *s = (ml_single_s *) single;
  if (!s)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("single_set_timeout",
      Py_BuildValue ("(OI)", s->obj, ms));
  Py_XDECREF (res);
  return ML_ERROR_NONE;
}

/* ------------------------------------------------------------ ml_pipeline */

int ml_pipeline_construct (const char *description, ml_pipeline_h *pipe) {
  if (!description || !pipe)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res =
      glue_call ("pipeline_construct", Py_BuildValue ("(s)", description));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  auto *p = (ml_pipeline_s *) malloc (sizeof (ml_pipeline_s));
  if (p == nullptr) {
    Py_DECREF (res);
    return ML_ERROR_OUT_OF_MEMORY;
  }
  p->obj = res;
  *pipe = p;
  return ML_ERROR_NONE;
}

static int pipe_call0 (const char *fn, ml_pipeline_h pipe) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call (fn, Py_BuildValue ("(O)", p->obj));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_pipeline_start (ml_pipeline_h pipe) {
  return pipe_call0 ("pipeline_start", pipe);
}

int ml_pipeline_stop (ml_pipeline_h pipe) {
  return pipe_call0 ("pipeline_stop", pipe);
}

int ml_pipeline_destroy (ml_pipeline_h pipe) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p)
    return ML_ERROR_INVALID_PARAMETER;
  int rc = pipe_call0 ("pipeline_destroy", pipe);
  Gil gil;
  if (gil.ok)
    Py_DECREF (p->obj);
  free (p);
  return rc;
}

int ml_pipeline_get_state (ml_pipeline_h pipe, ml_pipeline_state_e *state) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p || !state)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_get_state", Py_BuildValue ("(O)", p->obj));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  const char *st = PyUnicode_AsUTF8 (res);
  if (st == nullptr) {
    PyErr_Clear ();
    Py_DECREF (res);
    return ML_ERROR_UNKNOWN;
  }
  if (!strcmp (st, "PLAYING"))
    *state = ML_PIPELINE_STATE_PLAYING;
  else if (!strcmp (st, "NULL"))
    *state = ML_PIPELINE_STATE_NULL;
  else if (!strcmp (st, "READY"))
    *state = ML_PIPELINE_STATE_READY;
  else if (!strcmp (st, "EOS"))
    *state = ML_PIPELINE_STATE_EOS;
  else
    *state = ML_PIPELINE_STATE_UNKNOWN;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_pipeline_wait (ml_pipeline_h pipe, unsigned int timeout_ms) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_wait",
      Py_BuildValue ("(OI)", p->obj, timeout_ms));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  int done = PyObject_IsTrue (res);
  Py_DECREF (res);
  return done ? ML_ERROR_NONE : ML_ERROR_TIMED_OUT;
}

/* Sink callbacks: a PyCFunction whose self-capsule carries the C callback;
 * the glue wraps it so it receives [(bytes, dtype, shape), ...]. */

struct sink_ctx {
  ml_pipeline_sink_cb cb;
  void *user_data;
};

static PyObject *sink_trampoline (PyObject *self, PyObject *args) {
  auto *ctx = (sink_ctx *) PyCapsule_GetPointer (self, "nns.sink_ctx");
  PyObject *wire;
  if (ctx == nullptr || !PyArg_ParseTuple (args, "O", &wire))
    return nullptr;
  ml_tensors_data_s *d = wire_to_data (wire);
  if (d != nullptr) {
    ctx->cb ((ml_tensors_data_h) d, (ml_tensors_info_h) &d->info,
             ctx->user_data);
    ml_tensors_data_destroy (d);
  }
  Py_RETURN_NONE;
}

static void sink_ctx_free (PyObject *capsule) {
  free (PyCapsule_GetPointer (capsule, "nns.sink_ctx"));
}

static PyMethodDef sink_trampoline_def = {
  "nns_sink_trampoline", sink_trampoline, METH_VARARGS,
  "C sink-callback trampoline",
};

int ml_pipeline_sink_register (ml_pipeline_h pipe, const char *sink_name,
    ml_pipeline_sink_cb cb, void *user_data, ml_pipeline_sink_h *sink) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p || !sink_name || !cb || !sink)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  auto *ctx = (sink_ctx *) malloc (sizeof (sink_ctx));
  if (ctx == nullptr)
    return ML_ERROR_OUT_OF_MEMORY;
  ctx->cb = cb;
  ctx->user_data = user_data;
  PyObject *capsule = PyCapsule_New (ctx, "nns.sink_ctx", sink_ctx_free);
  PyObject *tramp = PyCFunction_New (&sink_trampoline_def, capsule);
  Py_DECREF (capsule);
  PyObject *py_cb = glue_call ("pipeline_sink_register",
      Py_BuildValue ("(OsO)", p->obj, sink_name, tramp));
  if (py_cb == nullptr) {
    Py_DECREF (tramp);
    return ML_ERROR_STREAMS_PIPE;
  }
  auto *h = new ml_pipeline_sink_s ();
  h->pipe = p;
  h->name = sink_name;
  h->py_cb = py_cb;
  h->trampoline = tramp;
  *sink = h;
  return ML_ERROR_NONE;
}

int ml_pipeline_sink_unregister (ml_pipeline_sink_h sink) {
  auto *h = (ml_pipeline_sink_s *) sink;
  if (!h)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (gil.ok) {
    PyObject *res = glue_call ("pipeline_sink_unregister",
        Py_BuildValue ("(OsO)", h->pipe->obj, h->name.c_str (), h->py_cb));
    Py_XDECREF (res);
    Py_DECREF (h->py_cb);
    Py_DECREF (h->trampoline);
  }
  delete h;
  return ML_ERROR_NONE;
}

int ml_pipeline_src_input_data (ml_pipeline_h pipe, const char *src_name,
    const ml_tensors_data_h data) {
  auto *p = (ml_pipeline_s *) pipe;
  auto *d = (ml_tensors_data_s *) data;
  if (!p || !src_name || !d)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_src_input",
      Py_BuildValue ("(OsN)", p->obj, src_name, data_to_wire (d)));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_pipeline_src_input_eos (ml_pipeline_h pipe, const char *src_name) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p || !src_name)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_src_eos",
      Py_BuildValue ("(Os)", p->obj, src_name));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_pipeline_switch_select (ml_pipeline_h pipe, const char *switch_name,
    const char *pad_name) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p || !switch_name || !pad_name)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_switch_select",
      Py_BuildValue ("(Oss)", p->obj, switch_name, pad_name));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}

int ml_pipeline_valve_set_open (ml_pipeline_h pipe, const char *valve_name,
    int open) {
  auto *p = (ml_pipeline_s *) pipe;
  if (!p || !valve_name)
    return ML_ERROR_INVALID_PARAMETER;
  Gil gil;
  if (!gil.ok)
    return ML_ERROR_NOT_SUPPORTED;
  PyObject *res = glue_call ("pipeline_valve_set_open",
      Py_BuildValue ("(OsO)", p->obj, valve_name, open ? Py_True : Py_False));
  if (res == nullptr)
    return ML_ERROR_STREAMS_PIPE;
  Py_DECREF (res);
  return ML_ERROR_NONE;
}
