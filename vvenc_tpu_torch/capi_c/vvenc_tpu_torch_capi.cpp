// C API implementation: embeds CPython and drives vvenc_tpu_torch.capi,
// the PyTorch/CUDA encoder.
//
// Reference analog: vvenc source/Lib/vvenc/vvenc.cpp (the C functions over
// VVEncImpl).  Here the "impl" is the Python package; this layer owns the
// interpreter lifecycle, the GIL, and buffer marshalling, giving C/C++
// applications the same create/open/encode/close workflow.  It exports
// the C symbols of vvenc_tpu.h (a copy of capi/vvenc_tpu.h), so a client
// of that header links against either library.  The encoder runs on the
// card unless the params string asks for the CPU ("device=cpu").
//
// Built at first use by vvenc_tpu_torch.capi_c.build():
//   g++ -O2 -shared -fPIC -std=c++17 -I<python include> -I<this dir>
//       vvenc_tpu_torch_capi.cpp -L<LIBDIR> -lpython3.X
//       -o libvvenc_tpu_torch_capi.so

#include "vvenc_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstring>
#include <string>

struct vvenc_tpu_encoder {
  long handle;
  int width;
  int height;
  std::string last_au;    // returned buffer storage
  std::string last_hdrs;  // get_headers storage
  vvenc_tpu_rec_cb rec_cb = nullptr;
  void *rec_ctx = nullptr;
  std::string rec_y, rec_u, rec_v;  // callback plane storage
};

namespace {

bool g_py_owner = false;

bool ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_py_owner = true;
    // release the GIL acquired by initialization so PyGILState works
    PyEval_SaveThread();
  }
  return true;
}

PyObject *capi_module() {
  return PyImport_ImportModule("vvenc_tpu_torch.capi");
}

// drain newly reconstructed pictures and invoke the callback (requires
// the GIL to be held by the caller).  Returns VVENC_TPU_OK, or
// VVENC_TPU_ERR_UNSPECIFIED after printing the Python error when the
// module or its call fails (the pictures would otherwise be lost
// silently).
int deliver_recons(vvenc_tpu_encoder *enc) {
  if (!enc->rec_cb) return VVENC_TPU_OK;
  PyObject *mod = capi_module();
  if (!mod) {
    PyErr_Print();
    return VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyObject *lst = PyObject_CallMethod(mod, "capi_take_recons", "l",
                                      enc->handle);
  int ret = VVENC_TPU_OK;
  if (!lst || !PyList_Check(lst)) {
    if (PyErr_Occurred()) PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  } else {
    for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
      PyObject *t = PyList_GetItem(lst, i);  // (poc, w, h, y, u, v)
      long poc = PyLong_AsLong(PyTuple_GetItem(t, 0));
      long w = PyLong_AsLong(PyTuple_GetItem(t, 1));
      long h = PyLong_AsLong(PyTuple_GetItem(t, 2));
      char *yb, *ub, *vb;
      Py_ssize_t yl, ul, vl;
      PyBytes_AsStringAndSize(PyTuple_GetItem(t, 3), &yb, &yl);
      PyBytes_AsStringAndSize(PyTuple_GetItem(t, 4), &ub, &ul);
      PyBytes_AsStringAndSize(PyTuple_GetItem(t, 5), &vb, &vl);
      enc->rec_y.assign(yb, size_t(yl));
      enc->rec_u.assign(ub, size_t(ul));
      enc->rec_v.assign(vb, size_t(vl));
      enc->rec_cb(enc->rec_ctx, int(poc),
                  reinterpret_cast<const uint16_t *>(enc->rec_y.data()),
                  reinterpret_cast<const uint16_t *>(enc->rec_u.data()),
                  reinterpret_cast<const uint16_t *>(enc->rec_v.data()),
                  int(w), int(h));
    }
  }
  Py_XDECREF(lst);
  Py_DECREF(mod);
  return ret;
}

}  // namespace

extern "C" {

vvenc_tpu_encoder *vvenc_tpu_encoder_open(const char *params) {
  if (!params || !ensure_python()) return nullptr;
  PyGILState_STATE g = PyGILState_Ensure();
  vvenc_tpu_encoder *enc = nullptr;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_open", "s", params);
    if (r && PyLong_Check(r)) {
      enc = new vvenc_tpu_encoder();
      enc->handle = PyLong_AsLong(r);
      // read back width/height for buffer sizing
      int w = 0, h = 0;
      const char *p = params;
      while (p && *p) {
        if (!strncmp(p, "width=", 6)) w = atoi(p + 6);
        if (!strncmp(p, "height=", 7)) h = atoi(p + 7);
        p = strchr(p, ';');
        if (p) ++p;
      }
      enc->width = w;
      enc->height = h;
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    delete enc;
    enc = nullptr;
  }
  PyGILState_Release(g);
  return enc;
}

int vvenc_tpu_encode(vvenc_tpu_encoder *enc, const uint8_t *y,
                     const uint8_t *u, const uint8_t *v,
                     const uint8_t **au, size_t *au_len) {
  if (!enc || !y || !u || !v || !au || !au_len)
    return VVENC_TPU_ERR_PARAMETER;
  const size_t ysz = size_t(enc->width) * enc->height;
  const size_t csz = ysz / 4;
  PyGILState_STATE g = PyGILState_Ensure();
  int ret = VVENC_TPU_ERR_UNSPECIFIED;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(
        mod, "capi_encode", "ly#y#y#", enc->handle,
        reinterpret_cast<const char *>(y), (Py_ssize_t)ysz,
        reinterpret_cast<const char *>(u), (Py_ssize_t)csz,
        reinterpret_cast<const char *>(v), (Py_ssize_t)csz);
    if (r && PyBytes_Check(r)) {
      enc->last_au.assign(PyBytes_AsString(r),
                          size_t(PyBytes_Size(r)));
      *au = reinterpret_cast<const uint8_t *>(enc->last_au.data());
      *au_len = enc->last_au.size();
      ret = VVENC_TPU_OK;
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (ret == VVENC_TPU_OK) ret = deliver_recons(enc);
  if (PyErr_Occurred()) {
    PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyGILState_Release(g);
  return ret;
}

int vvenc_tpu_flush(vvenc_tpu_encoder *enc, const uint8_t **au,
                    size_t *au_len) {
  if (!enc || !au || !au_len) return VVENC_TPU_ERR_PARAMETER;
  PyGILState_STATE g = PyGILState_Ensure();
  int ret = VVENC_TPU_ERR_UNSPECIFIED;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_flush", "l", enc->handle);
    if (r && PyBytes_Check(r)) {
      enc->last_au.assign(PyBytes_AsString(r),
                          size_t(PyBytes_Size(r)));
      *au = reinterpret_cast<const uint8_t *>(enc->last_au.data());
      *au_len = enc->last_au.size();
      ret = VVENC_TPU_OK;
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (ret == VVENC_TPU_OK) ret = deliver_recons(enc);
  if (PyErr_Occurred()) {
    PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyGILState_Release(g);
  return ret;
}

int vvenc_tpu_get_headers(vvenc_tpu_encoder *enc, const uint8_t **buf,
                          size_t *len) {
  if (!enc || !buf || !len) return VVENC_TPU_ERR_PARAMETER;
  PyGILState_STATE g = PyGILState_Ensure();
  int ret = VVENC_TPU_ERR_UNSPECIFIED;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_get_headers", "l",
                                      enc->handle);
    if (r && PyBytes_Check(r)) {
      enc->last_hdrs.assign(PyBytes_AsString(r), size_t(PyBytes_Size(r)));
      *buf = reinterpret_cast<const uint8_t *>(enc->last_hdrs.data());
      *len = enc->last_hdrs.size();
      ret = VVENC_TPU_OK;
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyGILState_Release(g);
  return ret;
}

int vvenc_tpu_reconfig(vvenc_tpu_encoder *enc, const char *params) {
  if (!enc || !params) return VVENC_TPU_ERR_PARAMETER;
  PyGILState_STATE g = PyGILState_Ensure();
  int ret = VVENC_TPU_ERR_UNSPECIFIED;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_reconfig", "ls",
                                      enc->handle, params);
    if (r && PyLong_Check(r)) {
      long rc = PyLong_AsLong(r);
      ret = rc == 0 ? VVENC_TPU_OK
                    : (rc == -11 ? VVENC_TPU_ERR_RESTART_REQUIRED
                                 : VVENC_TPU_ERR_PARAMETER);
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyGILState_Release(g);
  return ret;
}

int vvenc_tpu_set_rec_callback(vvenc_tpu_encoder *enc, vvenc_tpu_rec_cb cb,
                               void *ctx) {
  if (!enc) return VVENC_TPU_ERR_PARAMETER;
  enc->rec_cb = cb;
  enc->rec_ctx = ctx;
  return VVENC_TPU_OK;
}

int vvenc_tpu_init_pass(vvenc_tpu_encoder *enc, int pass,
                        const char *stats_file) {
  if (!enc || !stats_file) return VVENC_TPU_ERR_PARAMETER;
  PyGILState_STATE g = PyGILState_Ensure();
  int ret = VVENC_TPU_ERR_UNSPECIFIED;
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_init_pass", "lis",
                                      enc->handle, pass, stats_file);
    if (r && PyLong_Check(r)) {
      ret = PyLong_AsLong(r) == 0 ? VVENC_TPU_OK : VVENC_TPU_ERR_PARAMETER;
    }
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) {
    PyErr_Print();
    ret = VVENC_TPU_ERR_UNSPECIFIED;
  }
  PyGILState_Release(g);
  return ret;
}

int vvenc_tpu_encoder_close(vvenc_tpu_encoder *enc) {
  if (!enc) return VVENC_TPU_ERR_PARAMETER;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *mod = capi_module();
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "capi_close", "l", enc->handle);
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  PyErr_Clear();
  PyGILState_Release(g);
  delete enc;
  return VVENC_TPU_OK;
}

const char *vvenc_tpu_version(void) { return "vvenc_tpu_torch-0.1"; }

}  // extern "C"
