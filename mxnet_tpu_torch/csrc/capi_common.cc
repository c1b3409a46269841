// Shared C-ABI plumbing of the port's C library (libmxtpu_torch_capi):
// src/capi_common.cc with one change, the shim it drives is
// mxnet_tpu_torch.capi_shim.  See src/capi_common.h.
#include "capi_common.h"

#include <cstdarg>
#include <mutex>

namespace mxtpu_capi {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    if (PyObject* s = PyObject_Str(value)) {
      if (const char* c = PyUnicode_AsUTF8(s)) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

namespace {
std::once_flag g_init_once;
}

void ensure_python() {
  std::call_once(g_init_once, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL acquired by Py_Initialize so PyGILState_Ensure
      // works uniformly from any thread
      PyEval_SaveThread();
    }
  });
}

PyObject* shim() {
  static PyObject* mod = nullptr;  // accessed under the GIL only
  if (!mod) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.capi_shim");
  }
  return mod;
}

PyObject* call_shim(const char* fn, const char* fmt, ...) {
  PyObject* mod = shim();
  if (!mod) {
    set_error_from_python();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject* callable = PyObject_GetAttrString(mod, fn);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject* res = nullptr;
  if (callable && args) res = PyObject_CallObject(callable, args);
  Py_XDECREF(args);
  Py_XDECREF(callable);
  if (!res) set_error_from_python();
  return res;
}

}  // namespace mxtpu_capi

extern "C" const char* MXTPUGetLastError(void) {
  return mxtpu_capi::g_last_error.c_str();
}
