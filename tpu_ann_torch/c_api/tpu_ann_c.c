/* tpu_ann_torch C API implementation — embeds CPython and marshals flat
 * buffers through tpu_ann_torch/capi.py (see tpu_ann_c.h for the design
 * rationale vs faiss's per-class c_api/ wrappers).
 *
 * Marshalling contract: handles are small integers minted by capi.py,
 * carried here as opaque pointers; buffers cross as memoryviews over
 * caller-owned memory (zero-copy in, results written in place).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>
#include <string.h>

#include "tpu_ann_c.h"

static PyObject *g_capi = NULL;     /* tpu_ann_torch.capi module */
static int g_we_initialized = 0;    /* we own the interpreter */
static char g_err[4096];

const char *tpu_ann_last_error(void) { return g_err; }

static void clear_err(void) { g_err[0] = '\0'; }

/* Capture the pending Python exception into g_err. Must hold the GIL. */
static void capture_py_error(void)
{
    PyObject *t = NULL, *v = NULL, *tb = NULL;
    PyErr_Fetch(&t, &v, &tb);
    PyErr_NormalizeException(&t, &v, &tb);
    if (v) {
        PyObject *s = PyObject_Str(v);
        if (s) {
            const char *msg = PyUnicode_AsUTF8(s);
            snprintf(g_err, sizeof(g_err), "%s", msg ? msg : "<unprintable>");
            Py_DECREF(s);
        }
    } else {
        snprintf(g_err, sizeof(g_err), "unknown python error");
    }
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
}

int tpu_ann_init(char *backend_out, size_t backend_len)
{
    clear_err();
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = 1;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    if (g_capi == NULL) {
        g_capi = PyImport_ImportModule("tpu_ann_torch.capi");
        if (g_capi == NULL) {
            capture_py_error();
            strncat(g_err, " (is the tpu_ann_torch package on PYTHONPATH?)",
                    sizeof(g_err) - strlen(g_err) - 1);
            goto out;
        }
    }
    {
        PyObject *b = PyObject_CallMethod(g_capi, "configure_device",
                                          NULL);
        if (b == NULL) { capture_py_error(); goto out; }
        if (backend_out != NULL && backend_len > 0) {
            const char *name = PyUnicode_AsUTF8(b);
            snprintf(backend_out, backend_len, "%s", name ? name : "?");
        }
        Py_DECREF(b);
    }
    rc = 0;
out:
    PyGILState_Release(st);
    if (rc == 0 && g_we_initialized == 1) {
        /* Release the GIL held since Py_InitializeEx so any C thread
         * can enter through PyGILState_Ensure. Do this exactly once. */
        PyEval_SaveThread();
        g_we_initialized = 2;
    }
    return rc;
}

int tpu_ann_shutdown(void)
{
    clear_err();
    if (g_we_initialized == 2) {
        PyGILState_Ensure();
        Py_XDECREF(g_capi);
        g_capi = NULL;
        Py_Finalize();
        g_we_initialized = 0;
    }
    return 0;
}

/* ---- call helpers --------------------------------------------------- */

/* Call capi.<name>(fmt-args); returns new ref or NULL (g_err set).
 * Must hold the GIL. */
static PyObject *capi_call(const char *name, const char *fmt, ...)
{
    if (g_capi == NULL) {
        snprintf(g_err, sizeof(g_err), "tpu_ann_init() not called");
        return NULL;
    }
    PyObject *meth = PyObject_GetAttrString(g_capi, name);
    if (meth == NULL) { capture_py_error(); return NULL; }
    va_list va;
    va_start(va, fmt);
    PyObject *args = Py_VaBuildValue(fmt, va);
    va_end(va);
    if (args == NULL) { Py_DECREF(meth); capture_py_error(); return NULL; }
    if (!PyTuple_Check(args)) {  /* single arg: wrap */
        PyObject *t = PyTuple_Pack(1, args);
        Py_DECREF(args);
        args = t;
        if (args == NULL) { Py_DECREF(meth); capture_py_error(); return NULL; }
    }
    PyObject *res = PyObject_CallObject(meth, args);
    Py_DECREF(meth);
    Py_DECREF(args);
    if (res == NULL) capture_py_error();
    return res;
}

/* Run fn-call returning a handle int; stores into *out as fake ptr. */
static int call_ret_handle(PyObject *res, void **out)
{
    if (res == NULL) return -1;
    long long h = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (h == -1 && PyErr_Occurred()) { capture_py_error(); return -1; }
    *out = (void *)(intptr_t)h;
    return 0;
}

static int call_ret_void(PyObject *res)
{
    if (res == NULL) return -1;
    Py_DECREF(res);
    return 0;
}

static int call_ret_i64(PyObject *res, int64_t *out)
{
    if (res == NULL) return -1;
    long long v = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (v == -1 && PyErr_Occurred()) { capture_py_error(); return -1; }
    *out = (int64_t)v;
    return 0;
}

#define HANDLE(p) ((long long)(intptr_t)(p))

static PyObject *mv_ro(const void *p, Py_ssize_t nbytes)
{
    return PyMemoryView_FromMemory((char *)p, nbytes, PyBUF_READ);
}

static PyObject *mv_rw(void *p, Py_ssize_t nbytes)
{
    return PyMemoryView_FromMemory((char *)p, nbytes, PyBUF_WRITE);
}

#define BEGIN  PyGILState_STATE _st = PyGILState_Ensure(); clear_err()
#define END(rc) PyGILState_Release(_st); return (rc)

/* ---- construction / io ---------------------------------------------- */

int tpu_ann_index_factory(int d, const char *description, int metric,
                          tpu_ann_index **out)
{
    BEGIN;
    int rc = call_ret_handle(
        capi_call("factory", "(isi)", d, description, metric),
        (void **)out);
    END(rc);
}

int tpu_ann_index_free(tpu_ann_index *index)
{
    BEGIN;
    int rc = call_ret_void(capi_call("free", "(L)", HANDLE(index)));
    END(rc);
}

int tpu_ann_write_index(const tpu_ann_index *index, const char *path)
{
    BEGIN;
    int rc = call_ret_void(
        capi_call("write_index", "(Ls)", HANDLE(index), path));
    END(rc);
}

int tpu_ann_read_index(const char *path, int mmap, tpu_ann_index **out)
{
    BEGIN;
    int rc = call_ret_handle(capi_call("read_index", "(si)", path, mmap),
                             (void **)out);
    END(rc);
}

/* ---- properties ------------------------------------------------------ */

int tpu_ann_index_d(const tpu_ann_index *index, int *out)
{
    BEGIN;
    int64_t v;
    int rc = call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v);
    if (rc == 0) *out = (int)v;
    END(rc);
}

int tpu_ann_index_ntotal(const tpu_ann_index *index, tpu_ann_idx_t *out)
{
    BEGIN;
    int rc = call_ret_i64(capi_call("ntotal", "(L)", HANDLE(index)), out);
    END(rc);
}

int tpu_ann_index_is_trained(const tpu_ann_index *index, int *out)
{
    BEGIN;
    int64_t v;
    int rc = call_ret_i64(capi_call("is_trained", "(L)", HANDLE(index)),
                          &v);
    if (rc == 0) *out = (int)v;
    END(rc);
}

int tpu_ann_index_metric_type(const tpu_ann_index *index, int *out)
{
    BEGIN;
    int64_t v;
    int rc = call_ret_i64(capi_call("metric_type", "(L)", HANDLE(index)),
                          &v);
    if (rc == 0) *out = (int)v;
    END(rc);
}

int tpu_ann_index_set_parameter(tpu_ann_index *index, const char *name,
                                double value)
{
    BEGIN;
    int rc = call_ret_void(
        capi_call("set_parameter", "(Lsd)", HANDLE(index), name, value));
    END(rc);
}

/* ---- vectors --------------------------------------------------------- */

int tpu_ann_index_train(tpu_ann_index *index, tpu_ann_idx_t n,
                        const float *x)
{
    BEGIN;
    int d = 0, rc = -1;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto out;
        d = (int)v;
    }
    rc = call_ret_void(capi_call(
        "train", "(LNLi)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, d));
out:
    END(rc);
}

int tpu_ann_index_add(tpu_ann_index *index, tpu_ann_idx_t n,
                      const float *x)
{
    BEGIN;
    int d = 0, rc = -1;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto out;
        d = (int)v;
    }
    rc = call_ret_void(capi_call(
        "add", "(LNLi)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, d));
out:
    END(rc);
}

int tpu_ann_index_add_with_ids(tpu_ann_index *index, tpu_ann_idx_t n,
                               const float *x, const tpu_ann_idx_t *ids)
{
    BEGIN;
    int d = 0, rc = -1;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto out;
        d = (int)v;
    }
    rc = call_ret_void(capi_call(
        "add_with_ids", "(LNLiN)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, d,
        mv_ro(ids, (Py_ssize_t)n * sizeof(tpu_ann_idx_t))));
out:
    END(rc);
}

int tpu_ann_index_search(tpu_ann_index *index, tpu_ann_idx_t n,
                         const float *x, tpu_ann_idx_t k,
                         float *distances, tpu_ann_idx_t *labels)
{
    BEGIN;
    int d = 0, rc = -1;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto out;
        d = (int)v;
    }
    rc = call_ret_void(capi_call(
        "search", "(LNLiLNN)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, d,
        (long long)k,
        mv_rw(distances, (Py_ssize_t)n * k * sizeof(float)),
        mv_rw(labels, (Py_ssize_t)n * k * sizeof(tpu_ann_idx_t))));
out:
    END(rc);
}

int tpu_ann_index_range_search(tpu_ann_index *index, tpu_ann_idx_t n,
                               const float *x, float radius,
                               tpu_ann_range_result **res,
                               tpu_ann_idx_t *nnz)
{
    BEGIN;
    int d = 0, rc = -1;
    void *rh = NULL;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto out;
        d = (int)v;
    }
    rc = call_ret_handle(capi_call(
        "range_search", "(LNLid)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, d,
        (double)radius), &rh);
    if (rc != 0) goto out;
    *res = (tpu_ann_range_result *)rh;
    rc = call_ret_i64(capi_call("range_result_nnz", "(L)", HANDLE(rh)),
                      nnz);
out:
    END(rc);
}

int tpu_ann_range_result_fetch(tpu_ann_range_result *res, tpu_ann_idx_t n,
                               tpu_ann_idx_t *lims, float *distances,
                               tpu_ann_idx_t *labels)
{
    BEGIN;
    int rc = -1;
    int64_t nnz;
    if (call_ret_i64(capi_call("range_result_nnz", "(L)", HANDLE(res)),
                     &nnz) != 0)
        goto out;
    rc = call_ret_void(capi_call(
        "range_result_fetch", "(LLNNN)", HANDLE(res), (long long)n,
        mv_rw(lims, (Py_ssize_t)(n + 1) * sizeof(tpu_ann_idx_t)),
        mv_rw(distances, (Py_ssize_t)nnz * sizeof(float)),
        mv_rw(labels, (Py_ssize_t)nnz * sizeof(tpu_ann_idx_t))));
out:
    END(rc);
}

int tpu_ann_range_result_free(tpu_ann_range_result *res)
{
    BEGIN;
    int rc = call_ret_void(capi_call("free", "(L)", HANDLE(res)));
    END(rc);
}

int tpu_ann_index_reconstruct(tpu_ann_index *index, tpu_ann_idx_t key,
                              float *out)
{
    BEGIN;
    int d = 0, rc = -1;
    {
        int64_t v;
        if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &v) != 0)
            goto done;
        d = (int)v;
    }
    rc = call_ret_void(capi_call(
        "reconstruct", "(LLN)", HANDLE(index), (long long)key,
        mv_rw(out, (Py_ssize_t)d * sizeof(float))));
done:
    END(rc);
}

int tpu_ann_index_remove_ids(tpu_ann_index *index, tpu_ann_idx_t n,
                             const tpu_ann_idx_t *ids,
                             tpu_ann_idx_t *n_removed)
{
    BEGIN;
    int rc = call_ret_i64(capi_call(
        "remove_ids", "(LNL)", HANDLE(index),
        mv_ro(ids, (Py_ssize_t)n * sizeof(tpu_ann_idx_t)),
        (long long)n), n_removed);
    END(rc);
}

/* ---- standalone codec ------------------------------------------------ */

int tpu_ann_index_sa_code_size(const tpu_ann_index *index, size_t *out)
{
    BEGIN;
    int64_t v;
    int rc = call_ret_i64(capi_call("sa_code_size", "(L)", HANDLE(index)),
                          &v);
    if (rc == 0) *out = (size_t)v;
    END(rc);
}

int tpu_ann_index_sa_encode(tpu_ann_index *index, tpu_ann_idx_t n,
                            const float *x, uint8_t *codes)
{
    BEGIN;
    int rc = -1;
    int64_t d, cs;
    if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &d) != 0)
        goto out;
    if (call_ret_i64(capi_call("sa_code_size", "(L)", HANDLE(index)),
                     &cs) != 0)
        goto out;
    rc = call_ret_void(capi_call(
        "sa_encode", "(LNLiN)", HANDLE(index),
        mv_ro(x, (Py_ssize_t)n * d * sizeof(float)), (long long)n, (int)d,
        mv_rw(codes, (Py_ssize_t)n * cs)));
out:
    END(rc);
}

int tpu_ann_index_sa_decode(tpu_ann_index *index, tpu_ann_idx_t n,
                            const uint8_t *codes, float *x)
{
    BEGIN;
    int rc = -1;
    int64_t d, cs;
    if (call_ret_i64(capi_call("dim", "(L)", HANDLE(index)), &d) != 0)
        goto out;
    if (call_ret_i64(capi_call("sa_code_size", "(L)", HANDLE(index)),
                     &cs) != 0)
        goto out;
    rc = call_ret_void(capi_call(
        "sa_decode", "(LNLN)", HANDLE(index),
        mv_ro(codes, (Py_ssize_t)n * cs), (long long)n,
        mv_rw(x, (Py_ssize_t)n * d * sizeof(float))));
out:
    END(rc);
}
