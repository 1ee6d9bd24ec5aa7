/* tpu_ann_torch C API — the C handle of the PyTorch / CUDA package,
 * function for function the header of the JAX package's c_api/ (same
 * names, same signatures: a C program written against one builds against
 * either library unchanged). C counterpart of faiss's c_api/
 * (Index_c.h:72-128 train/add/search surface, index_factory_c.h:24,
 * index_io_c.h, AutoTune_c.h ParameterSpace).
 *
 * Design: instead of one hand-written wrapper pair per index class
 * (~5.6k LoC in the reference), the library embeds CPython and reaches
 * the whole index zoo through `index_factory` strings — every class the
 * factory grammar spells (IVF*, HNSW*, PQ/SQ/RQ/LSH, transforms,
 * refine, IDMap, ...) is constructible and searchable from C with one
 * opaque handle type.
 *
 * Thread safety: every call acquires the GIL; the library may be used
 * from multiple C threads.
 *
 * All functions return 0 on success, -1 on error (then
 * tpu_ann_last_error() returns a message valid until the next call).
 */
#ifndef TPU_ANN_C_H
#define TPU_ANN_C_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int64_t tpu_ann_idx_t;   /* faiss idx_t analog */
typedef struct tpu_ann_index tpu_ann_index;          /* opaque */
typedef struct tpu_ann_range_result tpu_ann_range_result;  /* opaque */

enum {
    TPU_ANN_METRIC_INNER_PRODUCT = 0,
    TPU_ANN_METRIC_L2 = 1,
};

/* ---- runtime ------------------------------------------------------ */

/* Initialize the embedded interpreter (no-op if the process already
 * hosts Python, e.g. when loaded from a Python program via dlopen) and
 * select the device: TPU_ANN_TORCH_DEVICE ("cuda" when unset, "cuda:1",
 * "cpu"). Fails when CUDA is asked for and there is none.
 * `backend_out` (optional, may be NULL) receives the device's name
 * ("cuda:0 NVIDIA H100 80GB HBM3", "cpu"), truncated to backend_len. */
int tpu_ann_init(char *backend_out, size_t backend_len);

/* Finalize the interpreter IF this library started it. */
int tpu_ann_shutdown(void);

/* Message for the last failed call (empty string if none). */
const char *tpu_ann_last_error(void);

/* ---- construction / io -------------------------------------------- */

int tpu_ann_index_factory(int d, const char *description, int metric,
                          tpu_ann_index **out);
int tpu_ann_index_free(tpu_ann_index *index);
int tpu_ann_write_index(const tpu_ann_index *index, const char *path);
int tpu_ann_read_index(const char *path, int mmap, tpu_ann_index **out);

/* ---- properties ---------------------------------------------------- */

int tpu_ann_index_d(const tpu_ann_index *index, int *out);
int tpu_ann_index_ntotal(const tpu_ann_index *index, tpu_ann_idx_t *out);
int tpu_ann_index_is_trained(const tpu_ann_index *index, int *out);
int tpu_ann_index_metric_type(const tpu_ann_index *index, int *out);

/* Runtime parameter by name ("nprobe", "efSearch", "k_factor", "ht",
 * ...) — ParameterSpace::set_index_parameter analog. */
int tpu_ann_index_set_parameter(tpu_ann_index *index, const char *name,
                                double value);

/* ---- vectors ------------------------------------------------------- */

int tpu_ann_index_train(tpu_ann_index *index, tpu_ann_idx_t n,
                        const float *x);
int tpu_ann_index_add(tpu_ann_index *index, tpu_ann_idx_t n,
                      const float *x);
int tpu_ann_index_add_with_ids(tpu_ann_index *index, tpu_ann_idx_t n,
                               const float *x, const tpu_ann_idx_t *ids);

/* distances: (n, k) row-major into `distances`; labels likewise
 * (-1 for unfilled slots). */
int tpu_ann_index_search(tpu_ann_index *index, tpu_ann_idx_t n,
                         const float *x, tpu_ann_idx_t k,
                         float *distances, tpu_ann_idx_t *labels);

/* Range search: two-phase because result size is data-dependent.
 * Phase 1 runs the search and reports nnz; phase 2 copies the CSR
 * triple into caller-allocated buffers (lims: n+1). */
int tpu_ann_index_range_search(tpu_ann_index *index, tpu_ann_idx_t n,
                               const float *x, float radius,
                               tpu_ann_range_result **res,
                               tpu_ann_idx_t *nnz);
int tpu_ann_range_result_fetch(tpu_ann_range_result *res, tpu_ann_idx_t n,
                               tpu_ann_idx_t *lims, float *distances,
                               tpu_ann_idx_t *labels);
int tpu_ann_range_result_free(tpu_ann_range_result *res);

int tpu_ann_index_reconstruct(tpu_ann_index *index, tpu_ann_idx_t key,
                              float *out);
int tpu_ann_index_remove_ids(tpu_ann_index *index, tpu_ann_idx_t n,
                             const tpu_ann_idx_t *ids,
                             tpu_ann_idx_t *n_removed);

/* ---- standalone codec (sa_encode/sa_decode, Index.h:270+) ---------- */

int tpu_ann_index_sa_code_size(const tpu_ann_index *index, size_t *out);
int tpu_ann_index_sa_encode(tpu_ann_index *index, tpu_ann_idx_t n,
                            const float *x, uint8_t *codes);
int tpu_ann_index_sa_decode(tpu_ann_index *index, tpu_ann_idx_t n,
                            const uint8_t *codes, float *x);

#ifdef __cplusplus
}
#endif
#endif /* TPU_ANN_C_H */
