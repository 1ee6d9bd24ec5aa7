/* C API example / smoke test of the tpu_ann_torch library (role of
 * faiss's c_api/example_c.c): build an IVF index through the factory, add
 * vectors, search, check the self-hit, round-trip through write/read, and
 * exercise the codec API, on the device TPU_ANN_TORCH_DEVICE names ("cuda"
 * when unset, "cpu").
 *
 *   example_c [index_path]
 *
 * The index file goes to index_path, or to $TMPDIR (else /tmp) under a
 * name holding the process id, so two runs never share it; it is removed
 * at the end. Exits 0 on success, 1 on any failure. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "tpu_ann_c.h"

#define CHECK(call)                                                     \
    do {                                                                \
        if ((call) != 0) {                                              \
            fprintf(stderr, "FAIL %s: %s\n", #call,                    \
                    tpu_ann_last_error());                              \
            return 1;                                                   \
        }                                                               \
    } while (0)

static float frand(unsigned *seed)
{
    *seed = *seed * 1103515245u + 12345u;
    return (float)((*seed >> 16) & 0x7fff) / 32768.0f - 0.5f;
}

int main(int argc, char **argv)
{
    char path[4096];
    if (argc > 1) {
        snprintf(path, sizeof(path), "%s", argv[1]);
    } else {
        const char *tmp = getenv("TMPDIR");
        snprintf(path, sizeof(path), "%s/tpu_ann_torch_c_example.%ld.idx",
                 (tmp != NULL && tmp[0] != '\0') ? tmp : "/tmp",
                 (long)getpid());
    }
    char backend[256];
    CHECK(tpu_ann_init(backend, sizeof(backend)));
    printf("backend: %s\n", backend);

    const int d = 32;
    const tpu_ann_idx_t nb = 2000, nq = 50, k = 5;
    unsigned seed = 7;
    float *xb = malloc((size_t)nb * d * sizeof(float));
    for (tpu_ann_idx_t i = 0; i < nb * d; i++) xb[i] = frand(&seed);

    tpu_ann_index *index = NULL;
    CHECK(tpu_ann_index_factory(d, "IVF16,Flat", TPU_ANN_METRIC_L2,
                                &index));
    int trained = -1;
    CHECK(tpu_ann_index_is_trained(index, &trained));
    if (trained) { fprintf(stderr, "IVF should start untrained\n"); return 1; }

    CHECK(tpu_ann_index_train(index, nb, xb));
    CHECK(tpu_ann_index_add(index, nb, xb));
    tpu_ann_idx_t nt = 0;
    CHECK(tpu_ann_index_ntotal(index, &nt));
    if (nt != nb) { fprintf(stderr, "ntotal %lld\n", (long long)nt); return 1; }

    CHECK(tpu_ann_index_set_parameter(index, "nprobe", 16));

    float *Dv = malloc((size_t)nq * k * sizeof(float));
    tpu_ann_idx_t *Iv = malloc((size_t)nq * k * sizeof(tpu_ann_idx_t));
    CHECK(tpu_ann_index_search(index, nq, xb, k, Dv, Iv));
    int hits = 0;
    for (tpu_ann_idx_t i = 0; i < nq; i++) hits += (Iv[i * k] == i);
    printf("self-hit@1: %d/%d\n", hits, (int)nq);
    if (hits < (int)nq - 2) { fprintf(stderr, "bad self-hit\n"); return 1; }

    /* io round-trip */
    CHECK(tpu_ann_write_index(index, path));
    tpu_ann_index *loaded = NULL;
    CHECK(tpu_ann_read_index(path, 0, &loaded));
    remove(path);
    CHECK(tpu_ann_index_search(loaded, nq, xb, k, Dv, Iv));
    hits = 0;
    for (tpu_ann_idx_t i = 0; i < nq; i++) hits += (Iv[i * k] == i);
    if (hits < (int)nq - 2) { fprintf(stderr, "bad self-hit after load\n"); return 1; }
    printf("io round-trip: ok\n");

    /* reconstruct + remove */
    float rec[32];
    CHECK(tpu_ann_index_reconstruct(loaded, 3, rec));
    float maxdiff = 0;
    for (int j = 0; j < d; j++) {
        float diff = rec[j] - xb[3 * d + j];
        if (diff < 0) diff = -diff;
        if (diff > maxdiff) maxdiff = diff;
    }
    if (maxdiff > 1e-5f) { fprintf(stderr, "reconstruct mismatch %g\n",
                                   (double)maxdiff); return 1; }
    tpu_ann_idx_t rm_ids[2] = {0, 1}, n_removed = 0;
    CHECK(tpu_ann_index_remove_ids(loaded, 2, rm_ids, &n_removed));
    if (n_removed != 2) { fprintf(stderr, "removed %lld\n",
                                  (long long)n_removed); return 1; }

    /* standalone codec on a PQ index */
    tpu_ann_index *pq = NULL;
    CHECK(tpu_ann_index_factory(d, "PQ4x8", TPU_ANN_METRIC_L2, &pq));
    CHECK(tpu_ann_index_train(pq, nb, xb));
    size_t cs = 0;
    CHECK(tpu_ann_index_sa_code_size(pq, &cs));
    uint8_t *codes = malloc((size_t)nq * cs);
    float *dec = malloc((size_t)nq * d * sizeof(float));
    CHECK(tpu_ann_index_sa_encode(pq, nq, xb, codes));
    CHECK(tpu_ann_index_sa_decode(pq, nq, codes, dec));
    printf("sa codec: %zu bytes/vector\n", cs);

    /* range search on a flat index */
    tpu_ann_index *flat = NULL;
    CHECK(tpu_ann_index_factory(d, "Flat", TPU_ANN_METRIC_L2, &flat));
    CHECK(tpu_ann_index_add(flat, nb, xb));
    tpu_ann_range_result *rres = NULL;
    tpu_ann_idx_t nnz = 0;
    CHECK(tpu_ann_index_range_search(flat, nq, xb, 0.5f, &rres, &nnz));
    tpu_ann_idx_t *lims = malloc((size_t)(nq + 1) * sizeof(tpu_ann_idx_t));
    float *rD = malloc((size_t)(nnz > 0 ? nnz : 1) * sizeof(float));
    tpu_ann_idx_t *rI = malloc((size_t)(nnz > 0 ? nnz : 1)
                               * sizeof(tpu_ann_idx_t));
    CHECK(tpu_ann_range_result_fetch(rres, nq, lims, rD, rI));
    if (lims[nq] != nnz || nnz < nq) {  /* every query hits itself */
        fprintf(stderr, "range nnz %lld\n", (long long)nnz);
        return 1;
    }
    printf("range search: nnz=%lld\n", (long long)nnz);
    CHECK(tpu_ann_range_result_free(rres));

    /* error path: searching a freed handle must fail cleanly */
    CHECK(tpu_ann_index_free(index));
    if (tpu_ann_index_search(index, 1, xb, 1, Dv, Iv) == 0) {
        fprintf(stderr, "freed-handle search should fail\n");
        return 1;
    }
    if (strlen(tpu_ann_last_error()) == 0) {
        fprintf(stderr, "missing error message\n");
        return 1;
    }

    CHECK(tpu_ann_index_free(loaded));
    CHECK(tpu_ann_index_free(pq));
    CHECK(tpu_ann_index_free(flat));
    free(xb); free(Dv); free(Iv); free(codes); free(dec);
    free(lims); free(rD); free(rI);
    CHECK(tpu_ann_shutdown());
    printf("C API example: OK\n");
    return 0;
}
