#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

    python3 chip_smoke.py --k1-batches   # only K1 / K1p times at 1 to 10k
                                         # queries on random integer data
    python3 chip_smoke.py --k2-batches   # only K2's device times at 1 to
                                         # 10k rows of a random reservoir
    python3 chip_smoke.py --phase19      # only phase 19 (the codecs), on
                                         # phase 3's data and quantizer
    python3 chip_smoke.py --phase20      # only phase 20 (the index
                                         # families), likewise
    python3 chip_smoke.py --phase21      # only phase 21 (the sharded
                                         # path), likewise, with phase
                                         # 16a's IVF4096,PQ32
    python3 chip_smoke.py --phase22      # only phase 22 (the tooling and
                                         # serving layer), likewise
    python3 chip_smoke.py --phase23      # only phase 23 (the C handle,
                                         # the demos and the entry
                                         # point), likewise
    python3 chip_smoke.py --phase24      # only phase 24 (the searches
                                         # past kp 32: IVF4096,Flat at k
                                         # 100, IVF4096,SQ8 at k 50 /
                                         # 100), likewise, with the exact
                                         # top 100

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is required; nvidia-smi's name and power limit.
  2. build   — compile the seven CUDA libraries from tpu_ann_torch/csrc
     (one nvcc each, in parallel): K3 ivf_scan_fused, K3-SQ8 ivf_scan_sq8,
     K1 flat_knn_fused, K2 reservoir_topk, K4 ivf_scan_paged, K1p and B1
     flat_knn_variants, B2 row_copy_probe; each library's registers and
     spill bytes from its ptxas log. No library may spill.
  3. IVF path at the benchmark's size: calibrated SIFT1M surrogate (1M
     base, 100k train, 10k queries, seed 123); the exact IndexFlat's
     ground truth (no K1 launch); make_ivf_flat(128, 4096) -> train
     (k-means, 10 iterations) -> add -> search and search_stats at nprobe
     16 / 32 / 64, k=10. Recall@10 must reach the floors; every search is
     exactly one K3 launch and no K1 / K2 launch.
  4. K3 vs its plain torch version at the IVF path's shapes (1024 queries,
     nprobe 32): per-pair outputs and final (D, I) equal on the integer
     data; IP on float data with id overlap >= 0.999; times.
  4a. IVF-SQ8 path on the same data and centroids:
     IndexIVFScalarQuantizer(phase 3's quantizer, 128, 4096, QT_8BIT),
     quantizer_trains_alone=1 (no k-means) -> train (the codec, on the
     train slice) -> add -> search and search_stats at nprobe 16 / 32 / 64.
     Recall@10 must reach the fixed SQ8_FLOORS and lose at most
     SQ8_MAX_LOSS against phase 3's at the same nprobe (the reference's
     8-bit codec decodes at (code + 0.5) / 256 of the range after encoding
     at code / 255, which loses more than the IVF floors allow at nprobe
     64; see ROADMAP.md, queue 3); the codec's own recall@10 (exact f32
     search over the whole base encoded and decoded) is printed beside
     them. Every search is exactly one K3-SQ8 launch and nothing else; the
     device holds the uint8 codes and no f32 / bf16 copy of the stream.
     Then the same with QT_8BIT_DIRECT, lossless on this integer data: its
     (D, I) must equal phase 3's bit for bit at every nprobe.
  4b. K3-SQ8 vs its plain version (run on the card), on both indexes, at
     1024 queries x nprobe 32 and at the main path's 10k queries x nprobe
     16 / 32 / 64: per-pair outputs bit for bit for QT_8BIT_DIRECT, within
     rtol 1e-5 (positions equal outside near-ties) for QT_8BIT; at 1024
     queries final (D, I) equal, and K3-SQ8, plain and K3 times on the
     same plan, in turns; at 10k queries K3-SQ8, plain and K3 times, each
     beside its bound.
  4c. K3g (scan_invlists_fused_grid) at 1024 queries x nprobe 32 on phase
     3's bf16 index: with grid2d_maxc's bound it equals K3 bit for bit;
     with half of it (ranges cut) the kernels' per-pair outputs and the
     route's (D, I) equal the plain version over the same cut plan, on the
     bf16 stream and on the QT_8BIT codes; times.
  5. flat path on the same data: IndexFlat(128) opted into bf16 search
     (compute_dtype="bfloat16", approx_topk=True, scan_mode "auto") takes
     the fused scan. The exact route (integer data detected: W=2048,
     refine 0) must reach recall@10 0.9969, the refine route
     (exact_kernel=False: W=1024, refine 4) 0.9942; every search is one K1
     and one K2 launch. Then IndexFlatIP on float data (base + uniform
     noise, 1024 noisy queries) through the refine route: recall@10 >= 0.98
     against the exact f32 IndexFlatIP.
  6. K1 and K2 vs their plain torch versions at the flat path's shapes
     (1024 and 10k queries x 1M rows, W=2048 and 1024; k=10 and 40): bit
     for bit on the integer data; K1's kernel and plain times at both batch
     sizes. K2 at the path's two shapes (W 2048 k 10, W 1024 k 40) on the
     first 1, 64, 1024 and all 10k rows of K1's reservoir: bit for bit,
     kernel, plain and torch.topk(resv, k, largest=False) times, and the
     bound by the bytes the function must move (the values, and the k
     winners' positions and outputs) beside the older count (values and
     positions read in full). Then K1 (W 2048, 1024) and K1p (W 1024) at 1,
     64 and 65 queries, bit for bit and timed.
  7. out-of-core path on the same data: the base written to an np.memmap
     in a temporary directory (removed at the end), the pinned
     host-to-device bandwidth measured alone, IndexIVFFlatPaged(128, 4096,
     <tmp>/index) -> train (10 iterations) -> add(memmap) -> a fresh
     IndexIVFFlatPaged.load -> search / search_stats at nprobe 16 / 32 /
     64, k=10, in three settings: the default window (8192 blocks), 1024-
     block windows, and 1024-block windows over a resident half (the hot
     tier). Recall@10 must reach the IVF floors; (D, I) must equal K3's
     scan over a device copy of the same directory's arrays bit for bit;
     each search launches K4 once per planned call and no K3 / K1 / K2.
     Then the search at k 27 / 58 / 100 (kp 33 / 64 / 106: K4's
     two-entries-a-lane kernel, and its lists in global memory above kp
     64) of 1024 queries at nprobe 32: K4 launched, (D, I) equal to K3's.
  8. K4 vs its plain torch version at the path's shapes (10k queries,
     nprobe 32, the first call of each of the two default windows, the
     second merging into the first's result), and on the same window
     padded from d=96: bit for bit; kernel and plain times. Then at kp 33 /
     58 / 64 / 100 / 106 / 262 / 1030 (1024 queries, the first two
     windows) bit for bit, one launch a call (of the global-list kernel
     above kp 64), timed from kp 58 up, and the parent route (32-row
     sub-blocks and a merge, `scan_window_wide`) above kp 64.
  9. IVFHNSW path on phase 3's data (the JAX package's bench.py config
     3): IndexIVFHNSW(128, 15625, M=16), efConstruction 40 -> train on the
     train slice (k-means, then the graph over the centroids) -> add -> search
     at nprobe 32 / 64. coarse_mode "auto" (the exact product over the
     centroid table) must reach IVFHNSW_FLOORS, one K3 launch a search;
     "quantizer" (the graph's fused tiles) must return >= 0.99 of the exact
     top-nprobe lists and recall@10 within 0.01 of auto's, with 1 +
     fused_hops K3 launches per 8192-query chunk for the tiles and one for
     the lists. Build split (k-means, graph, add) and QPS are printed.
     Then k 100 (kp 106) at nprobe 32 / 64 in both modes: one launch of
     K3's global-list kernel a search (after the hop launches in
     "quantizer" mode), (D, I) equal to the plain route's on the same
     probes bit for bit, recall@100 against the exact top 100 not falling
     with nprobe; the kernel on each auto plan (lists of 64 rows on
     average) bit for bit against its plain version, its time and bound.
  10. the graph section of the round-4 probe harness (benchs/r4/r4_queue4.py
     section A): its clustered set (RandomState(11): 1024 centres rand * 10
     plus N(0, 1), 1M base, 10k queries), exact ground truth on the card;
     build_graph_knn(xb, 16, 40) once (twice, cold and warm, before phase
     24), build_tiles_fused in
     the build's coarse order, tile_search_fused at (nprobe0 12, hops 1, F
     4), (12, 2) and (12, 0), scored on the node ids: recall@10 >= 0.97 at
     (12, 1) and hops 2 >= hops 1 > hops 0; 1 + hops K3 launches a search,
     each launch's device time (hop 0, 1, 2) from the search's profile and
     its bound from the plan it scans.
     Then IndexHNSWFlat(128, 16) over the same base, searched at efSearch
     16 and 64.
  11. K1p on phase 5's data: flat_knn_fused(merge="packed") over the r5
     harness's grid (W 1024 / R 8192 grid, W 2048 / R 16384 grid, W 1024
     fori unroll 4; sel "kernel", refine 0: recall printed), and the refine
     route (W 1024, refine 4) >= phase 5's refine recall less 0.003; one K1p
     launch a search. K1p against its plain version at 1024 and 10k queries:
     the packed reservoir bit for bit.
  12. the B1 ladder at 10k queries x 1M x W 1024 (R 8192): min1, minall,
     serial (flat_probe_scan) and packed (K1p) on the same inputs, each bit
     for bit against its plain version; times and each kernel's tensor-core
     instructions in the SASS (cuobjdump): K1, K1p and every B1 fold must
     hold wgmma (HGMMA), the same count in the three folds; K3, K3-SQ8 and
     K4 must hold mma.sync (HMMA).
  13. B2, the row-copy issue probe, at NR 0 / 1 / 15 / 4096 / 16384 /
     65536 rows of the 1M x 128 f32 base, NS 16: the slots and the XOR of
     all copied rows equal the plain version bit for bit; ms, ns a copy
     over the card, the largest and the mean CTA's SM cycles a copy,
     xb.index_select(0, rows) on the same rows, and the bound; at 65536
     also both on 65536 consecutive rows.
  14. the fork's workflow, on phase 9's IVFHNSW15625, phase 7's paged
     index and phase 3's quantizer, every file in the run's temporary
     directory: (a) save_to_disk, reopen with IndexIVFHNSW.load and
     read_index(mmap=True): auto (D, I) bit for bit at nprobe 32 / 64,
     quantizer mode at phase 9's floors and fidelity; file bytes, write,
     read and repack seconds; (b) search_stats_per_query over 1000 queries
     at nprobe 32 / 64 (auto) and 64 (quantizer): each row equal to the
     batch search's, ndis equal to the file's list sizes over the query's
     batch-1 probes, one K3 launch a query (plus the tile launches),
     P50 / P99 / P99.9 of each phase; (c) K3 at batch 1 vs its plain
     version (device ms, bound); (d) the paged index through write_index /
     read_index(mmap=True), (D, I) bit for bit (K4); (e) the first 250k
     rows (1M before phase 23) as two shards over phase 3's quantizer
     merged by merge_ondisk and reopened with mmap, equal to one index
     over the same rows bit for bit; (f)
     IVF4096,SQ8 through a file, bit for bit, and per query (K3-SQ8); (g)
     the fused IndexFlat through a file, bit for bit (K1, K2).
  15. the IVF API, on an IVF4096,Flat over phase 3's quantizer and data
     (quantizer_trains_alone=1: phase 3's index list for list), nprobe 32
     unless named: (a) IDSelectorAll through the query-major scan, D
     bit-equal to K3's search (ids up to ties); IDSelectorRange(0, NB/2),
     an IDSelectorBatch of NB/10 random ids and a 1% IDSelectorBitmap:
     every id passes, D bit-equal to K3 over an index of only the selected
     rows; QPS of each beside K3's; (b) max_codes 256 / 1024: ndis equal
     to the probed lists' rows within the cap, recall@10 and QPS beside
     the uncapped (a cap that truncates no list takes K3, the reference's
     rule); (c) range_search over 1000 queries at the median exact
     10th-NN distance: IVF equal (as sets, distances exact) to a brute-
     force f32 filter of each query's probed lists, IndexFlat to one of the
     whole base, IndexScalarQuantizer(QT_8BIT_DIRECT) to IndexFlat's;
     seconds and hits; (d) merge_from of two halves bit-equal to the whole
     index (K3); IVF-SQ8 (QT_8BIT) after remove_ids of the NB/10 ids: no
     removed id through K3-SQ8, D bit-equal to an index of the rest; (e)
     IVF-SQ QT_FP16 / QT_BF16 / QT_4BIT / QT_6BIT through the query-major
     scan at nprobe 16 / 32 / 64: fp16 / bf16 (D, I) bit-equal (ids up to
     ties) to IVF-Flat's query-major route; 4 / 6 bit equal (rtol 1e-5,
     ids up to ties) to an exact f32 top-10 over the decoded rows of each
     query's probed lists (1000 queries), recall@10 >= the codec's own x
     IVF-Flat's - 0.01 (the two losses compound); QPS and device bytes;
     (d) the index
     itself: remove_ids of the NB/10 ids (IDSelectorBatch, the DirectMap)
     and of [NB - NB/10, NB) (IDSelectorRange, a host scan), both below the
     hole threshold, then [0, NB/10) past it (compacted at the next
     search): after each, K3 returns no removed id, D bit-equal to K3 over
     an index of the remaining rows; update_vectors of NB/100 ids to rows
     of other lists with room, in place: each found at distance 0 through
     K3; the times of remove_ids and update_vectors beside a full _repack.
     The selector, capped max_codes and range routes launch no kernel; the
     K3 / K3-SQ8 searches launch exactly theirs.
  16. PQ and refine on phase 3's data and quantizer (quantizer_trains_alone
     =1: no k-means, IVF-Flat's lists), nprobe 16 / 32 / 64 unless named,
     10k queries. E: the exact f32 top-10 of the first 1000 queries over
     the decoded rows of their probed lists; C: recall@10 of exact f32
     search over all 1M decoded rows; the floor R(nprobe) = C x phase 3's
     IVF-Flat recall - 0.01. (a) IVF4096,PQ32 (8-bit, bf16 decoded cache):
     exactly one K3 launch a search / search_stats, id overlap with E >=
     0.99 and the common ids' D within rtol 1e-5 (or 8 f32 ulps of the
     terms it is the difference of, E in float64), recall@10 >= R; train,
     add and cache seconds, cache bytes (the port's and the reference's
     budget count), QPS; (b) the same codes, decoded_cache_dtype "sq8":
     exactly one K3-SQ8 launch, recall within 0.01 of (a)'s, the device
     cache a uint8 stream alone; (c) use_decoded_cache=False: the 8-bit
     table scan (scan_invlists_pq), no launch, D within rtol 1e-4 of E over
     an f32 cache (ids up to near-ties), QPS beside (a)'s; (d)
     IVF4096,PQ64x4 (4-bit, 32 B a vector as (a)): the table scan over
     packed codes, no launch, within rtol 1e-4 of its E, recall >= R with
     its own C; (e) IVF4096,PQ32+16 (IndexIVFPQR, k_factor 4): one K3
     launch a search (k 40: default_kp(40) = 46 rows a list, above 32,
     so the launch is K3's wide-list kernel) plus the re-rank, recall >= (a)'s; search_preassigned over 100 queries at
     nprobe 32 equal to search, search_stats_per_query within rtol 1e-5;
     K3 at kp 46 (10k q, nprobe 32, k 40) and kp 106 (1000 q, nprobe 1, k
     100; the global-list kernel) against its plain version on the same
     inputs, per pair and for
     the whole scan: bit for bit on R's cache rounded to integers, within
     rtol 1e-5 (positions up to near-ties) on the cache itself, K3 faster
     than the plain version, with both times and the kp-32 launch's;
     (f) IVF4096,PQ32,RFlat (the constructor over a fresh IVFPQ with
     (a)'s codebook, then add) and the factory's IVF4096,PQ32,RSQ8t
     (train, add): one K3 launch a search, recall >= (a)'s, each bit for
     bit equal to a wrapper put together by hand from the same parts,
     RFlat's D equal to an f32 recomputation from the base rows (rtol
     1e-6), the re-rank's share of the search time; (g)
     IndexPQ(128, 32, 8) over the base: ST_PQ through its bf16 cache within
     0.005 recall of exact ADC over the decoded rows, ST_SDC over 1000
     queries, no launch; (h) IVF15625_HNSW16,PQ32 over phase 9's graph
     quantizer at nprobe 32 / 64: "auto" one K3 launch, recall >= C x
     phase 9's auto recall - 0.01 (C of this codec); "quantizer" 1 +
     fused_hops tile launches a chunk and one K3, recall within 0.01 of
     auto's; (i) (a), (e) and (f) through write_index /
     read_index(mmap=True): (D, I) bit for bit after the cache is rebuilt
     (seconds); two 500k-row IVFPQ shards merged by merge_ondisk and
     reopened: equal to (a); (j) remove_ids of NB/10 random ids on (a): no
     removed id through K3 (bf16 cache) or K3-SQ8 ("sq8"), D bit-equal to
     an index of the rest with the same codebook.
  17. the rest of HNSW on phase 3's data, 10k queries at efSearch 16 / 64
     unless named; F: an IndexHNSWFlat(128, 16) on (a)'s graph through the
     fused tiles (1 + fused_hops K3 launches a 8192-query chunk), C: a
     codec's recall@10 (exact f32 search over its decoded base). (a)
     index_factory(128, "HNSW16,SQ8") builds the graph once: 1 + fused_hops
     K3-SQ8 launches a chunk and no K3, recall@10 >= C x F - 0.01, the
     device holds its uint8 tiles and no f32 / bf16 stream or storage,
     reconstruct equals the dequantized code; at k 100 and efSearch 128 /
     256 (kp 64 on every scan: 1 + fused_hops launches a chunk, all of the
     wide-list kernels, K3-SQ8 for (a) and K3 for F) recall@100 >= C x F
     - 0.01 (C the codec's recall@100), and K3-SQ8's hop-0 launch at kp
     64 against its plain version (rtol 1e-5), its time and bound;
     (b) "HNSW16,SQbf16" and
     "HNSW16,SQfp16" on (a)'s graph set by hand: (D, I) bit for bit F's
     (lossless on integers), K3 only, stream bytes; (c) "HNSW16,PQ32":
     no launch, recall >= C x F' - 0.01 with F' F's tiles searched at the
     PQ route's tile budget (hop 0 max(4, ef / 8) tiles, F's max(8, ef /
     2)), D the ADC distances of the returned ids (rtol 1e-4), code
     bytes; (d) "HNSW16,4096+PQ32"
     (IndexHNSW2Level): sa_decode(sa_encode(x)) equal to the rows the
     graph was built on, recall >= C x F - 0.01, K3 only; (i) (a), (c),
     (d) through write_index / read_index(mmap=True): (D, I) bit for bit;
     (e) the tile beam, no launch, efSearch 64, 1000 queries: on the
     first 250k rows of phase 5's float set (cut from 1M for phase 23)
     IndexHNSWFlat IP in "auto" and L2 forced to "beam",
     and F forced to "beam" on the SIFT surrogate: recall >= the per-node
     beam's (hnsw_search on the same graph) - 0.01, hops, the visited
     table's bytes, and the recall from the reference's 8 entry tiles
     (the index takes efSearch / 2) and with 16 tiles a hop; (f)
     build_mode="insert" over
     phase 9's 15625 centroids as IVFHNSW15625's quantizer at nprobe 32 /
     64: fidelity >= 0.99, recall within 0.01 of phase 9's auto, build
     seconds beside the kNN build's; (j) phase 9's quantizer mode at
     nprobe 64 (kp 64): QPS, and its hop-0 scan (one 8192-query chunk, one
     launch of K3's wide-list kernel) held against its plain version: bit
     for bit on an integer-rounded copy of the tiles, within rtol 1e-5
     (positions up to near-ties) on the centroids themselves, and faster
     than it; (g) an IndexHNSWFlat over the first
     900k rows, then an add of the last 100k (extend_graph, no launch):
     recall@10 at efSearch 64 within 0.01 of F's; 1000 added and 1000
     built rows searched back: through the fused tiles (G.search,
     efSearch 64) the added rows come back first at distance 0 as often
     as the built ones, within 2% of the sample (the graph walk's misses
     printed, and recall and misses with the tiles in the build's id
     order within the carried cells and in spatial_order's k-means
     order); (h) range_search on (g) over 1000 queries at the
     median exact 10th-NN distance: every hit inside the radius at its
     f32 distance (rtol 1e-5), a subset of the brute-force range set
     (share printed).
  18. the index API breadth on phase 3's data and quantizer: (a)
     "PCA64,IVF4096,Flat": recall@10 at nprobe 16 / 32 / 64 >= C_pca x
     phase 3's - 0.01 (C_pca: exact f32 search in the PCA-64 space
     against the 128-d ground truth), (D, I) bit-equal to an
     IndexIVFFlat built directly over vt.apply(x) on the same centroids,
     one K3 launch a search; K3 at d 64 (10k q, nprobe 32) against its
     plain version (rtol 1e-5, positions up to near-ties) and timed; (b)
     "OPQ16_64,IVF4096,PQ16" (faiss's OPQ-IVF-PQ deployment): OPQ
     training seconds, recall >= C x phase 3's - 0.01 (C: exact f32 over
     the decoded, rotated rows), one K3 launch a search (bf16 cache) and
     one K3-SQ8 launch with the "sq8" cache (recall within 0.01), and
     IVF4096,PQ16 without OPQ printed beside it; (c) "IDMap2,IVF4096,Flat"
     over phase 3's quantizer and the first 250k rows (1M before phase 23)
     with random int64 ids above 2^32: search equal to the sub-index's
     mapped through id_map, a selector over 10% of the external ids at
     nprobe 4096 equal to exact search over those rows, 25k ids removed
     then equal to a fresh IDMap2 over the survivors, 25k rows added under
     new ids (no id repeats, each found
     back at distance 0), reconstruct by external id, an IxM2 file
     reopened bit-equal; (d) IndexShards of 4 exact IndexFlat filled by
     two adds of 500k equal to an IndexFlat over the 1M rows in their
     order (the ids follow the adds; 1000 rows searched for themselves
     come back under their positions), and IndexReplicas of (c)'s sub-index and a
     clone bit-equal to it; (e) ParameterSpace.explore over IVF4096,Flat
     (nprobe 1..2048, the recalls at 16 / 32 / 64 equal to phase 3's) and
     over phase 9's IVFHNSW15625 in quantizer mode (nprobe 8..128, cut
     from 1..4096, x efSearch 16..256): the Pareto points and seconds;
     (g) SlidingIndexWindow, 10 slices of 25k (100k before phase 23), nslice
     4: after each step bit-equal to an IVF-Flat over the live slices; (h)
     IndexFlat(128, m) over the first 250k rows (1M before phase 23) for the
     nine extra metrics (Lp with p 3,
     NaNEuclidean with 1% NaNs), 256 queries: QPS and peak device memory,
     the timed search's first 32 queries and a selector run over the first
     100k rows, whose ids equal an f64 evaluation on the card written
     here apart from ops/extra_distances (f64_extra: torch.cdist, products
     of magnitudes and NaN masks, a loop over the dimensions), ties within
     rtol 1e-5 (1e-4 for JensenShannon); (f) ClusterManager.balance, one
     round, on phase 9's index after phase 17 with max_cell_size the
     5th-largest list (the 9th before phase 23): nlist grows by the splits,
     the sizes sum to ntotal, every row in exactly one list, each split
     list's rows in both its parts (each at least 5% of them), recall@10
     at nprobe 32 within 0.01 of before; each split's sizes, the largest
     list after the round with where its rows were before, the imbalance
     and the seconds a split. Phase 18 launches
     K3 and K3-SQ8 only; its count leaves out the launches of what a path
     is held against (the direct IVF, IVF4096,PQ16, K3 against its plain
     version, the sub-index searched alone, fresh IDMap2 and window IVFs,
     the index a file is held against), printed apart.
  19. the codecs on phase 3's data and quantizer (quantizer_trains_alone
     = 1): (a) IVF4096,RQ16x8: train / add seconds, C (exact f32 over the
     decoded rows), recall@10 at nprobe 16 / 32 / 64 through the bf16
     decoded cache (one K3 launch a search) >= C x IVF-Flat's - 0.01, the
     "sq8" cache (K3-SQ8) within 0.01 of it, the table scan (no kernel) on
     1000 queries >= the bf16 cache's - 0.01 on the same queries,
     search_stats and search_preassigned equal to search bit for bit, K3
     and K3-SQ8 at 10k q, nprobe 32 on these caches held against their
     plain versions (rtol 1e-5, positions up to near-ties) with their
     CUDA-event times; (b) IVF4096,LSQ16x8 / PRQ2x8x8 / PLSQ2x8x8: train
     and add seconds, the residual MSE (LSQ's at most RQ16x8's), C and
     recall@10 at nprobe 32 >= C x IVF-Flat's - 0.01; (c)
     IVF65536(RCQ2x8),Flat in the beam route and with the 65,536
     centroids enumerated, and IVF65536(LSCQ2x8),Flat (enumerated), at
     nprobe 64 / 256: coarse fidelity against the exact top-nprobe lists,
     quantization_us, recall@10 (the beam's within 0.02 of the
     enumeration's), and K3 on the 1-2-block lists (10k q, nprobe 64)
     against its plain version; (d) flat RQ16x8 over the 1M rows: recall
     on 1000 queries within 0.002 of C, sa_encode / sa_decode equal to
     the stored codes and their decode, range_search on 100 queries equal
     to brute force on the decoded rows (rows within rtol 1e-5 of the
     radius either way); (e) IndexPQ PQ32 with polysemous training
     (POLY_ITERS annealing steps a sub-quantizer): ST_POLYSEMOUS with the
     filter off equal to ST_PQ's table scan bit for bit, then at the
     Hamming quantiles 1 / 5 / 30% of a sample the pass share, recall@10
     and QPS beside ST_PQ's (faster than it at the 1% share), the pass
     count growing, every distance ST_PQ's ADC of its id; (f) IndexQINCo(128, K 256, L 2, M 8, h 256) with
     QINCo.random's weights over the first 125k rows (1M before phase 23,
     250k before phase 24):
     encode / decode seconds, search of 1000 queries (recall against those
     rows' exact ground truth = C within 0.002), the card's codes on 2000 rows
     equal to the host's on >= 99.5%, the state dict round trip exact;
     (g) ZnLattice16x10_6 over LATTICE_NB rows (host encode), recall =
     C within 0.002; (h) IxRQ, IwRQ, IxCQ, IxQN and IxLt files reopened
     with mmap, each search bit for bit the original's. Phase 19 launches
     K3 and K3-SQ8 only; its count leaves out the comparison launches.
  20. the index families on phase 3's data and quantizer: (a) LSH256rt
     trained on the train rows encodes the first FAM_NB (250k) base rows
     and the queries (encode rate, LSH's recall@10 against their exact
     ground truth, the card's codes equal to the host's on >= 99.5% of 10k
     rows); (b) IndexBinaryFlat over the 250k codes (QPS; its
     distances on 1000 queries equal a popcount-table route; range search
     on 100 queries equal to brute force) and IndexBinaryFromFloat(IndexFlat
     (256), scan_mode "fused") through K1 + K2 on the 0/1 rows (every
     returned distance its id's Hamming distance, tie-aware recall >=
     FROM_FLOAT_FLOOR: the reservoir drops one of two best rows sharing a
     lane), K1 at d 256 held against its plain version; (c) BIVF4096
     (train, add, tie-aware recall and QPS at nprobe 16 / 32 / 64, not
     falling; nprobe 4096 equal to the flat index) and BIVF4096_HNSW32 at
     nprobe 32 (its share of the flat quantizer's lists, recall, QPS); (d)
     BHNSW32 (build, recall and QPS at efSearch 64 / 128 through K3 on
     256-wide bf16 tiles, K3 held against its plain version there); (e)
     BHash16 / BHash8x16 at nflip 0 / 1 / 2 (candidates growing, each set
     holding the last, every distance the flat index's, recall, QPS); (f)
     NSG32,Flat over NSG_NB (100k) rows (NN-descent and prune seconds,
     the k-NN
     graph's recall on a 10k-row sample, the share of rows reachable from
     the medoid, recall and QPS at efSearch 16 / 32 / 64 / 128, not
     falling, the card's beam equal to the CPU's on 200 queries), then at
     50k rows IndexNNDescentFlat(K 32), NSG32,PQ32 and NSG32,SQ8, each
     coded one equal to an IndexNSGFlat over its decoded rows; (g)
     IndexIVFSpectralHash(nbit 128) over phase 3's quantizer at period 10 /
     100 and thresholds global / centroid / median (recall, QPS; its entry
     points equal, a half selector equal to a search of the kept rows) and
     IndexIVFIndependentQuantizer (phase 3's quantizer, PCA64, IVF4096,Flat
     payload through K3 at d 64) above C x IVF-Flat - 0.01; (h)
     IndexRowwiseMinMax over IVF4096,SQ8 (K3-SQ8; recall in the normalized
     space, reconstruct within one SQ8 step), MultiIndexQuantizer(128, 2,
     10) at k 64 equal to the enumeration of its 2^20 cells, and
     IndexSplitVectors over two IndexFlat(64) equal to IndexFlat(128); (i)
     the 17 files (BxFl ... IwIQ) reopened with mmap, each search bit for
     bit the original's. Phase 20 launches K1, K2, K3 and K3-SQ8.
  21. the sharded path (tpu_ann_torch.parallel) on phase 3's data and
     quantizer; the rows, queries, quantizer, assignment and phase 16a's
     IVF4096,PQ32 codes and codebooks written as .npy files to the run's
     temporary directory. (a) World size 1, NCCL: sharded_ivf_scan's fused
     route (one K3 launch) equal to scan_invlists_fused over the same
     lists bit for bit, at 10k queries and nprobe 32; sharded_knn over the
     1M rows at 1024 queries equal to the exact ground truth (ties either
     way); sharded_ivf_scan_pq (40 candidates) and kmeans_distributed
     (4096 centroids, the 100k train rows, 10 iterations) for (b). (b)
     World size 4 (2 shards x 2 replicas), gloo, the ranks spawned by
     torch.multiprocessing, all on the card, each packing its shard's half
     of the rows with global ids from the .npy files: every rank's result
     equal to rank 0's; the fused route (one K3 launch a rank) equal to the
     plain route; recall@10 at nprobe 32 at the IVF floor and within 0.001
     of phase 3's; sharded_knn equal to the ground truth;
     sharded_ivf_scan_pq equal to (a)'s; sharded_refine of its candidates
     equal to IndexRefine's exact re-rank; kmeans_distributed's objective
     within 1e-4 of (a)'s. Each function's seconds by rank, and rank 0's
     K3 launch (5k queries, half the lists) timed beside its bound.
  22. the tooling and serving layer (tpu_ann_torch.utils: contrib,
     client_server / rpc, offline_pipeline, bench_fw, analyzers, memory,
     native) on phase 3's data and quantizer; every check raises. (a)
     knn_ground_truth over the 1M rows in 100k chunks equal to phase 3's
     exact ground truth (ties either way); kmin on a (10k, 2048) distance
     table equal to a stable sort. (b) big_batch_search of the 10k queries
     through an IVF4096,Flat over phase 3's quantizer (its lists), nprobe
     32, batches of 2048: an InterruptCallback stops a depth-1 run after
     two batches are checkpointed, a depth-3 run resumes from the
     checkpoint, and (D, I) equal index.search's bit for bit, as does an
     uninterrupted depth-3 run (timed); on 1024 queries the same route
     through K3's plain version gives the same (D, I). (c) two
     SearchServers on localhost, each an IVF4096,Flat over phase 3's
     quantizer with 500k of the rows under global ids, behind a
     ClientIndex: (D, I) at nprobe 32 equal to the one index's (ties
     either way); QPS and K3's launches (two a search). (d) the offline
     pipeline, IVF4096,Flat over the 1M rows from .npy files, 2 shards
     added in worker processes on the card (the device read from
     config.json): the merged index equal to one add of all rows onto the
     same trained.tann bit for bit; a second run executes nothing; each
     step's seconds. (e) bench_fw: a Benchmark of IVF4096,Flat at nprobe
     16 / 32 / 64 over the same vectors as local .npy descriptors (its
     k-means 10 iterations, as phase 3's): recall@10 at phase 3's floors;
     a second benchmark() reuses every cached artifact (no file written,
     no launch). (f) analyzers.report at nprobe 32 with the ground truth
     (its recall equal to phase 3's); train_ivf_index_with_2level (nc1 64,
     rebalanced, and batched) with recall@10 at nprobe 32 no lower than
     phase 3's less 0.03; MemoryMonitor and EnergyMonitor (watts, or null
     without RAPL) around one search; index_memory_bytes of phase 3's index
     within 10% of the growth of torch.cuda.memory_allocated() across its
     train and add; native.HAVE_NATIVE, and read_fvecs_native and
     pack_rows_native equal to numpy on the 1M rows.
  23. the port's own C handle, demos and entry point on phase 3's data
     (tpu_ann_torch/capi.py, c_api/, demos/, graft_entry.py); every check
     raises. (a) the C library and its example built with cc into
     tpu_ann_torch/_build/ (the embed flags from this Python's sysconfig);
     the standalone example_c (its own embedded interpreter,
     TPU_ANN_TORCH_DEVICE=cuda) exits 0 with "C API example: OK"; then the
     library loaded
     here with ctypes: IVF4096,Flat through tpu_ann_index_factory, trained
     on the 100k rows and filled with the 1M through C pointers, the 10k
     queries searched at nprobe 16 / 32 / 64 (a warm-up and 3 timed
     searches each, one K3 launch a search, recall@10 at the floors), the
     same index object's Python search timed beside each C search; the
     index written from C and read by tpu_ann_torch.read_index searches
     the C (D, I) bit for bit; phase 3's lists written by the package and
     read through tpu_ann_read_index search phase 3's (D, I) bit for bit.
     (b) the eight demos at their own sizes on the card, each with its
     asserts: the numbers each returns, seconds and launches (K3 in the
     IVF demos 1, 2, 4 and 5, whose servers report theirs; K4 in the
     paged demo; nothing in the sharded, RQ and QINCo demos). (c)
     graft_entry.entry()'s step on the card against the same step over a
     CPU copy of its index (ids equal, distances within rtol 1e-5), and
     dryrun_multichip(4) as 2 x 2 gloo ranks on the card (every rank's
     results equal rank 0's; K3 2 a rank, K4 at least 1 a rank).
  24. the searches past kp 32 (K3's and K3-SQ8's kernels with two list
     entries a lane and those whose lists live in shared memory) on phase
     3's data and quantizer, against the exact top 100 (computed once with
     phase 3's ground truth, shared with phases 9 and 17a): (a)
     IVF4096,Flat (phase 3's lists) searched at k 100 (kp 106) at nprobe
     16 / 32 / 64: each search exactly one K3 launch, of the global-list
     kernel; recall@100 not falling with nprobe; (D, I) equal to the plain
     route's bit for bit; QPS in turns with k 10's; the kernel's time on
     each search's plan and its bound; one search at k 50 (kp 56, the
     wide-list kernel) a nprobe for (c). (b) K3 at kp 106 and 262 on the
     10k-query plan at nprobe 32 and at kp 1030 on 1024 queries: per-pair
     (D, P) equal to the plain version on the card bit for bit, the k-100
     scan equal to scan_invlists_fused_reference; CUDA-event times beside
     the parent route's (scan_pairs_wide over the kp-32 launch), the plain
     version's and the bound. (c) IVF4096,SQ8 with QT_8BIT and
     QT_8BIT_DIRECT searched at k 50 (kp 56) and k 100 (kp 106) at nprobe
     16 / 32 / 64: each search one K3-SQ8 launch, of the wide-list kernel
     at k 50 and of the global-list one at k 100, no K3 or K4 launch; (D,
     I) against the plain route on the SQ8 view (QT_8BIT_DIRECT bit for
     bit, QT_8BIT within rtol 1e-5, ids apart only on near-ties);
     QT_8BIT_DIRECT's (D, I) equal to IVF4096,Flat's bit for bit;
     recall@50 / @100 not falling with nprobe, QT_8BIT's within 0.015 of
     IVF-Flat's; QPS in turns with k 10's; the kernel's time on each
     search's plan beside its plain version's and the bound. Then K3-SQ8 at
     kp 106 on the nprobe-32 plan of both qtypes as K3 in (b).
The last two lines are the kernels' JSON record (each with its time,
its plain version's, the card's bound for the same work (a scan of
lists: the valid rows it needs, each read once, not their blocks'
padding; the RCQ lists' padded-block bound printed beside) and, where one
torch call computes the same function, that call's time; K3, K3-SQ8 and
K4 add their time and bound at the main path's 10k queries, K3 its time
at IVFPQR's kp 46 (phase 16e), at the quantizer's kp 64 (phase 17j) and
at d 64 (phase 18a), on the IVF-RQ cache and the 65,536-list RCQ lists
(phase 19a / c; K3-SQ8 on the "sq8" RQ cache), K3 and K1 at d 256
(phase 20d / b), each kernel its phase-16 to phase-20 launches, K4 its
times at kp 58 and 100 (phase 8), K3 its phase-21 launches and one
rank's time there, its phase-22 launches (``launches_tooling``) and its
phase-23 launches (``launches_handles``, K4's too), K4 its times at kp
106, 262 and 1030 and the parent route's above 64, K3 has a second record at
batch 1, and the global-list kernel a record of its own from phase 24:
its launches there, its time, plain time, parent time and bound at kp
106, 262 and 1030 and K3-SQ8's at kp 106, plus its launches and times on
phase 9's k-100 searches; K3-SQ8's kp 33-64 and kp >= 65 kernels a record
each, their launches on phase 24's IVF4096,SQ8 searches (and 17a's at k
100) and their times on those searches' plans) and {"ok": true, ...}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import tpu_ann_torch as T
from tpu_ann_torch import capi, kernels
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import flat_knn_fused as FK
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import hnsw as HN
from tpu_ann_torch.ops import hnsw_tiles as HT
from tpu_ann_torch.ops import ivf_scan_paged as P
from tpu_ann_torch.ops import hamming as HM
from tpu_ann_torch.ops import nndescent as ND
from tpu_ann_torch.ops import pq as PQ
from tpu_ann_torch.ops import qinco as QC
from tpu_ann_torch.ops import rq as RQ
from tpu_ann_torch.ops import row_copy_probe as B2
from tpu_ann_torch.ops import sq as SQ
from tpu_ann_torch.utils import index_io as IIO
from tpu_ann_torch.utils.benchmark import per_query_report

# recall@10 floors at nprobe 16 / 32 / 64: the JAX package's benchmark
# recalls on this workload (0.8831 / 0.9718 / 0.9978) less 0.01 for
# k-means differences
RECALL_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9878}
# IVF4096,SQ8 (QT_8BIT) on IVF-Flat's centroids: recall@10 floors at
# nprobe 16 / 32 / 64, and the most recall@10 it may lose against IVF-Flat
# in the same run. The IVF floors and 0.01 hold at nprobe 16 / 32. At
# nprobe 64 the reference's codec (encode at code / 255 of the range,
# decode at (code + 0.5) / 256) loses more than they allow: the floor is
# the 0.98565 measured there on an H100 less 0.005, and the loss limit its
# measured 0.0122 plus 0.003. Neither is derived from the run.
SQ8_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9807}
SQ8_MAX_LOSS = {16: 0.01, 32: 0.01, 64: 0.015}
# flat path recall@10 floors: the exact route, the JAX package's 0.9979 at
# W=2048 (BENCH_r05.json) less 0.001 for the order of ground-truth ties;
# the refine route, its 0.99516 at W=1024 (benchs/logs/r5_queue1.jsonl)
# less about 0.001; IP on float data has no reference value
FLAT_FLOORS = {"exact": 0.9969, "refine": 0.9942, "ip_float": 0.98}
KERNELS = ("ivf_scan_fused", "ivf_scan_sq8", "flat_knn_fused",
           "reservoir_topk", "ivf_scan_paged", "flat_knn_variants",
           "row_copy_probe")
# the libraries of the IVF list scans (K3, K3-SQ8, K4): no spill, and
# their products on the tensor cores (HMMA in the SASS)
IVF_SCANS = ("ivf_scan_fused", "ivf_scan_sq8", "ivf_scan_paged")
# IVFHNSW15625 (coarse_mode "auto") recall@10 floors at nprobe 32 / 64: the
# JAX package's 0.8754 / 0.9602 (BENCH_r05.json) less 0.01 for k-means
IVFHNSW_FLOORS = {32: 0.8654, 64: 0.9502}
# the round-4 harness's tile search at (nprobe0 12, hops 1, F 4): the JAX
# package's 0.9910 (BENCHMARKS.md, round 2's clustered set, whose generator
# is not recorded) less 0.02
GRAPH_FLOOR = 0.97
# K1p's refine route may lose this much recall@10 against phase 5's (the
# reference lost 0.001: 0.99408 against 0.99508, benchs/logs/r4_queue2 and
# r4_queue4)
PACKED_MAX_LOSS = 0.003
D, NLIST, K = 128, 4096, 10
NB, NT, NQ = 1_000_000, 100_000, 10_000
TIMED_REPS = 3
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s
# and bf16 tensor-core FLOP/s. A kernel's bound is the larger of the bytes
# it must move over the first and the products it must compute over the
# second, both counted from this run's inputs.
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median wall time of fn() (ending in a device sync), after warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def ptxas_resources(log: str):
    """(registers of each kernel, spill bytes of all) from a -Xptxas -v
    log."""
    regs, spill = [], 0
    for ln in log.splitlines():
        words = ln.replace(",", " ").split()
        if "Used" in words and "registers" in words:
            regs.append(int(words[words.index("registers") - 1]))
        for i, w in enumerate(words[2:], 2):
            if w == "spill" and words[i - 1] == "bytes":
                spill += int(words[i - 2])
    return regs, spill


# launches of the wide-list kernels (kp 33-64) of K3 and K4 on the main
# path: "k3" the quantizer-mode searches of phase 9 (hop-0 scans at kp
# 64), "k3_hnsw" phase 17a's IndexHNSWFlat at k 100 (kp 64), "k3_ivf"
# phase 24's IVF4096,Flat at k 50 (kp 56), "k4" the paged searches of
# phase 7 at k 27 / 58 (kp 33 / 64); not in counts(), whose phases compare
# launched-kernel sets
WIDE_PATH = {}


def wide_record(kp46, kp64, k4) -> dict:
    """The kernels-line record of the wide-list kernels of K3 and K4 (two
    list entries a lane, 64 pairs a CTA): their launches on the main path
    (WIDE_PATH); K3 at IVFPQR's kp 46 (phase 16e: 10k q, nprobe 32) as its
    time, plain time and bound; K3 at the hop-0 kp 64 (phase 17j) and K4
    at kp 33 / 58 (phase 8: 1024 q, nprobe 32, window 0) beside them."""
    k3 = WIDE_PATH["k3"] + WIDE_PATH["k3_hnsw"] + WIDE_PATH["k3_ivf"]
    n = k3 + WIDE_PATH["k4"]
    if not all(WIDE_PATH.values()):
        raise AssertionError(f"the main path launched the wide-list "
                             f"kernels {WIDE_PATH}")
    return {
        "name": "ivf_scan_wide",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_core.cuh (update_chunk2, "
                  "scan_tile<..., 2, kPTWide>; kernels in ivf_scan_fused.cu,"
                  " ivf_scan_sq8.cu, ivf_scan_paged.cu)",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:217-250",
        "launches": n,
        "launches_k3": k3,
        "launches_k3_ivfhnsw": WIDE_PATH["k3"],
        "launches_k3_hnsw": WIDE_PATH["k3_hnsw"],
        "launches_k3_ivf": WIDE_PATH["k3_ivf"],
        "launches_k4": WIDE_PATH["k4"],
        "max_abs_err": max(kp46["max_abs_err"], kp64["max_abs_err"]),
        "ms": kp46["ms"],
        "plain_ms": kp46["plain_ms"],
        "bound_ms": kp46["bound_ms"],
        "bound_by": kp46["bound_by"],
        "library_ms": None,
        **{f"kp64_{f}": kp64[f] for f in ("ms", "plain_ms", "bound_ms")},
        **{f"k4_kp{kp}_{f}": k4[f"kp{kp}_{f}"] for kp in (33, 58)
           for f in ("ms", "plain_ms", "bound_ms")},
    }


def reset_counts() -> None:
    F.LAUNCHES = 0
    F.LAUNCHES_SQ8 = 0
    F.LAUNCHES_WIDE = 0
    F.LAUNCHES_GLOBAL = 0
    P.LAUNCHES = 0
    P.LAUNCHES_WIDE = 0
    P.LAUNCHES_GLOBAL = 0
    B2.LAUNCHES = 0
    for name in FK.LAUNCHES:
        FK.LAUNCHES[name] = 0


def counts() -> dict:
    return {"ivf_scan_fused": F.LAUNCHES, "ivf_scan_sq8": F.LAUNCHES_SQ8,
            **FK.LAUNCHES, "ivf_scan_paged": P.LAUNCHES,
            "row_copy_probe": B2.LAUNCHES}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for the work: bytes over HBM
    bandwidth or bf16 products over the tensor-core peak, the larger."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_scan_work(plan, ids, B, d, kp, lo, hi, ta=0, tb=None,
                   running=False, elem_bytes=2, padded=False):
    """Bytes and bf16 products the per-pair scan of tiles [ta, tb) needs
    over stream blocks [lo, hi): every valid row of a pair's clamped range
    scored against its query, each valid row of a needed block read once
    (``elem_bytes`` a stream element: 2 for bf16, 1 for SQ8 codes, plus 8 B
    of id and norm a row), the queries, the plan and the (pairs, kp) result
    written once (and, ``running``, read once). ``padded`` counts every
    slot of a needed block instead, padding included: the layout's cost,
    not the work's. ``ids`` (nblocks, B) are the blocks [lo, hi) of the
    stream."""
    tb = plan.ntiles if tb is None else tb
    sl = slice(ta * F.PT, tb * F.PT)
    ps = plan.pstart[sl].long().clamp(lo, hi) - lo
    pe = plan.pend[sl].long().clamp(lo, hi) - lo
    valid = (ids[:hi - lo] >= 0).sum(1)
    csum = torch.zeros(hi - lo + 1, dtype=torch.long, device=ids.device)
    csum[1:] = torch.cumsum(valid, 0)
    rows = int((csum[pe] - csum[ps]).sum())
    mark = torch.zeros(hi - lo + 1, dtype=torch.long, device=ids.device)
    mark.index_add_(0, ps, torch.ones_like(ps))
    mark.index_add_(0, pe, -torch.ones_like(pe))
    need = torch.cumsum(mark, 0)[:hi - lo] > 0
    read = int(need.sum()) * B if padded else int(valid[need].sum())
    npairs = ps.numel()
    nq = int(plan.pair_q.max()) + 1
    nbytes = (read * (elem_bytes * d + 8) + nq * (2 * d + 4)
              + npairs * 12
              + npairs * kp * 8 * (2 if running else 1))
    return nbytes, 2.0 * rows * d


def assert_equal(name, a, b) -> None:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"in {int((a != b).sum())} entries")


def max_abs_err(a, b) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def assert_same_topk(D0, I0, D1, I1) -> None:
    """Exact distances; ids equal up to ties (equal distance, any order)."""
    if not np.array_equal(D0, D1):
        raise AssertionError(f"distances differ in "
                             f"{int((D0 != D1).sum())} entries")
    for r in range(len(D0)):
        for v in np.unique(D0[r]):
            m = D0[r] == v
            last = m[-1]              # the tie group at the cut may differ
            if not last and sorted(I0[r][m]) != sorted(I1[r][m]):
                raise AssertionError(f"row {r}: ids differ: {I0[r]} {I1[r]}")


def require_gpu() -> torch.device:
    """Exit non-zero without a CUDA device; print the card's name and power
    limit as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return torch.device("cuda")


def main() -> None:
    # -- 1. device --------------------------------------------------------
    dev = require_gpu()
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_libraries(KERNELS)
    t_build = time.perf_counter() - t0
    for name in KERNELS:
        log = kernels.build_log(name)
        regs, spill = ptxas_resources(log)
        phase("build", kernel=name, seconds=kernels.BUILD_SECONDS[name],
              registers=regs, spill_bytes=spill,
              ptxas=[ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln])
        if spill:
            raise AssertionError(f"{name} spills {spill} bytes")
    phase("build_all", seconds=t_build)

    # -- 3. main path at real size ----------------------------------------
    t0 = time.perf_counter()
    allx = T.sift_surrogate(NB + NT + NQ, seed=123, **T.SIFT1M_CALIBRATED)
    xb, xt, xq = allx[:NB], allx[NB:NB + NT], allx[NB + NT:]
    t_data = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    flat = T.IndexFlat(D, device="cuda")
    flat.add(xb)
    _, gt = flat.search(xq, K)
    # the exact top 100, shared by phases 9, 17a and 24
    _, gt100 = flat.search(xq, WIDE["k"])
    t_gt = time.perf_counter() - t0
    del flat
    if any(counts().values()):
        raise AssertionError(f"the exact ground truth launched kernels: "
                             f"{counts()}")

    reset_counts()
    n_search = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = T.make_ivf_flat(D, NLIST, device="cuda")
    index.cp.niter = 10
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    if F.LAUNCHES != 0:
        raise AssertionError("train/add launched the scan kernel")
    mem3 = index_memory(index, mem0)
    phase("build_index", data_s=t_data, ground_truth_s=t_gt,
          train_s=t_train, add_s=t_add,
          imbalance=index.imbalance_factor(),
          kmeans_final_obj=index.clustering_stats[-1].obj)

    results, flat_out, qps3 = {}, {}, {}
    for nprobe in (16, 32, 64):
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = F.LAUNCHES
        Dv, Iv = index.search(xq, K, params=p)           # warm-up
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = index.search(xq, K, params=p)      # numpy out: synced
            times.append(time.perf_counter() - t1)
        Ds, Is, st = index.search_stats(xq, K, params=p)
        n_calls = 2 + TIMED_REPS
        n_search += n_calls
        if F.LAUNCHES - before != n_calls:
            raise AssertionError(f"nprobe={nprobe}: {F.LAUNCHES - before} "
                                 f"kernel launches for {n_calls} searches")
        if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
                and (Iv >= 0).all() and (Iv < NB).all()):
            raise AssertionError(f"nprobe={nprobe}: malformed results")
        if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
            raise AssertionError("search and search_stats disagree")
        rec = T.recall_k_at_k(Iv, gt, K)
        med = float(np.median(times))
        results[nprobe] = rec
        flat_out[nprobe] = (Dv, Iv)
        qps3[nprobe] = NQ / med
        phase("search", nprobe=nprobe, recall_at_10=rec,
              floor=RECALL_FLOORS[nprobe], qps=NQ / med,
              search_ms=[t * 1e3 for t in times],
              quantization_ms=st.quantization_us / 1e3,
              list_scan_ms=st.list_scan_us / 1e3, ndis=st.ndis,
              launches=F.LAUNCHES - before)
    main_launches = F.LAUNCHES
    if FK.LAUNCHES["flat_knn_fused"] or FK.LAUNCHES["reservoir_topk"]:
        raise AssertionError(f"the IVF path launched K1 / K2: {counts()}")
    for nprobe, rec in results.items():
        if rec < RECALL_FLOORS[nprobe]:
            raise AssertionError(f"recall@10 {rec} < floor "
                                 f"{RECALL_FLOORS[nprobe]} at nprobe "
                                 f"{nprobe}")
    if main_launches != n_search or main_launches == 0:
        raise AssertionError("the main path did not run the kernel once "
                             "per search")

    # -- 4. kernel vs plain version at the main path's shapes ------------
    il = index.invlists
    xq_s = torch.from_numpy(xq[:1024]).to(dev)
    _, probes = index._coarse_search_device(xq_s, 32)
    plan = F.plan_pairs(probes, il)
    kp = F.default_kp(K)
    qn = TD.l2_norms(xq_s)
    q16 = xq_s.to(torch.bfloat16)

    d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, False)
    d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, False)
    d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
    fin = np.isfinite(d0)
    if not (np.array_equal(fin, np.isfinite(d1))
            and np.array_equal(d0, d1) and np.array_equal(p0, p1)):
        raise AssertionError("kernel per-pair top-kp differs from the "
                             "plain version")
    max_abs_err_k3 = float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() \
        else 0.0
    D1, I1, n1 = F.scan_invlists_fused(xq_s, probes, il, K)
    D0, I0, n0 = F.scan_invlists_fused_reference(xq_s, probes, il, K)
    assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                     D1.cpu().numpy(), I1.cpu().numpy())
    if int(n0) != int(n1):
        raise AssertionError("ndis differs")

    ms = cuda_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp, False), 20)
    plain_ms = host_ms(
        lambda: F.scan_pairs_reference(q16, qn, plan, il, kp, False), 3)
    search_ms = host_ms(lambda: F.scan_invlists_fused(xq_s, probes, il, K),
                        5)

    # IP on float data: the same layout with non-integer rows and queries
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    valid = (il.ids >= 0).unsqueeze(-1)
    data_f = il.data + torch.rand(il.data.shape, generator=g,
                                  device=dev) * valid
    il_f = T.PackedInvLists(
        data=data_f, data_bf16=data_f.to(torch.bfloat16), ids=il.ids,
        norms=(data_f * data_f).sum(-1), list_block_start=il.list_block_start,
        list_nblocks=il.list_nblocks)
    xq_f = xq_s + torch.randn(xq_s.shape, generator=g, device=dev)
    _, I1f, _ = F.scan_invlists_fused(xq_f, probes, il_f, K,
                                      TD.METRIC_INNER_PRODUCT)
    _, I0f, _ = F.scan_invlists_fused_reference(xq_f, probes, il_f, K,
                                                TD.METRIC_INNER_PRODUCT)
    I0f, I1f = I0f.cpu().numpy(), I1f.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / K
                             for a, b in zip(I0f, I1f)]))
    if overlap < 0.999:
        raise AssertionError(f"IP float overlap {overlap} < 0.999")
    phase("kernel_check", nq=len(xq_s), nprobe=probes.shape[1], kp=kp,
          npairs=probes.numel(),
          ntiles=plan.ntiles, pairs_equal=True, final_equal=True,
          max_abs_err=max_abs_err_k3, ip_float_overlap=overlap,
          kernel_ms=ms, plain_ms=plain_ms, fused_search_ms=search_ms)

    k3 = {
        "name": "ivf_scan_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:60",
        "launches": main_launches,
        "max_abs_err": max_abs_err_k3,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                il.nblocks)),
        "library_ms": None,
    }
    del il_f, data_f
    k3_10k, sq_records = sq_phases(index, xt, xb, xq, gt, results,
                                   flat_out, xq_s, probes, dev)
    k3.update(k3_10k)
    quant3 = index.quantizer
    del index, il
    torch.cuda.empty_cache()

    flat_records, flat_index, refine_rec = flat_phases(xb, xq, gt, dev)
    variant_records = variant_phases(flat_index, xb, xq, gt, refine_rec, dev)
    del flat_index
    torch.cuda.empty_cache()
    # every file of phases 7-14, 16 and 18 lives here; removed at the end
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        paged, k4 = paged_phases(xb, xt, xq, gt, dev, tmp)
        hidx, hnsw_auto, hnsw_k100 = ivf_hnsw_phase(xb, xt, xq, gt, gt100,
                                                    dev)
        graph_phase(dev)
        b2 = row_copy_phase(xb, dev)
        k3_b1 = workflow_phase(hidx, quant3, paged, xb, xt, xq, gt, dev, tmp)
        del paged
        ivf_api_phase(quant3, xb, xt, xq, gt, results, dev)
        pq_launches, wide = pq_phase(quant3, hidx.quantizer, hnsw_auto, xb,
                                     xt, xq, gt, results, dev, tmp)
        hnsw_launches, kp64, sq8_k100 = hnsw_rest_phase(
            hidx, hnsw_auto, xb, xt, xq, gt, gt100, dev, tmp)
        breadth_launches, k3_d64 = breadth_phase(quant3, hidx, xb, xt, xq,
                                                 gt, results, dev, tmp)
        del hidx
        torch.cuda.empty_cache()
        codec_launches, codec_k = codecs_phase(quant3, xb, xt, xq, gt,
                                               results, dev, tmp)
        family_launches, family_k = families_phase(quant3, xb, xt, xq, gt,
                                                   results, dev, tmp)
        reset_counts()
        k3.update(sharded_phase(quant3, xb, xt, xq, gt, results, dev, tmp))
        k3["launches_tooling"] = tooling_phase(quant3, xb, xt, xq, gt,
                                               results, mem3, dev, tmp)
        handles = handles_phase(quant3, xb, xt, xq, gt, results, flat_out,
                                qps3, dev, tmp)
    k3["launches_handles"] = handles["ivf_scan_fused"]
    k4["launches_handles"] = handles["ivf_scan_paged"]
    wide24 = wide_phase(quant3, xb, xt, xq, gt100, dev)
    k3["launches_pq"] = pq_launches.get("ivf_scan_fused", 0)
    k3["launches_hnsw"] = hnsw_launches.get("ivf_scan_fused", 0)
    k3["launches_breadth"] = breadth_launches.get("ivf_scan_fused", 0)
    k3["launches_codecs"] = codec_launches.get("ivf_scan_fused", 0)
    k3["launches_families"] = family_launches.get("ivf_scan_fused", 0)
    # K3 at d 256 (phase 20d: BHNSW32's bf16 tiles of 0/1 rows, 1024 q x
    # 32 tiles) and K1 at d 256 (20b: IndexBinaryFromFloat's 0/1 rows,
    # 1024 q x 1M, W 2048)
    k3.update({f"d256_{f}": family_k["k3_d256"][f] for f in
               ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")})
    flat_records[0].update(family_k["k1_d256"])
    for rec, name in ((flat_records[0], "flat_knn_fused"),
                      (flat_records[1], "reservoir_topk")):
        rec["launches_families"] = family_launches.get(name, 0)
    # K3 on the IVF-RQ16x8 bf16 cache (phase 19a, 10k q, nprobe 32) and on
    # the 1-2-block lists of IVF65536(RCQ2x8) (19c, 10k q, nprobe 64)
    for key, rec in (("rq", codec_k["k3_rq"]), ("rcq", codec_k["k3_rcq"])):
        k3.update({f"{key}_{f}": rec[f] for f in
                   ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by",
                    "padded_bound_ms")})
    # K3 at d 64 (phase 18a: PCA64,IVF4096,Flat, 10k q, nprobe 32)
    k3.update(k3_d64)
    # K3 at the IVFHNSW quantizer's kp 64 (phase 17j: the hop-0 scan of one
    # 8192-query chunk at nprobe 64), and its plain version
    k3.update(kp64_ms=kp64["ms"], kp64_plain_ms=kp64["plain_ms"],
              kp64_max_abs_err=kp64["max_abs_err"],
              kp64_bound_ms=kp64["bound_ms"])
    # K3 at IVFPQR's kp 46 (10k q, nprobe 32; one launch of the wide-list
    # kernel), its plain version and the kp-32 launch
    k3.update(kp46_ms=wide["ms"], kp46_plain_ms=wide["plain_ms"],
              kp46_ms_kp32=wide["ms_kp32"],
              kp46_max_abs_err=wide["max_abs_err"],
              kp46_bound_ms=wide["bound_ms"])
    # the kp 33-64 kernels on 17a's k-100 searches (FL: K3; HNSW16,SQ8:
    # K3-SQ8) and phase 24's IVF searches at k 50; the global-list kernels
    # on phase 9's IVFHNSW15625 searches at k 100 (K3)
    WIDE_PATH.update(k3_hnsw=sq8_k100["k3"], k3_ivf=wide24["k3_wide"])
    k3_wide = wide_record(wide, kp64, k4)
    k3_global = wide24["global"]
    k3_global["launches_ivfhnsw"] = hnsw_k100["global"]
    k3_global["launches"] += hnsw_k100["global"]
    k3_global.update({f"ivfhnsw_nprobe{n}_{f}": r[f]
                      for n, r in hnsw_k100["kernel"].items()
                      for f in ("ms", "plain_ms", "bound_ms")})
    sq8_wide = wide24["sq8_wide"]
    sq8_wide["launches_hnsw_sq8"] = sq8_k100["sq8"]
    sq8_wide["launches"] += sq8_k100["sq8"]
    sq8_wide.update({f"hnsw_hop0_{f}": sq8_k100["hop0"][f]
                     for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    sq_records[0]["launches_pq"] = pq_launches.get("ivf_scan_sq8", 0)
    sq_records[0]["launches_hnsw"] = hnsw_launches.get("ivf_scan_sq8", 0)
    sq_records[0]["launches_breadth"] = breadth_launches.get("ivf_scan_sq8",
                                                             0)
    sq_records[0]["launches_codecs"] = codec_launches.get("ivf_scan_sq8", 0)
    sq_records[0]["launches_families"] = family_launches.get("ivf_scan_sq8",
                                                             0)
    # K3-SQ8 on the IVF-RQ16x8 "sq8" cache (phase 19a, 10k q, nprobe 32)
    sq_records[0].update({f"rq_{f}": codec_k["k3sq8_rq"][f] for f in
                          ("ms", "plain_ms", "max_abs_err", "bound_ms",
                           "bound_by")})
    phase("profiler", traces_taken_again=PROFILE_RETRIES,
          event_timed_kernels=PROFILE_FALLBACKS)
    print(json.dumps({"kernels": [k3, *sq_records, *flat_records,
                                  *variant_records, k4, b2, k3_b1,
                                  k3_global, k3_wide, sq8_wide,
                                  wide24["sq8_global"]]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def assert_close_pairs(name, d0, p0, d1, p1, rtol=1e-5) -> float:
    """Per-pair top-kp outputs agree: the same empty slots, distances within
    rtol of the largest finite one, and positions equal except inside a
    group of near-equal distances (a tie within the tolerance) or in the
    group at the cut (the last slot's), where either version may keep any
    of the tied rows. Returns the largest absolute difference."""
    d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
    fin = np.isfinite(d0)
    if not np.array_equal(fin, np.isfinite(d1)):
        raise AssertionError(f"{name}: empty slots differ")
    tol = rtol * float(np.abs(d0[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"{name}: distances differ by {err} > {tol}")
    for r in np.nonzero((p0 != p1).any(1))[0]:
        for j in np.nonzero(p0[r] != p1[r])[0]:
            near = np.abs(d0[r] - d0[r, j]) <= tol
            tie_ok = near[-1] or (
                near.sum() > 1 and sorted(p0[r][near]) == sorted(p1[r][near]))
            if not tie_ok:
                raise AssertionError(f"{name}: pair {r} positions differ: "
                                     f"{p0[r]} {p1[r]}")
    return err


def sq_search(idx, xq, gt, name, nprobe, flat_rec, flat_dv_iv,
              lossy) -> dict:
    """Phase 4a for one index and nprobe: a warm-up, TIMED_REPS timed
    searches and one search_stats, each exactly one K3-SQ8 launch. A
    ``lossy`` codec is held to SQ8_FLOORS and SQ8_MAX_LOSS; a lossless one
    must return IVF-Flat's (D, I) instead."""
    p = T.SearchParametersIVF(nprobe=nprobe)
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)                  # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    Ds, Is, st = idx.search_stats(xq, K, params=p)
    now = counts()
    launches = {k: now[k] - before[k] for k in now}
    n_calls = 2 + TIMED_REPS
    if launches["ivf_scan_sq8"] != n_calls or \
            sum(launches.values()) != n_calls:
        raise AssertionError(f"{name} nprobe={nprobe}: launches {launches} "
                             f"for {n_calls} searches")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"{name} nprobe={nprobe}: malformed results")
    if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
        raise AssertionError(f"{name}: search and search_stats disagree")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    equal_flat = bool(np.array_equal(Dv, flat_dv_iv[0])
                      and np.array_equal(Iv, flat_dv_iv[1]))
    floor = SQ8_FLOORS[nprobe] if lossy else None
    max_loss = SQ8_MAX_LOSS[nprobe] if lossy else 0.0
    phase("ivf_sq_search", qtype=name, nprobe=nprobe, recall_at_10=rec,
          ivf_flat_recall=flat_rec, floor=floor, max_loss=max_loss,
          qps=NQ / med, search_ms=[t * 1e3 for t in times],
          quantization_ms=st.quantization_us / 1e3,
          list_scan_ms=st.list_scan_us / 1e3, ndis=st.ndis,
          equal_to_ivf_flat=equal_flat, launches=launches)
    if not lossy:
        if not equal_flat:
            raise AssertionError(f"{name} nprobe={nprobe}: (D, I) differ "
                                 f"from IVF-Flat's")
    elif rec < floor or flat_rec - rec > max_loss:
        raise AssertionError(f"{name} nprobe={nprobe}: recall@10 {rec} "
                             f"below {floor} or more than {max_loss} under "
                             f"IVF-Flat's {flat_rec}")
    return launches


def codec_recall(codec, xb, xq, gt, dev) -> float:
    """recall@10 of exact f32 search over the whole base encoded and
    decoded by ``codec``: the codec's own loss, apart from IVF and from
    K3-SQ8 (the plain blocked k-NN, no kernel)."""
    dec = SQ.sq_decode(SQ.sq_encode(torch.from_numpy(xb).to(dev), codec),
                       codec)
    _, I = TD.knn(torch.from_numpy(xq).to(dev), dec, K)
    return T.recall_k_at_k(I.cpu().numpy(), gt, K)


def device_stream_bytes(idx) -> dict:
    """An IVF-SQ index's device tensors: its code lists (for an 8-bit
    qtype, uint8 codes shared with its SQ8 view), and no other f32 / bf16
    tensor as large as the stream."""
    il, objs = idx.invlists, [idx.invlists]
    if idx.qtype in SQ.QT_8BIT_FAMILY:
        view = idx._sq8_view()
        if il.codes.dtype != torch.uint8 or \
                view.codes.data_ptr() != il.codes.data_ptr():
            raise AssertionError("the SQ8 view does not scan the packed "
                                 "codes")
        objs.append(view)
    held = {}
    for obj in objs:
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if t is not il.codes and t.is_floating_point() and \
                    t.numel() >= il.codes.numel():
                raise AssertionError(f"a {t.dtype} copy of the stream "
                                     f"({f.name}) lives on the device")
            held[t.data_ptr()] = t.numel() * t.element_size()
    return {"code_bytes": il.codes.numel() * il.codes.element_size(),
            "device_bytes": sum(held.values())}


def sq_phases(index, xt, xb, xq, gt, flat_rec, flat_out, xq_s, probes,
              dev) -> list:
    """Phases 4a-4c: the IVF-SQ8 path, K3-SQ8 and K3g; returns K3's time
    and bound at the main path's 10k queries (nprobe 32) and the K3-SQ8
    and K3g records of the kernels line."""
    # -- 4a. IVF-SQ8 path at real size -------------------------------------
    reset_counts()
    sq_idx = {}
    for name, qtype in (("QT_8BIT", T.QT_8BIT),
                        ("QT_8BIT_DIRECT", T.QT_8BIT_DIRECT)):
        before = counts()
        t0 = time.perf_counter()
        idx = T.IndexIVFScalarQuantizer(index.quantizer, D, NLIST, qtype,
                                        device="cuda")
        idx.quantizer_trains_alone = 1
        idx.train(xt)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.add(xb)
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        if counts() != before:
            raise AssertionError(f"{name}: train/add launched kernels")
        codec_rec = codec_recall(idx.sq, xb, xq, gt, dev)
        for nprobe in (16, 32, 64):
            sq_search(idx, xq, gt, name, nprobe, flat_rec[nprobe],
                      flat_out[nprobe], qtype != T.QT_8BIT_DIRECT)
        phase("ivf_sq", qtype=name, train_s=t_train, add_s=t_add,
              codec_recall_at_10=codec_rec,
              ivf_flat_stream_bytes=index.invlists.data_bf16.numel() * 2,
              **device_stream_bytes(idx))
        sq_idx[name] = idx
    sq_launches = counts()
    if sq_launches["ivf_scan_sq8"] == 0:
        raise AssertionError("the IVF-SQ8 path did not run K3-SQ8")

    # -- 4b. K3-SQ8 vs its plain version ------------------------------------
    il = index.invlists
    kp = F.default_kp(K)
    q16, qn = F.fold_queries(xq_s, il, False)
    plan3 = F.plan_pairs(probes, il)
    sq8_err, sq8_ms = 0.0, {}
    for name, idx in sq_idx.items():
        view = idx._sq8_view()
        plan = F.plan_pairs(probes, view)
        q, qn8 = F.fold_queries(xq_s, view, False)
        d1, p1 = F.scan_pairs(q, qn8, plan, view, kp, False)
        d0, p0 = F.scan_pairs_reference(q, qn8, plan, view, kp, False)
        if name == "QT_8BIT_DIRECT":
            assert_equal("K3-SQ8 direct distances", d0, d1)
            assert_equal("K3-SQ8 direct positions", p0, p1)
        sq8_err = max(sq8_err, assert_close_pairs(f"K3-SQ8 {name}", d0, p0,
                                                  d1, p1))
        D1, I1, _ = F.scan_invlists_fused(xq_s, probes, view, K)
        D0, I0, _ = F.scan_invlists_fused_reference(xq_s, probes, view, K)
        assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                         D1.cpu().numpy(), I1.cpu().numpy())

        def sq8():
            F.scan_pairs(q, qn8, plan, view, kp, False)

        def k3():
            F.scan_pairs(q16, qn, plan3, il, kp, False)

        a, b, c, e = (cuda_ms(sq8, 20), cuda_ms(k3, 20), cuda_ms(k3, 20),
                      cuda_ms(sq8, 20))
        sq8_ms[name] = {
            "ms": [a, e], "k3_ms": [b, c],
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q, qn8, plan, view, kp, False), 3),
            **bound(*pair_scan_work(plan, view.ids, view.block_size, D, kp,
                                    0, view.nblocks, elem_bytes=1))}
    # the main path's batch, 10k queries: K3-SQ8 against its plain
    # version on both indexes, and K3 on the same plan, alone
    xq_dev = torch.from_numpy(xq).to(dev)
    q3, qn3 = F.fold_queries(xq_dev, il, False)
    ms_10k = {}
    for nprobe in (16, 32, 64):
        _, pr = index._coarse_search_device(xq_dev, nprobe)
        p3 = F.plan_pairs(pr, il)
        row = {"ntiles": p3.ntiles}
        for name, idx in sq_idx.items():
            view = idx._sq8_view()
            p8 = F.plan_pairs(pr, view)
            q, qn8 = F.fold_queries(xq_dev, view, False)
            d1, p1 = F.scan_pairs(q, qn8, p8, view, kp, False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d0, p0 = F.scan_pairs_reference(q, qn8, p8, view, kp, False)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t1) * 1e3
            where = f"K3-SQ8 {name} nq={NQ} nprobe={nprobe}"
            if name == "QT_8BIT_DIRECT":
                assert_equal(f"{where} distances", d0, d1)
                assert_equal(f"{where} positions", p0, p1)
            sq8_err = max(sq8_err, assert_close_pairs(where, d0, p0, d1, p1))
            del d0, p0, d1, p1
            row[name] = {
                "ms": cuda_ms(lambda: F.scan_pairs(q, qn8, p8, view, kp,
                                                   False), 5),
                "plain_ms": plain,
                **bound(*pair_scan_work(p8, view.ids, view.block_size, D,
                                        kp, 0, view.nblocks, elem_bytes=1))}
        row["k3_ms"] = cuda_ms(
            lambda: F.scan_pairs(q3, qn3, p3, il, kp, False), 5)
        row["k3_bound"] = bound(*pair_scan_work(p3, il.ids, il.block_size, D,
                                                kp, 0, il.nblocks))
        ms_10k[nprobe] = row
    phase("sq8_kernel_check", nq=[len(xq_s), NQ], nprobe=probes.shape[1],
          kp=kp, ntiles=plan3.ntiles, direct_equal=True, pairs_equal_10k=True,
          max_abs_err=sq8_err, calls=sq8_ms, calls_10k=ms_10k)

    # -- 4c. K3g: the grid route on a cut plan -------------------------------
    view = sq_idx["QT_8BIT"]._sq8_view()
    full = F.grid2d_maxc(il, probes)
    cut = full // 2
    while cut > 1 and torch.equal(F.truncate_plan(plan3, cut).tile_nb,
                                  plan3.tile_nb):
        cut //= 2
    reset_counts()
    Dg, Ig, _ = F.scan_invlists_fused_grid(xq_s, probes, il, K, maxc=full)
    Dc, Ic, _ = F.scan_invlists_fused_grid(xq_s, probes, il, K, maxc=cut)
    Dcs, Ics, _ = F.scan_invlists_fused_grid(xq_s, probes, view, K,
                                             maxc=cut)
    torch.cuda.synchronize()
    grid_launches = counts()
    if grid_launches["ivf_scan_fused"] != 2 or \
            grid_launches["ivf_scan_sq8"] != 1 or \
            sum(grid_launches.values()) != 3:
        raise AssertionError(f"the K3g route launched {grid_launches}")
    D3, I3, _ = F.scan_invlists_fused(xq_s, probes, il, K)
    assert_equal("K3g uncut distances vs K3", D3, Dg)
    assert_equal("K3g uncut ids vs K3", I3, Ig)
    g_err = 0.0
    for name, lists, q, n, Dk, Ik in (("bf16", il, q16, qn, Dc, Ic),
                                       ("sq8", view,
                                        *F.fold_queries(xq_s, view, False),
                                        Dcs, Ics)):
        cplan = F.truncate_plan(F.plan_pairs(probes, lists), cut)
        d1, p1 = F.scan_pairs(q, n, cplan, lists, kp, False)
        d0, p0 = F.scan_pairs_reference(q, n, cplan, lists, kp, False)
        if name == "bf16":
            assert_equal("K3g cut distances", d0, d1)
            assert_equal("K3g cut positions", p0, p1)
        g_err = max(g_err, assert_close_pairs(f"K3g {name}", d0, p0, d1,
                                              p1))
        D0, I0, _ = F.scan_invlists_fused_reference(xq_s, probes, lists, K,
                                                    maxc=cut)
        assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                         Dk.cpu().numpy(), Ik.cpu().numpy())
    cplan = F.truncate_plan(plan3, cut)
    g_ms = cuda_ms(lambda: F.scan_pairs(q16, qn, cplan, il, kp, False), 20)
    g_plain = host_ms(lambda: F.scan_pairs_reference(q16, qn, cplan, il, kp,
                                                     False), 3)
    g_route = host_ms(lambda: F.scan_invlists_fused_grid(
        xq_s, probes, il, K, maxc=cut), 5)
    g_bound = bound(*pair_scan_work(cplan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks))
    phase("k3g_check", nq=len(xq_s), nprobe=probes.shape[1], maxc_full=full,
          maxc_cut=cut, tiles_cut=int((cplan.tile_nb < plan3.tile_nb).sum()),
          uncut_equal_k3=True, max_abs_err=g_err, kernel_ms=g_ms,
          plain_ms=g_plain, route_ms=g_route, launches=grid_launches,
          **g_bound)
    del sq_idx
    torch.cuda.empty_cache()

    rec = sq8_ms["QT_8BIT"]
    at32 = ms_10k[32]
    k3_10k = {"ms_10k": at32["k3_ms"],
              "bound_ms_10k": at32["k3_bound"]["bound_ms"]}
    return k3_10k, [{
        "name": "ivf_scan_sq8",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_sq8.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:172",
        "launches": sq_launches["ivf_scan_sq8"],
        "max_abs_err": sq8_err,
        "ms": min(rec["ms"]),
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
        "ms_10k": at32["QT_8BIT"]["ms"],
        "bound_ms_10k": at32["QT_8BIT"]["bound_ms"],
    }, {
        "name": "ivf_scan_fused_grid",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu, "
                  "tpu_ann_torch/csrc/ivf_scan_sq8.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:542",
        "launches": sum(grid_launches.values()),
        "max_abs_err": g_err,
        "ms": g_ms,
        "plain_ms": g_plain,
        **g_bound,
        "library_ms": None,
    }]


def flat_search(index, xq, gt, name, floor) -> float:
    """Phase 5 for one route: a warm-up and TIMED_REPS timed searches
    (numpy in and out), each exactly one K1 and one K2 launch."""
    before = counts()
    Dv, Iv = index.search(xq, K)                      # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = index.search(xq, K)
        times.append(time.perf_counter() - t1)
    n_calls = 1 + TIMED_REPS
    now = counts()
    for kname in ("flat_knn_fused", "reservoir_topk"):
        if now[kname] - before[kname] != n_calls:
            raise AssertionError(f"{name}: {now[kname] - before[kname]} "
                                 f"{kname} launches for {n_calls} searches")
    if now["ivf_scan_fused"] != before["ivf_scan_fused"]:
        raise AssertionError(f"{name}: the flat path launched K3")
    if not (Dv.shape == Iv.shape == (len(xq), K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < index.ntotal).all()):
        raise AssertionError(f"{name}: malformed results")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    phase("flat_search", route=name, recall_at_10=rec, floor=floor,
          qps=len(xq) / med, search_ms=[t * 1e3 for t in times],
          launches={k: now[k] - before[k] for k in now})
    if rec < floor:
        raise AssertionError(f"{name}: recall@10 {rec} < floor {floor}")
    return rec


def flat_phases(xb, xq, gt, dev):
    """Phases 5 and 6: the fused flat path and its kernels; returns the
    K1 and K2 records of the kernels line, the opted-in IndexFlat and its
    refine route's recall@10."""
    # -- 5. flat path at real size ----------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    index = T.IndexFlat(D, device="cuda")
    index.add(xb)
    index.compute_dtype, index.approx_topk = "bfloat16", True
    xq_dev = torch.from_numpy(xq).to(dev)
    if not (index.scan_mode == "auto" and index._use_fused(K)):
        raise AssertionError("the opted-in IndexFlat does not take the "
                             "fused path")
    flat_search(index, xq, gt, "exact", FLAT_FLOORS["exact"])
    if index._db_int_max is None or not index._use_exact_kernel(xq_dev):
        raise AssertionError("the integer-exact route was not chosen")
    index.exact_kernel = False
    refine_rec = flat_search(index, xq, gt, "refine", FLAT_FLOORS["refine"])
    index.exact_kernel = None
    flat_launches = counts()
    t_flat = time.perf_counter() - t0

    # IP on float data: base rows + uniform noise in [0, 1)
    rng = np.random.default_rng(7)
    xb_f = xb + rng.random(xb.shape, dtype=np.float32)
    xq_f = xq[:1024] + rng.random(xq[:1024].shape, dtype=np.float32)
    exact_ip = T.IndexFlatIP(D, device="cuda")
    exact_ip.add(xb_f)
    _, gt_ip = exact_ip.search(xq_f, K)
    del exact_ip
    ip = T.IndexFlatIP(D, device="cuda")
    ip.add(xb_f)
    ip.compute_dtype, ip.approx_topk = "bfloat16", True
    flat_search(ip, xq_f, gt_ip, "ip_float", FLAT_FLOORS["ip_float"])
    del ip, xb_f
    torch.cuda.empty_cache()
    phase("flat_path", seconds=t_flat, launches=flat_launches)

    # -- 6. K1 and K2 vs their plain versions -----------------------------
    data, bias = index._fused_packed
    q = torch.from_numpy(xq[:1024]).to(dev)
    qv = torch.zeros((len(q), data.shape[-1]), device=dev)
    qv[:, :D] = -2.0 * q
    qv = qv.to(torch.bfloat16)
    qv_10k = torch.zeros((NQ, data.shape[-1]), device=dev)
    qv_10k[:, :D] = -2.0 * xq_dev
    qv_10k = qv_10k.to(torch.bfloat16)
    k1_err = k2_err = 0.0
    k1, k2 = {}, {}
    for W in (2048, 1024):
        v1, p1 = FK.flat_reservoir(qv, data, bias, W)
        v0, p0 = FK.flat_reservoir_reference(qv, data, bias, W)
        assert_equal(f"K1 values W={W}", v0, v1)
        assert_equal(f"K1 positions W={W}", p0, p1)
        # the main path's batch: 10k queries, so a partial last block of 16
        rv10, rp10 = FK.flat_reservoir(qv_10k, data, bias, W)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rv0, rp0 = FK.flat_reservoir_reference(qv_10k, data, bias, W)
        torch.cuda.synchronize()
        plain_10k = (time.perf_counter() - t1) * 1e3
        assert_equal(f"K1 values W={W} nq={NQ}", rv0, rv10)
        assert_equal(f"K1 positions W={W} nq={NQ}", rp0, rp10)
        k1_err = max(k1_err, max_abs_err(v0, v1), max_abs_err(rv0, rv10))
        del rv0, rp0
        k1[W] = {
            "ms": cuda_ms(lambda: FK.flat_reservoir(qv, data, bias, W), 5),
            "plain_ms": host_ms(
                lambda: FK.flat_reservoir_reference(qv, data, bias, W), 2),
            "ms_10k": cuda_ms(
                lambda: FK.flat_reservoir(qv_10k, data, bias, W), 3),
            "plain_ms_10k": plain_10k}
        if W == 2048:
            k1_bound = bound(data.numel() * 2 + bias.numel() * 4
                             + qv.numel() * 2 + v1.numel() * 8,
                             2.0 * len(q) * index.ntotal * D)
        # K2 on the first nq rows of the reservoir, at the path's k for
        # this W (the exact route's 10 at 2048, the refine route's 40 at
        # 1024) and, for the check alone, the other
        path_k = 10 if W == 2048 else 40
        batches = {1: (v1[:1], p1[:1]), 64: (v1[:64], p1[:64]),
                   len(q): (v1, p1), NQ: (rv10, rp10)}
        for k in (10, 40):
            for nq, (rv, rp) in batches.items():
                o1 = FK.reservoir_topk(rv, rp, k)
                o0 = FK.reservoir_topk_reference(rv, rp, k)
                assert_equal(f"K2 values W={W} k={k} nq={nq}",
                             o0[0].view(torch.int32), o1[0].view(torch.int32))
                assert_equal(f"K2 positions W={W} k={k} nq={nq}", o0[1],
                             o1[1])
                k2_err = max(k2_err, max_abs_err(o0[0], o1[0]))
                if k != path_k:
                    continue
                # device times (the kernels' own, under the profiler):
                # at small batches a CUDA-event loop times the host
                def topk():
                    return torch.topk(rv, k, dim=1, largest=False)
                k2[(W, k, nq)] = {
                    "ms": device_ms(lambda: FK.reservoir_topk(rv, rp, k),
                                    kernel="reservoir_topk"),
                    "events_ms": cuda_ms(
                        lambda: FK.reservoir_topk(rv, rp, k), 20),
                    "plain_ms": host_ms(
                        lambda: FK.reservoir_topk_reference(rv, rp, k), 5),
                    # one torch call selecting the same k smallest of a row
                    "library_ms": device_ms(topk),
                    "library_events_ms": cuda_ms(topk, 20),
                    **bound(nq * W * 4 + nq * k * 12, 0.0),
                    "bound_ms_read_all": bound(nq * W * 8 + nq * k * 8,
                                               0.0)["bound_ms"]}
        del rv10, rp10
    phase("flat_kernel_check", nq=[len(q), NQ], nb=index.ntotal,
          k1_equal=True, k2_equal=True,
          k1={str(W): t for W, t in k1.items()},
          k2={f"W{W}_k{k}_nq{nq}": t for (W, k, nq), t in k2.items()},
          small_batches=k1_batch_times(qv_10k, data, bias, (1, 64, 65)))
    k2_main, k2_10k = k2[(2048, 10, len(q))], k2[(2048, 10, NQ)]

    return [{
        "name": "flat_knn_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/flat_knn_fused.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:472",
        "launches": flat_launches["flat_knn_fused"],
        "max_abs_err": k1_err,
        "ms": k1[2048]["ms"],
        "plain_ms": k1[2048]["plain_ms"],
        **k1_bound,
        "library_ms": None,
    }, {
        "name": "reservoir_topk",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/reservoir_topk.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:283",
        "launches": flat_launches["reservoir_topk"],
        "max_abs_err": k2_err,
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "ms_10k": k2_10k["ms"],
        "bound_ms_10k": k2_10k["bound_ms"],
        "library_ms_10k": k2_10k["library_ms"],
    }], index, refine_rec


def k1_batch_times(qv, data, bias, batches) -> dict:
    """K1 at W 2048 and 1024 and K1p at W 1024 on the first nq rows of qv
    for each nq in batches: device times (CUDA events), each output below
    NQ queries bit for bit against its plain version first. Uses only the
    wrappers' public calls, so it times an older tree's kernels as well."""
    # K1p's bias shifted by max ||q||^2 + 1 (qv = -2q, L2), every score
    # non-negative
    shifted = (bias + (qv.float() ** 2).sum(1).max() / 4 + 1).contiguous()
    out = {}
    for nq in batches:
        q = qv[:nq]
        runs = {f"k1_w{W}": (lambda W=W: FK.flat_reservoir(q, data, bias, W),
                             lambda W=W: FK.flat_reservoir_reference(
                                 q, data, bias, W))
                for W in (2048, 1024)}
        runs["k1p_w1024"] = (
            lambda: FK.flat_reservoir_packed(q, data, shifted, 1024),
            lambda: FK.flat_reservoir_packed_reference(q, data, shifted,
                                                       1024))
        for name, (kernel, plain) in runs.items():
            if nq < NQ:
                a, b = kernel(), plain()
                for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                    assert_equal(f"{name} nq={nq}", y, x)
            out[f"{name}_nq{nq}_ms"] = cuda_ms(kernel, 3 if nq >= NQ else 10)
    return out


def k1_batches() -> None:
    """--k1-batches: K1 and K1p times at batch sizes 1 to 10k over a 1M x
    128 base of random integers in [0, 64) (seed 0), built from this
    checkout's sources. Run it from another tree's root (a copy of this
    script there) to time that tree's kernels on the same inputs."""
    dev = require_gpu()
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = torch.randint(0, 64, (NB, D), generator=gen, device=dev).float()
    xq = torch.randint(0, 64, (NQ, D), generator=gen, device=dev).float()
    data, bias = FK.pack_flat_db(xb, TD.METRIC_L2)
    del xb
    qv = (-2.0 * xq).to(torch.bfloat16)
    phase("k1_batches", device=torch.cuda.get_device_name(0), nb=NB, d=D,
          **k1_batch_times(qv, data, bias, (1, 64, 65, 128, 1024, NQ)))


def k2_batches() -> None:
    """--k2-batches: K2 at the flat path's two shapes (W 2048 k 10, W 1024
    k 40) on the first 1, 64, 1024 and 10k rows of a random reservoir
    (integer values in [-50000, 50000), positions in [0, 10^6), seed 0):
    each output bit for bit against its plain version, then the kernel's
    and torch.topk's device times (profiler). Uses only the wrappers'
    public calls, so from a copy in another tree's root it times that
    tree's K2 on the same inputs."""
    dev = require_gpu()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for W, k in ((2048, 10), (1024, 40)):
        v = torch.randint(-50000, 50000, (NQ, W), generator=gen,
                          device=dev).float()
        p = torch.randint(0, 10**6, (NQ, W), generator=gen, device=dev,
                          dtype=torch.int32)
        for nq in (1, 64, 1024, NQ):
            rv, rp = v[:nq], p[:nq]
            o1, o0 = FK.reservoir_topk(rv, rp, k), \
                FK.reservoir_topk_reference(rv, rp, k)
            assert_equal(f"K2 values W={W} k={k} nq={nq}",
                         o0[0].view(torch.int32), o1[0].view(torch.int32))
            assert_equal(f"K2 positions W={W} k={k} nq={nq}", o0[1], o1[1])
            out[f"W{W}_k{k}_nq{nq}"] = {
                "ms": device_ms(lambda: FK.reservoir_topk(rv, rp, k),
                                kernel="reservoir_topk"),
                "library_ms": device_ms(
                    lambda: torch.topk(rv, k, dim=1, largest=False)),
                **bound(nq * W * 4 + nq * k * 12, 0.0)}
    phase("k2_batches", device=torch.cuda.get_device_name(0), **out)


def pinned_gbps(dev, nbytes: int = 1 << 28) -> float:
    """Host-to-device bandwidth of one pinned buffer, alone (GB/s)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    return nbytes / ms / 1e6


# (name, window_blocks, the first half of the stream resident on the
# device): the default window, many windows with straddling tiles, and
# the hot tier
# K4 above 32 entries a pair (phases 7-8): the searches' k (kp 33 / 64 /
# 106: the two-entries-a-lane kernel, and the lists in global memory above
# 64), the kp held against the plain version (all timed from 58 up, and
# the parent route, `scan_window_wide`, above 64), at WIDE_NQ queries and
# nprobe 32
WIDE_KS = (27, 58, 100)
WIDE_KPS = (33, 58, 64, 100, 106, 262, 1030)
WIDE_NQ = 1024
PAGED_SETTINGS = (("default", 8192, False), ("w1024", 1024, False),
                  ("hot_half", 1024, True))


def paged_search(idx, xq, gt, setting, nprobe):
    """Phase 7 for one setting and nprobe: a warm-up, TIMED_REPS timed
    searches (numpy in and out) and one search_stats; each search is
    stats["calls"] K4 launches and nothing else."""
    p = T.SearchParametersIVF(nprobe=nprobe)
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)                  # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    Ds, Is, st = idx.search_stats(xq, K, params=p)
    now = counts()
    n_calls = 2 + TIMED_REPS
    ex = st.extra
    k4 = now["ivf_scan_paged"] - before["ivf_scan_paged"]
    if k4 != n_calls * ex["calls"]:
        raise AssertionError(f"{setting} nprobe={nprobe}: {k4} K4 launches "
                             f"for {n_calls} searches of {ex['calls']} "
                             f"calls")
    others = {k: now[k] - before[k] for k in now if k != "ivf_scan_paged"}
    if any(others.values()):
        raise AssertionError(f"{setting}: the paged path launched {others}")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"{setting} nprobe={nprobe}: malformed results")
    if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
        raise AssertionError("search and search_stats disagree")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    phase("paged_search", setting=setting, nprobe=nprobe, recall_at_10=rec,
          floor=RECALL_FLOORS[nprobe], qps=NQ / med,
          search_ms=[t * 1e3 for t in times],
          coarse_ms=st.quantization_us / 1e3,
          list_scan_ms=st.list_scan_us / 1e3,
          windows_ms=ex["windows_ms"], stage_ms=ex["stage_ms"],
          upload_ms=ex["upload_ms"], gather_ms=ex["gather_ms"],
          rerank_ms=ex["rerank_ms"], windows=ex["windows"],
          calls=ex["calls"], windows_resident=ex["windows_resident"],
          bytes_uploaded=ex["bytes_uploaded"],
          upload_gbps=(ex["bytes_uploaded"] / ex["upload_ms"] / 1e6
                       if ex["upload_ms"] else None),
          launches=k4)
    if rec < RECALL_FLOORS[nprobe]:
        raise AssertionError(f"{setting}: recall@10 {rec} < floor "
                             f"{RECALL_FLOORS[nprobe]} at nprobe {nprobe}")
    return Dv, Iv, ex


def paged_phases(xb, xt, xq, gt, dev, tmp):
    """Phases 7 and 8: the out-of-core path and K4, the index's directory
    and the base's memmap under ``tmp``; returns K4's record of the
    kernels line and the loaded index."""
    # -- 7. out-of-core path at real size ---------------------------------
    link_gbps = pinned_gbps(dev)
    t0 = time.perf_counter()
    xb_mm = np.memmap(os.path.join(tmp, "xb.f32"), mode="w+",
                      dtype=np.float32, shape=xb.shape)
    xb_mm[:] = xb
    xb_mm.flush()
    path = os.path.join(tmp, "index")
    t_write = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    build = T.IndexIVFFlatPaged(D, NLIST, path)
    build.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.add(xb_mm)
    t_add = time.perf_counter() - t0
    del build, xb_mm
    if any(counts().values()):
        raise AssertionError(f"the paged build launched kernels: {counts()}")
    idx = T.IndexIVFFlatPaged.load(path)
    pil = idx.invlists
    phase("paged_build", memmap_write_s=t_write, train_s=t_train,
          add_s=t_add, nblocks=pil.nblocks, dp=pil.dp,
          stream_bytes=pil.nbytes_stream(), pinned_link_gbps=link_gbps)

    results = {}
    reset_counts()
    for setting, window, hot in PAGED_SETTINGS:
        idx.window_blocks = window
        idx.resident_blocks = pil.nblocks // 2 if hot else 0
        idx._resident = None
        for nprobe in (16, 32, 64):
            results[setting, nprobe] = paged_search(idx, xq, gt, setting,
                                                    nprobe)
        ex = results[setting, 64][2]
        if setting != "default" and ex["windows"] < 2:
            raise AssertionError(f"{setting}: {ex['windows']} windows")
        if setting == "hot_half" and ex["windows_resident"] < 1:
            raise AssertionError("the hot tier served no window")
    paged_launches = counts()
    if paged_launches["ivf_scan_paged"] == 0:
        raise AssertionError("the paged path did not run K4")
    idx.resident_blocks, idx._resident = 0, None
    torch.cuda.empty_cache()

    # K3 over a device copy of the same directory's arrays, same probes
    il = T.PackedInvLists.from_arrays(pil.data_f32, pil.ids, pil.norms,
                                      pil.list_block_start, pil.list_nblocks,
                                      device=dev)
    xq_dev = torch.from_numpy(xq).to(dev)
    for nprobe in (16, 32, 64):
        _, probes = TD.knn(xq_dev, idx._cent_dev, nprobe)
        D3, I3, _ = F.scan_invlists_fused(xq_dev, probes, il, K)
        D3, I3 = D3.cpu().numpy(), I3.cpu().numpy()
        for setting, _, _ in PAGED_SETTINGS:
            Dp, Ip, _ = results[setting, nprobe]
            if not (np.array_equal(Dp, D3) and np.array_equal(Ip, I3)):
                raise AssertionError(
                    f"{setting} nprobe={nprobe}: paged (D, I) differ from "
                    f"K3's in {int((Dp != D3).sum())} / "
                    f"{int((Ip != I3).sum())} entries")
    # the search at k 27 / 58 / 100: K4's wide routes launched, (D, I)
    # equal to K3's over the device copy
    _, probes_w = TD.knn(xq_dev[:WIDE_NQ], idx._cent_dev, 32)
    wide_launches = {}
    P.LAUNCHES_WIDE = 0
    for k in WIDE_KS:
        before = P.LAUNCHES
        Dp, Ip = idx.search(xq[:WIDE_NQ], k,
                            params=T.SearchParametersIVF(nprobe=32))
        wide_launches[k] = P.LAUNCHES - before
        D3, I3, _ = F.scan_invlists_fused(xq_dev[:WIDE_NQ], probes_w, il, k)
        if wide_launches[k] == 0:
            raise AssertionError(f"the paged search at k {k} ran no K4")
        if not (np.array_equal(Dp, D3.cpu().numpy())
                and np.array_equal(Ip, I3.cpu().numpy())):
            raise AssertionError(f"k {k}: paged (D, I) differ from K3's")
    WIDE_PATH["k4"] = P.LAUNCHES_WIDE
    del il
    torch.cuda.empty_cache()
    phase("paged_path", launches=paged_launches, equal_to_k3=True,
          wide_k_launches=wide_launches, wide_k_equal_to_k3=True,
          wide_kernel_launches=WIDE_PATH["k4"])

    # -- 8. K4 vs its plain version at the path's shapes -------------------
    _, probes = TD.knn(xq_dev, idx._cent_dev, 32)
    plan = F.plan_pairs(probes, pil)
    kp = F.default_kp(K)
    qn = TD.l2_norms(xq_dev)
    q16 = xq_dev.to(torch.bfloat16)
    tbs = plan.tile_bs.long().cpu().numpy()
    tbe = tbs + plan.tile_nb.long().cpu().numpy()
    W = PAGED_SETTINGS[0][1]
    entries = list(P._plan_windows(tbs, tbe, W, idx.tile_batch))
    firsts = [e for i, e in enumerate(entries)
              if i == 0 or e[0] != entries[i - 1][0]]
    if len(firsts) < 2:
        raise AssertionError("phase 8 needs two windows")
    rd = torch.full((plan.ntiles * F.PT, kp), float("inf"), device=dev)
    rp = torch.full(rd.shape, -1, dtype=torch.int32, device=dev)
    k4_err, checks = 0.0, []
    for w0, ta, tb in firsts[:2]:
        win = P.window_of(pil, w0, min(W, pil.nblocks - w0), dev)
        d96 = P.Window(win.data_bf16.clone(), win.ids, None)
        d96.data_bf16[..., 96:] = 0
        d96.norms = (d96.data_bf16.float() ** 2).sum(-1)
        q96 = q16.clone()
        q96[:, 96:] = 0
        qn96 = (q96.float() ** 2).sum(1)
        for name, w, q, n in (("d128", win, q16, qn), ("d96", d96, q96,
                                                        qn96)):
            r1 = (rd.clone(), rp.clone())
            r0 = (rd.clone(), rp.clone())
            P.scan_window(q, n, plan, w, w0, ta, tb, *r1, False)
            P.scan_window_reference(q, n, plan, w, w0, ta, tb, *r0, False)
            assert_equal(f"K4 {name} w0={w0} distances", r0[0], r1[0])
            assert_equal(f"K4 {name} w0={w0} positions", r0[1], r1[1])
            k4_err = max(k4_err, max_abs_err(r0[0], r1[0]))
            if name == "d128":
                nxt = r1
                run = (rd.clone(), rp.clone())

                def reset_run():
                    run[0].copy_(rd)
                    run[1].copy_(rp)

                def call():
                    reset_run()
                    P.scan_window(q, n, plan, w, w0, ta, tb, *run, False)

                def plain():
                    reset_run()
                    P.scan_window_reference(q, n, plan, w, w0, ta, tb,
                                            *run, False)

                copy_ms = cuda_ms(reset_run, 20)
                checks.append({
                    "w0": w0, "tiles": [ta, tb], "nblocks": w.nblocks,
                    "ms": cuda_ms(call, 10) - copy_ms,
                    "plain_ms": host_ms(plain, 2) - copy_ms,
                    **bound(*pair_scan_work(plan, w.ids, w.block_size, D,
                                            kp, w0, w0 + w.nblocks, ta, tb,
                                            running=True))})
        rd, rp = nxt
        del win, d96
    phase("paged_kernel_check", nq=NQ, nprobe=32, kp=kp, ntiles=plan.ntiles,
          equal=True, d96_equal=True, max_abs_err=k4_err, calls=checks)
    wide, k4_err = k4_wide_check(pil, probes_w, q16[:WIDE_NQ].contiguous(),
                                 qn[:WIDE_NQ].contiguous(), W,
                                 idx.tile_batch, dev, k4_err)
    os.remove(os.path.join(tmp, "xb.f32"))
    first = checks[0]
    return idx, {
        "name": "ivf_scan_paged",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_paged.cu",
        "replaces": "tpu_ann/ops/ivf_scan_paged.py:339",
        "launches": paged_launches["ivf_scan_paged"],
        "max_abs_err": k4_err,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
        "ms_10k": [c["ms"] for c in checks],
        "bound_ms_10k": [c["bound_ms"] for c in checks],
        **wide,
    }


def k4_wide_check(pil, probes, q16, qn, W, tb_batch, dev, k4_err):
    """Phase 8's wide part: K4 at each of WIDE_KPS against its plain
    version after each of the first two windows (WIDE_NQ queries, nprobe
    32), one launch a call, of the global-list kernel above kp 64; its
    time, its plain version's and its bound from kp 58 up on the first
    window, and above kp 64 the parent route's (`scan_window_wide` over
    the kp-32 launch). Returns (the kernels-line fields, the largest
    absolute error so far)."""
    plan = F.plan_pairs(probes, pil)
    tbs = plan.tile_bs.long().cpu().numpy()
    tbe = tbs + plan.tile_nb.long().cpu().numpy()
    entries = list(P._plan_windows(tbs, tbe, W, tb_batch))
    firsts = [e for i, e in enumerate(entries)
              if i == 0 or e[0] != entries[i - 1][0]][:2]
    run = {kp: (torch.full((plan.ntiles * F.PT, kp), float("inf"),
                           device=dev),
                torch.full((plan.ntiles * F.PT, kp), -1, dtype=torch.int32,
                           device=dev)) for kp in WIDE_KPS}
    out, before = {}, P.LAUNCHES
    for w0, ta, tb in firsts:
        win = P.window_of(pil, w0, min(W, pil.nblocks - w0), dev)
        for kp in WIDE_KPS:
            r1 = tuple(t.clone() for t in run[kp])
            r0 = tuple(t.clone() for t in run[kp])
            got = (P.LAUNCHES, P.LAUNCHES_GLOBAL)
            P.scan_window(q16, qn, plan, win, w0, ta, tb, *r1, False)
            got = (P.LAUNCHES - got[0], P.LAUNCHES_GLOBAL - got[1])
            if got != (1, int(kp > F.KP_MAX)):
                raise AssertionError(f"K4 kp {kp}: launches {got}")
            P.scan_window_reference(q16, qn, plan, win, w0, ta, tb, *r0,
                                    False)
            assert_equal(f"K4 kp {kp} w0={w0} distances", r0[0], r1[0])
            assert_equal(f"K4 kp {kp} w0={w0} positions", r0[1], r1[1])
            k4_err = max(k4_err, max_abs_err(r0[0], r1[0]))
            if w0 == firsts[0][0]:
                cur = tuple(t.clone() for t in run[kp])

                def reset():
                    cur[0].copy_(run[kp][0])
                    cur[1].copy_(run[kp][1])

                def call():
                    reset()
                    P.scan_window(q16, qn, plan, win, w0, ta, tb, *cur,
                                  False)

                def plain():
                    reset()
                    P.scan_window_reference(q16, qn, plan, win, w0, ta, tb,
                                            *cur, False)

                copy_ms = cuda_ms(reset, 20)
                b = bound(*pair_scan_work(plan, win.ids, win.block_size, D,
                                          kp, w0, w0 + win.nblocks, ta, tb,
                                          running=True))
                def parent():
                    reset()
                    P.scan_window_wide(q16, qn, plan, win, w0, ta, tb, *cur,
                                       False, P._launch_fresh)

                out.update({f"kp{kp}_ms": cuda_ms(call, 10) - copy_ms,
                            f"kp{kp}_plain_ms": host_ms(plain, 2) - copy_ms,
                            f"kp{kp}_bound_ms": b["bound_ms"],
                            f"kp{kp}_bound_by": b["bound_by"]})
                if kp > F.KP_MAX:
                    out[f"kp{kp}_parent_ms"] = cuda_ms(parent, 3) - copy_ms
            run[kp] = r1
        del win
    phase("paged_kernel_wide", nq=len(q16), nprobe=probes.shape[1],
          kps=list(WIDE_KPS), windows=[e[0] for e in firsts], equal=True,
          launches=P.LAUNCHES - before, **out)
    return out, k4_err


# -- phases 9-13: the HNSW graph path, K1p, the B1 ladder and B2 -------------

def parse_sass_mma(listing: str) -> dict:
    """Tensor-core instructions per kernel in a ``cuobjdump -sass``
    listing: {function: {"HMMA": warp-level mma.sync, "HGMMA": warpgroup
    wgmma}}."""
    found, fn = {}, None
    for ln in listing.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            found[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HMMA", "HGMMA"):
                if op + "." in ln:
                    found[fn][op] += 1
    return found


def sass_mma_counts(name: str) -> dict:
    """`parse_sass_mma` of the built library ``name`` (cuobjdump from
    nvcc's directory)."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", kernels.library_path(name)],
                         capture_output=True, text=True, check=True).stdout
    return parse_sass_mma(out)


def device_profile(fn, top: int = 4, kernel: str = "") -> dict:
    """One call of fn under torch.profiler: its wall time (profiler on),
    the device time summed over the device's own events (kernels and
    copies; the host-side operator entries that launched them are left
    out, so nothing is counted twice), the busy share (busy / wall, one
    stream), the device events that took the most time and, with
    ``kernel``, the device time of each launch of the kernels whose name
    holds it, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    # None where the profiler saw no device event: "not measured"
    busy = sum(e.self_device_time_total for e in ev) / 1e3 if ev else None
    ev.sort(key=lambda e: -e.self_device_time_total)
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "busy_share": busy / wall if ev else None,
           "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                   for e in ev[:top]]}
    if kernel:
        runs = sorted((e.time_range.start, e.self_device_time_total / 1e3)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA and kernel in e.name)
        out["launches_ms"] = [ms for _, ms in runs]
    return out


# traces device_ms took again (each repeats its 2 x reps calls of fn)
PROFILE_RETRIES = 0
# kernels that device_ms timed with CUDA events (reps + 1 calls of fn)
# after three traces held none of their launches
PROFILE_FALLBACKS: list = []


def device_ms(fn, reps: int = 20, kernel: str = "") -> float:
    """Mean device time of a call of fn over reps calls under
    torch.profiler: the launches of the kernels whose name holds
    ``kernel``, or without it every device event (None where the profiler
    saw none: not measured). A trace that holds none of the kernel's
    launches (the profiler now and then returns one without them) is
    taken again, up to three times in all (counted in PROFILE_RETRIES);
    then fn is timed with CUDA events instead (listed in
    PROFILE_FALLBACKS, which the last phase prints)."""
    global PROFILE_RETRIES
    if kernel:
        for _ in range(3):
            prof = device_profile(lambda: [fn() for _ in range(reps)],
                                  kernel=kernel)
            if prof["launches_ms"]:
                return sum(prof["launches_ms"]) / reps
            PROFILE_RETRIES += 1
        PROFILE_FALLBACKS.append(kernel)
        return cuda_ms(fn, reps)
    prof = device_profile(lambda: [fn() for _ in range(reps)])
    busy = prof["device_busy_ms"]
    return None if busy is None else busy / reps


def variant_phases(index, xb, xq, gt, refine_rec, dev) -> list:
    """Phases 11 and 12: K1p through flat_knn_fused(merge="packed") and the
    B1 probe ladder, on phase 5's IndexFlat and data; returns their records
    of the kernels line."""
    # -- 11. K1p on the r5 harness's grid ---------------------------------
    xb_dev = index.vectors
    xq_dev = torch.from_numpy(xq).to(dev)
    packs = {(8192, 1): index._fused_packed}
    grid = (("grid_W1024", dict(R=8192, W=1024, schedule="grid")),
            ("grid_W2048", dict(R=16384, W=2048, schedule="grid")),
            ("fori_U4", dict(R=8192, W=1024, schedule="fori", unroll=4)))
    reset_counts()
    n_calls, rows = 0, {}
    for name, kw in grid + (("refine4", dict(R=8192, W=1024,
                                             schedule="grid", refine=4)),):
        key = (kw["R"], kw.get("unroll", 1))
        if key not in packs:
            packs[key] = FK.pack_flat_db(xb_dev, TD.METRIC_L2, R=kw["R"],
                                         unroll=key[1])
        kw = {"refine": 0, **kw}

        def call():
            return FK.flat_knn_fused(xq_dev, xb_dev, K, TD.METRIC_L2,
                                     packed=packs[key], merge="packed",
                                     sel="kernel", Q=512, **kw)
        Dv, Iv = call()
        ms = host_ms(call, TIMED_REPS)
        n_calls += 2 + TIMED_REPS
        Iv = Iv.cpu().numpy()
        if not (Iv.shape == (NQ, K) and (Iv >= 0).all()
                and torch.isfinite(Dv).all()):
            raise AssertionError(f"K1p {name}: malformed results")
        rows[name] = {"recall_at_10": T.recall_k_at_k(Iv, gt, K),
                      "ms": ms, "qps": NQ / ms * 1e3}
    packed_launches = counts()
    if packed_launches["flat_knn_packed"] != n_calls or \
            packed_launches["flat_knn_fused"]:
        raise AssertionError(f"the packed searches launched "
                             f"{packed_launches} for {n_calls} searches")
    floor = refine_rec - PACKED_MAX_LOSS
    phase("packed_search", searches=rows, refine_floor=floor,
          phase5_refine_recall=refine_rec, launches=packed_launches)
    if rows["refine4"]["recall_at_10"] < floor:
        raise AssertionError(f"K1p refine route recall@10 "
                             f"{rows['refine4']['recall_at_10']} < {floor}")

    # K1p against its plain version, 1024 and 10k queries (W 1024, R 8192)
    data, bias = index._fused_packed
    C = FK.packed_shift(xq_dev, xb_dev, False)
    shifted = (bias + C).contiguous()
    qv = torch.zeros((NQ, data.shape[-1]), device=dev)
    qv[:, :D] = -2.0 * xq_dev
    qv = qv.to(torch.bfloat16)
    W = 1024
    k1p_err = 0.0
    for nq in (1024, NQ):
        a1 = FK.flat_reservoir_packed(qv[:nq], data, shifted, W)
        a0 = FK.flat_reservoir_packed_reference(qv[:nq], data, shifted, W)
        assert_equal(f"K1p nq={nq}", a0, a1)
        v1, _ = FK.decode_packed(a1, W, C)
        v0, _ = FK.decode_packed(a0, W, C)
        k1p_err = max(k1p_err, max_abs_err(v0, v1))
        del a0, a1

    # -- 12. the B1 ladder on the same inputs ------------------------------
    reset_counts()
    ladder = {}
    for fold in FK.PROBE_FOLDS:
        ladder[fold] = {"ms": cuda_ms(lambda: FK.flat_probe_scan(
            qv, data, bias, W, fold), 3)}
    ladder["packed"] = {"ms": cuda_ms(lambda: FK.flat_reservoir_packed(
        qv, data, shifted, W), 3)}
    ladder_launches = counts()
    for fold in FK.PROBE_FOLDS:
        if ladder_launches["flat_probe_" + fold] != 4:
            raise AssertionError(f"B1 {fold}: {ladder_launches}")
    for fold in FK.PROBE_FOLDS:
        v1, p1 = FK.flat_probe_scan(qv, data, bias, W, fold)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v0, p0 = FK.flat_probe_scan_reference(qv, data, bias, W, fold)
        torch.cuda.synchronize()
        ladder[fold]["plain_ms"] = (time.perf_counter() - t1) * 1e3
        assert_equal(f"B1 {fold} values", v0, v1)
        assert_equal(f"B1 {fold} positions", p0, p1)
        ladder[fold]["max_abs_err"] = max_abs_err(v0, v1)
        del v0, p0, v1, p1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    FK.flat_reservoir_packed_reference(qv, data, shifted, W)
    torch.cuda.synchronize()
    ladder["packed"]["plain_ms"] = (time.perf_counter() - t1) * 1e3
    mma = {**sass_mma_counts("flat_knn_variants"),
           **sass_mma_counts("flat_knn_fused")}
    names = {"min1": "FoldMinILb0", "minall": "FoldMinILb1",
             "serial": "FoldSerial", "packed": "flat_knn_packed_kernel",
             "k1": "flat_knn_fused_kernel"}
    flat_mma = {k: [v for f, v in mma.items() if tag in f] for k, tag in
                names.items()}
    if any(len(v) != 1 for v in flat_mma.values()):
        raise AssertionError(f"a flat kernel is missing from the SASS: {mma}")
    flat_mma = {k: v[0] for k, v in flat_mma.items()}
    # K1, K1p and every B1 fold multiply with wgmma; the folds' products
    # are the same code
    if any(v["HGMMA"] == 0 for v in flat_mma.values()) or \
            len({str(flat_mma[f]) for f in FK.PROBE_FOLDS}) != 1:
        raise AssertionError(f"the flat kernels' wgmma counts: {flat_mma}")
    # K3, K3-SQ8 and K4 multiply on the tensor cores (mma.sync): each
    # library's three kernels (kp up to 32, the wide lists, kp above 64)
    ivf_hmma = {name: {f: n["HMMA"] for f, n in sass_mma_counts(name).items()
                       if "_kernel" in f} for name in IVF_SCANS}
    if any(len(v) != 3 or not min(v.values()) for v in ivf_hmma.values()):
        raise AssertionError(f"an IVF scan kernel has no HMMA: {ivf_hmma}")
    k1_ms = ladder["serial"]["ms"]
    phase("b1_ladder", nq=NQ, nb=index.ntotal, W=W, R=data.shape[1],
          folds=ladder, hmma={k: v["HMMA"] for k, v in flat_mma.items()},
          hgmma={k: v["HGMMA"] for k, v in flat_mma.items()},
          ivf_scan_hmma={k: sum(v.values()) for k, v in ivf_hmma.items()},
          products_share_of_serial=ladder["min1"]["ms"] / k1_ms,
          fold_share_of_serial=1.0 - ladder["min1"]["ms"] / k1_ms,
          launches=ladder_launches)
    work = bound(data.numel() * 2 + bias.numel() * 4 + qv.numel() * 2
                 + NQ * W * 8, 2.0 * NQ * index.ntotal * D)
    records = [{
        "name": "flat_knn_packed",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/flat_knn_variants.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:704",
        "launches": packed_launches["flat_knn_packed"],
        "max_abs_err": k1p_err,
        "ms": ladder["packed"]["ms"],
        "plain_ms": ladder["packed"]["plain_ms"],
        **work,
        "library_ms": None,
    }]
    for fold in FK.PROBE_FOLDS:
        records.append({
            "name": "flat_probe_scan_" + fold,
            "route": "cuda",
            "source": "tpu_ann_torch/csrc/flat_knn_variants.cu",
            "replaces": "benchs/r4/r4_queue4.py:157",
            "launches": ladder_launches["flat_probe_" + fold],
            "max_abs_err": ladder[fold]["max_abs_err"],
            "ms": ladder[fold]["ms"],
            "plain_ms": ladder[fold]["plain_ms"],
            **work,
            "library_ms": None,
        })
    del packs
    return records


def ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, mode, n_chunks) -> dict:
    """One nprobe of phase 9: a warm-up and TIMED_REPS timed searches, the
    launches checked against the mode's count."""
    idx.coarse_mode = mode
    p = T.SearchParametersIVF(nprobe=nprobe)
    hops = idx.quantizer.hnsw.fused_hops
    per = 1 if mode == "auto" else n_chunks * (1 + hops) + 1
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    now = counts()
    launches = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    if launches != {"ivf_scan_fused": per * (1 + TIMED_REPS)}:
        raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe}: launches "
                             f"{launches}, want {per} a search")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe}: malformed")
    med = float(np.median(times))
    return {"recall_at_10": T.recall_k_at_k(Iv, gt, K), "qps": NQ / med,
            "search_ms": [t * 1e3 for t in times],
            "launches_per_search": per}


def ivf_hnsw_wide(idx, xq_dev, xq, gt100, probes, n_chunks) -> dict:
    """Phase 9 at k 100 (kp 106): IVFHNSW15625 searched at nprobe 32 / 64
    in both coarse modes, a warm-up and TIMED_REPS timed searches each.
    A search is one launch of K3's global-list kernel (lists of 64 rows on
    average; ``pairs_over_kp`` counts the probed lists longer than kp, the
    ones whose list fills and merges), after the quantizer's hop launches
    in "quantizer" mode as at k 10; (D, I) equal to the plain route's
    (`scan_invlists_fused_reference`) bit for bit on the same probes
    (``probes[(nprobe, mode)]``, the coarse search's); recall@100 must not
    fall with nprobe. Then the kernel on each auto plan: per-pair (D, P)
    equal to its plain version, CUDA-event time beside the plain
    version's and the bound. Returns {"global": the path's global-list
    launches, "wide": its kp 33-64 launches, "kernel": {nprobe:
    record}}."""
    k = WIDE["k"]
    kp = F.default_kp(k)
    hops = idx.quantizer.hnsw.fused_hops
    il = idx.invlists
    res = {"auto": {}, "quantizer": {}}
    n_global = n_wide = 0
    for nprobe in (32, 64):
        p = T.SearchParametersIVF(nprobe=nprobe)
        for mode in res:
            idx.coarse_mode = mode
            per = 1 if mode == "auto" else n_chunks * (1 + hops) + 1
            before = counts()
            g0, w0 = F.LAUNCHES_GLOBAL, F.LAUNCHES_WIDE
            Dv, Iv = idx.search(xq, k, params=p)
            times = []
            for _ in range(TIMED_REPS):
                t1 = time.perf_counter()
                idx.search(xq, k, params=p)
                times.append(time.perf_counter() - t1)
            n = 1 + TIMED_REPS
            got = launched(before)
            if got != {"ivf_scan_fused": per * n} or \
                    F.LAUNCHES_GLOBAL - g0 != n:
                raise AssertionError(
                    f"IVFHNSW {mode} nprobe={nprobe} k {k}: launches {got}, "
                    f"{F.LAUNCHES_GLOBAL - g0} of the global-list kernel; "
                    f"want {per} a search, one of them global")
            n_global += n
            n_wide += F.LAUNCHES_WIDE - w0
            if not (Dv.shape == Iv.shape == (NQ, k) and np.isfinite(Dv).all()
                    and (Iv >= 0).all() and (Iv < NB).all()):
                raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe} k {k}: "
                                     f"malformed")
            D0, I0, _ = F.scan_invlists_fused_reference(
                xq_dev, probes[(nprobe, mode)], il, k)
            if not (np.array_equal(Dv, D0.cpu().numpy()) and np.array_equal(
                    Iv, idx._map_ids(I0.cpu().numpy()))):
                raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe} k {k}: "
                                     f"(D, I) differ from the plain route's")
            del D0, I0
            res[mode][nprobe] = {
                "recall_at_100": T.recall_k_at_k(Iv, gt100, k),
                "qps": NQ / float(np.median(times)),
                "search_ms": [t * 1e3 for t in times]}
    idx.coarse_mode = "auto"
    for mode, r in res.items():
        if r[32]["recall_at_100"] > r[64]["recall_at_100"]:
            raise AssertionError(f"IVFHNSW {mode}: recall@100 falls with "
                                 f"nprobe: {r}")
    q16, qn = F.fold_queries(xq_dev, il, False)
    kern = {}
    for nprobe in (32, 64):
        plan = F.plan_pairs(probes[(nprobe, "auto")], il)
        d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, False)
        d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, False)
        assert_equal(f"K3 kp {kp} IVFHNSW nprobe {nprobe} distances", d0, d1)
        assert_equal(f"K3 kp {kp} IVFHNSW nprobe {nprobe} positions", p0, p1)
        kern[nprobe] = {
            "kp": kp, "pairs": int(plan.pair_q.numel()),
            "rows_a_list": NB / idx.nlist,
            "pairs_over_kp": int((idx._list_sizes_device()[
                probes[(nprobe, "auto")]] > kp).sum()),
            "max_abs_err": max_abs_err(d0, d1),
            "ms": cuda_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp, False),
                          WIDE["reps"]),
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q16, qn, plan, il, kp, False), 1),
            **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks))}
        del d0, p0, d1, p1
    phase("ivf_hnsw_wide", k=k, kp=kp, nq=NQ, searches=res, kernel=kern,
          path_launches={"global": n_global, "wide": n_wide},
          equal_to_plain_route=True)
    return {"global": n_global, "wide": n_wide, "kernel": kern}


def ivf_hnsw_phase(xb, xt, xq, gt, gt100, dev):
    """Phase 9: the namesake IVFHNSW at the JAX package's bench config 3,
    at k 10 and (`ivf_hnsw_wide`) at k 100; returns the index (phase 14
    saves and reopens it), its auto recalls at nprobe 32 / 64 (phase 16's
    floors) and `ivf_hnsw_wide`'s record."""
    reset_counts()
    t0 = time.perf_counter()
    idx = T.IndexIVFHNSW(D, 15625, M=16, device="cuda")
    idx.set_hnsw_parameters(efConstruction=40)
    idx.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"IVFHNSW train/add launched {counts()}")
    t_graph = idx.quantizer.build_seconds["graph"]
    xq_dev = torch.from_numpy(xq).to(dev)
    n_chunks = -(-NQ // idx.quantizer.search_chunk)
    out, probes = {}, {}
    for nprobe in (32, 64):
        auto = ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, "auto", n_chunks)
        quant = ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, "quantizer",
                                n_chunks)
        idx.coarse_mode = "quantizer"
        _, probes[(nprobe, "quantizer")] = idx._coarse_search_device(
            xq_dev, nprobe)
        idx.coarse_mode = "auto"
        _, probes[(nprobe, "auto")] = idx._coarse_search_device(xq_dev,
                                                                nprobe)
        hp, ep = (probes[(nprobe, m)].cpu().numpy()
                  for m in ("quantizer", "auto"))
        fid = float(np.mean([len(set(a) & set(b)) / nprobe
                             for a, b in zip(hp, ep)]))
        out[nprobe] = {"auto": auto, "quantizer": quant, "fidelity": fid}
        phase("ivf_hnsw_search", nprobe=nprobe, floor=IVFHNSW_FLOORS[nprobe],
              auto=auto, quantizer=quant, quantizer_fidelity=fid)
    profiles = {}
    for mode in ("auto", "quantizer"):
        idx.coarse_mode = mode
        profiles[mode] = device_profile(lambda: idx.search(
            xq, K, params=T.SearchParametersIVF(nprobe=64)))
    idx.coarse_mode = "auto"
    phase("ivf_hnsw_profile", nprobe=64, **profiles)
    WIDE_PATH["k3"] = F.LAUNCHES_WIDE
    phase("ivf_hnsw", nlist=15625, M=16, train_s=t_train,
          kmeans_s=t_train - t_graph, graph_s=t_graph,
          tiles_s=idx.quantizer.build_seconds.get("tiles"), add_s=t_add,
          launches=counts(), wide_kernel_launches=WIDE_PATH["k3"])
    for nprobe, r in out.items():
        a, q = r["auto"]["recall_at_10"], r["quantizer"]["recall_at_10"]
        if a < IVFHNSW_FLOORS[nprobe] or r["fidelity"] < 0.99 or \
                abs(q - a) > 0.01:
            raise AssertionError(f"IVFHNSW nprobe={nprobe}: auto {a} (floor "
                                 f"{IVFHNSW_FLOORS[nprobe]}), quantizer {q}, "
                                 f"fidelity {r['fidelity']}")
    wide = ivf_hnsw_wide(idx, xq_dev, xq, gt100, probes, n_chunks)
    WIDE_PATH["k3"] += wide["wide"]
    return idx, {n: r["auto"]["recall_at_10"] for n, r in out.items()}, wide


def launch_bounds(call, kp: int) -> list:
    """The bound of each K3 launch of call(): the plans its scans build
    (recorded from plan_pairs, in launch order), each scan's bytes and
    products as pair_scan_work counts them."""
    plans, plan_pairs = [], F.plan_pairs

    def record(probes, invlists, pt=F.PT):
        plan = plan_pairs(probes, invlists, pt)
        plans.append((plan, invlists))
        return plan

    F.plan_pairs = record
    try:
        call()
    finally:
        F.plan_pairs = plan_pairs
    return [bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                  il.nblocks))["bound_ms"]
            for plan, il in plans]


def graph_phase(dev) -> None:
    """Phase 10: the round-4 harness's graph section on its own data."""
    rs = np.random.RandomState(11)
    cents = rs.rand(1024, D).astype(np.float32) * 10

    def draw(n):
        return cents[rs.randint(1024, size=n)] + \
            rs.randn(n, D).astype(np.float32)

    xb = draw(NB)
    xq = draw(NQ)
    xb_dev = torch.from_numpy(xb).to(dev)
    xq_dev = torch.from_numpy(xq).to(dev)
    _, gt = TD.knn(xq_dev, xb_dev, K)
    gt = gt.cpu().numpy()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph, assign = HN.build_graph_knn(xb_dev, 16, 40)
    torch.cuda.synchronize()
    builds = [time.perf_counter() - t0]
    if any(counts().values()):
        raise AssertionError(f"the graph build launched {counts()}")
    t0 = time.perf_counter()
    order = np.argsort(assign, kind="stable")
    ftg = HT.build_tiles_fused(xb, graph.neighbors0, order=order)
    t_tiles = time.perf_counter() - t0
    deg = (graph.neighbors0 >= 0).sum(1).float().mean().item()
    rows = {}
    for hops in (1, 2, 0):
        def call():
            return HT.tile_search_fused(ftg, xq_dev, K, nprobe0=12, hops=hops,
                                        F=4)
        before = counts()
        ms = host_ms(call, TIMED_REPS)
        launches = counts()["ivf_scan_fused"] - before["ivf_scan_fused"]
        if launches != (1 + TIMED_REPS) * (1 + hops):
            raise AssertionError(f"tile search hops={hops}: {launches} K3 "
                                 f"launches")
        _, _, I = call()
        I = I.cpu().numpy()
        if not (I.shape == (NQ, K) and (I >= 0).all() and (I < NB).all()):
            raise AssertionError(f"tile search hops={hops}: malformed")
        for _ in range(3):              # a trace may miss launches (device_ms)
            prof = device_profile(call, kernel="ivf_scan_fused_kernel")
            if len(prof["launches_ms"]) == 1 + hops:
                break
        if not prof["launches_ms"]:
            # three traces without a launch: the counts above stand, the
            # launch times are not measured (as device_ms records it)
            PROFILE_FALLBACKS.append(f"ivf_scan_fused_kernel hops={hops}")
            prof["launches_ms"] = None
        elif len(prof["launches_ms"]) != 1 + hops:
            raise AssertionError(f"tile search hops={hops}: profiled K3 "
                                 f"launches {prof['launches_ms']}")
        rows[hops] = {"recall_at_10": T.recall_k_at_k(I, gt, K), "ms": ms,
                      "qps": NQ / ms * 1e3, "k3_launches_per_search": 1 + hops,
                      "k3_launch_ms": prof.pop("launches_ms"),
                      # the tile search's per-(query, tile) width is kp 8
                      "k3_launch_bound_ms": launch_bounds(call, 8),
                      "profile": prof}
    phase("graph_build", n=NB, M=16, efConstruction=40, build_s=builds,
          tiles_s=t_tiles, mean_level0_degree=deg,
          max_level=graph.max_level)
    phase("tile_search", nprobe0=12, F=4, floor=GRAPH_FLOOR,
          hops={str(h): r for h, r in rows.items()})
    r0, r1, r2 = (rows[h]["recall_at_10"] for h in (0, 1, 2))
    if r1 < GRAPH_FLOOR or not r2 >= r1 > r0:
        raise AssertionError(f"tile search recall@10 hops 0/1/2: {r0} / "
                             f"{r1} / {r2} (floor {GRAPH_FLOOR})")
    del ftg, graph
    torch.cuda.empty_cache()

    # IndexHNSWFlat over the same base: build, then search
    reset_counts()
    t0 = time.perf_counter()
    idx = T.IndexHNSWFlat(D, 16, device="cuda")
    idx.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    hrows = {}
    for ef in (16, 64):
        p = T.SearchParametersHNSW(efSearch=ef)
        idx.search(xq, K, params=p)
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = idx.search(xq, K, params=p)
            times.append(time.perf_counter() - t1)
        if not (Iv.shape == (NQ, K) and (Iv >= 0).all()
                and np.isfinite(Dv).all()):
            raise AssertionError(f"IndexHNSWFlat ef={ef}: malformed")
        med = float(np.median(times))
        hrows[ef] = {"recall_at_10": T.recall_k_at_k(Iv, gt, K),
                     "qps": NQ / med, "search_ms": [t * 1e3 for t in times]}
    launches = counts()
    want = 2 * (1 + TIMED_REPS) * -(-NQ // idx.search_chunk) * \
        (1 + idx.hnsw.fused_hops)
    if launches["ivf_scan_fused"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"IndexHNSWFlat: launches {launches}, want "
                             f"{want} K3")
    phase("hnsw_flat", add_s=t_add, build_seconds=idx.build_seconds,
          searches={str(ef): r for ef, r in hrows.items()},
          launches=launches)
    if hrows[64]["recall_at_10"] < hrows[16]["recall_at_10"]:
        raise AssertionError("IndexHNSWFlat: efSearch 64 below 16")
    del idx, xb_dev
    torch.cuda.empty_cache()


B2_ROWS = (0, 1, 15, 4096, 16384, 65536)


def row_copy_phase(xb, dev) -> dict:
    """Phase 13: B2 on the 1M x 128 f32 base; returns its record."""
    xb_dev = torch.from_numpy(xb).to(dev)
    khz = B2.sm_clock_khz()
    rows_out, b2_err = {}, 0.0
    reset_counts()
    retries0, fallbacks0 = PROFILE_RETRIES, len(PROFILE_FALLBACKS)
    inputs = {}
    for nr in B2_ROWS:
        rows = torch.from_numpy(np.random.RandomState(0).randint(
            0, NB, size=nr).astype(np.int32)).to(dev)
        inputs[nr] = rows
        def probe():
            return B2.row_copy_probe(xb_dev, rows, 16, validate=False)
        # the kernel's device time under the profiler (a CUDA-event loop
        # times the wrapper's host work at these sizes), then the events
        ms = device_ms(probe, 5, kernel="row_copy_probe")
        events_ms = cuda_ms(probe, 5)
        out, xor, cyc = B2.row_copy_probe(xb_dev, rows, 16)
        copies = B2.cta_copies(nr, cyc.numel())
        per = [c / n for c, n in zip(cyc.tolist(), copies) if n]
        rows_out[nr] = {
            "ms": ms, "events_ms": events_ms, "ctas": cyc.numel(),
            "ns_per_copy": ms * 1e6 / nr if nr else None,
            "cycles_per_copy_max": max(per) if per else None,
            "cycles_per_copy_mean": float(np.mean(per)) if per else None,
            "index_select_ms": device_ms(
                lambda: xb_dev.index_select(0, rows.long()), 5),
            **bound(nr * D * 4 + nr * 4 + 16 * D * 4 + D * 4, 0.0)}
        rows_out[nr]["out"] = (out, xor)
    launches = counts()
    retried = PROFILE_RETRIES - retries0
    fell_back = len(PROFILE_FALLBACKS) - fallbacks0
    # the same count of rows, consecutive: what random rows cost the copies
    seq = torch.arange(B2_ROWS[-1], dtype=torch.int32, device=dev)
    rows_out[B2_ROWS[-1]]["consecutive_rows"] = {
        "ms": device_ms(lambda: B2.row_copy_probe(xb_dev, seq, 16,
                                                  validate=False), 5,
                        kernel="row_copy_probe"),
        "index_select_ms": device_ms(
            lambda: xb_dev.index_select(0, seq.long()), 5)}
    for nr, r in rows_out.items():
        out, xor = r.pop("out")
        ref, ref_xor = B2.row_copy_probe_reference(xb_dev, inputs[nr], 16)
        assert_equal(f"B2 slots nr={nr}", ref.view(torch.int32),
                     out.view(torch.int32))
        assert_equal(f"B2 xor nr={nr}", ref_xor, xor)
        b2_err = max(b2_err, max_abs_err(ref, out))
        r["plain_ms"] = host_ms(lambda: B2.row_copy_probe_reference(
            xb_dev, inputs[nr], 16), 3)
    # per NR: 5 warm-up and 5 profiled calls, 6 event-timed, 1 checked; a
    # trace device_ms took again repeated its 10 calls, and its CUDA-event
    # timing made 6
    if (launches["row_copy_probe"]
            != len(B2_ROWS) * 17 + 10 * retried + 6 * fell_back):
        raise AssertionError(f"B2 launches {launches}, {retried} traces "
                             f"taken again, {fell_back} event-timed")
    phase("row_copy_probe", ns=16, dp=D, nb=NB, sm_clock_khz=khz,
          slots_equal=True, xor_equal=True,
          calls={str(nr): r for nr, r in rows_out.items()},
          launches=launches, traces_taken_again=retried)
    last = rows_out[65536]
    del xb_dev
    return {
        "name": "row_copy_probe",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/row_copy_probe.cu",
        "replaces": "benchs/r5/r5_queue7.py:88",
        "launches": launches["row_copy_probe"],
        "max_abs_err": b2_err,
        "ms": last["ms"],
        "plain_ms": last["plain_ms"],
        "bound_ms": last["bound_ms"],
        "bound_by": last["bound_by"],
        "library_ms": last["index_select_ms"],
    }


# -- phase 14: the fork's workflow --------------------------------------------

# queries of each per-query run (each query a batch-1 round trip)
PER_QUERY_NQ = 1000
# 14e's rows: the first 250k, two shards of 125k (cut from 1M to pay for
# phase 23)
MERGE_NB = 250_000


def launched(before: dict = None) -> dict:
    """The launches since ``before`` (a counts() snapshot; None: since the
    last reset_counts()), kernels that launched only."""
    now = counts()
    before = before or {}
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


def file_assign(path: str) -> np.ndarray:
    """The int32 list assignments an il_from_host IVF file holds."""
    _, arrays = T.utils.index_io._read_container(path, mmap=True)
    return np.asarray(arrays["assign_host"], np.int64)


def same_lists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(nq,) bool: rows of a and b that probe the same lists."""
    return (np.sort(a, 1) == np.sort(b, 1)).all(1)


def per_query_check(idx, xq, dev, nprobe, mode, batch, sizes) -> dict:
    """Phase 14b for one setting: search_stats_per_query over the first
    PER_QUERY_NQ queries. One scan launch a query (and one for the
    warm-up), plus the quantizer's 1 + fused_hops tile launches in
    "quantizer" mode. ndis equals sizes (a list-size count independent of
    the index) summed over each query's batch-1 probes. A query's (D, I)
    equal its row of the batch search (assert_same_topk) where its batch-1
    probes are the batch's lists; a query whose batch-1 coarse search
    picks other lists (the f32 products of a batch-1 and a batch matmul
    round apart) must equal search_preassigned on its own probes, and in
    "auto" mode each list it swaps must lie within 1e-5 of the nprobe-th
    exact distance. Returns the setting's report (`per_query_report`:
    P50 / P99 / P99.9 of each phase)."""
    idx.coarse_mode = mode
    p = T.SearchParametersIVF(nprobe=nprobe)
    x = xq[:PER_QUERY_NQ]
    before = counts()
    Dq, Iq, st = idx.search_stats_per_query(x, K, params=p)
    got = launched(before)
    per = 1 if mode == "auto" else 2 + idx.quantizer.hnsw.fused_hops
    want = {"ivf_scan_fused": per * (len(x) + 1)}
    if got != want:
        raise AssertionError(f"per-query {mode} nprobe={nprobe}: launches "
                             f"{got}, want {want}")
    pq = st.per_query
    if not (pq.total_us.shape == (len(x),) and np.allclose(
            pq.total_us, pq.quantization_us + pq.list_scan_us)):
        raise AssertionError("per-query stats malformed")
    xq_dev = torch.from_numpy(xq).to(dev)
    pb = np.concatenate([idx._coarse_search_device(xq_dev[i:i + 1],
                                                   nprobe)[1].cpu().numpy()
                         for i in range(len(x))])
    pa = idx._coarse_search_device(xq_dev, nprobe)[1].cpu().numpy()[:len(x)]
    want_ndis = sizes[pb].sum(1)
    if not np.array_equal(pq.ndis, want_ndis):
        raise AssertionError(f"per-query {mode} nprobe={nprobe}: ndis "
                             f"differs in {int((pq.ndis != want_ndis).sum())}"
                             f" queries")
    Db, Ib = batch[0][:len(x)], batch[1][:len(x)]
    same = same_lists(pa, pb)
    assert_same_topk(Db[same], Ib[same], Dq[same], Iq[same])
    moved = np.nonzero(~same)[0]
    if len(moved):
        Dp, Ip = idx.search_preassigned(x[moved], K, pb[moved])
        assert_same_topk(Dp, Ip, Dq[moved], Iq[moved])
        if mode == "auto":
            cents = idx._centroid_table().cpu().numpy().astype(np.float64)
            for r in moved:
                dis = ((cents - x[r].astype(np.float64)) ** 2).sum(1)
                edge = np.sort(dis)[nprobe - 1]
                swapped = np.setxor1d(pa[r], pb[r])
                if not np.all(np.abs(dis[swapped] - edge) <= 1e-5 * edge):
                    raise AssertionError(f"query {r}: batch-1 probes differ "
                                         f"beyond a tie")
        elif len(moved) > 0.01 * len(x):
            raise AssertionError(f"per-query quantizer nprobe={nprobe}: "
                                 f"{len(moved)} queries probe other lists")
    rep = per_query_report(pq)
    return {"nprobe": nprobe, "mode": mode, "nq": len(x),
            "bit_equal_rows": int(((Dq == Db) & (Iq == Ib)).all(1).sum()),
            "other_probes": len(moved), "launches": want["ivf_scan_fused"],
            **{f: rep[f] for f in ("total_us", "quantization_us",
                                   "list_scan_us", "ndis")}}


def k3_batch1(idx, xq, dev, launches: int) -> dict:
    """Phase 14c: one K3 launch at batch 1 (the first query, its exact
    top-nprobe lists) at nprobe 32 and 64: per-pair output bit for bit and
    the final (D, I) against the plain version; device time under the
    profiler (a batch-1 launch is too short for an event loop), the plain
    version's and the whole batch-1 scan's (plan, K3, merge) host time,
    and the bound from the plan."""
    il = idx.invlists
    x1 = torch.from_numpy(xq[:1]).to(dev)
    qn, q16 = TD.l2_norms(x1), x1.to(torch.bfloat16)
    kp = F.default_kp(K)
    out = {}
    for nprobe in (32, 64):
        _, probes = TD.knn(x1, idx._centroid_table(), nprobe)
        plan = F.plan_pairs(probes, il)
        d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, False)
        d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, False)
        assert_equal(f"K3 batch 1 nprobe={nprobe} distances", d0, d1)
        assert_equal(f"K3 batch 1 nprobe={nprobe} positions", p0, p1)
        D1, I1, _ = F.scan_invlists_fused(x1, probes, il, K)
        D0, I0, _ = F.scan_invlists_fused_reference(x1, probes, il, K)
        assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                         D1.cpu().numpy(), I1.cpu().numpy())
        out[nprobe] = {
            "ms": device_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp,
                                                 False), 50,
                            kernel="ivf_scan_fused_kernel"),
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q16, qn, plan, il, kp, False), 5),
            "scan_ms": host_ms(lambda: F.scan_invlists_fused(
                x1, probes, il, K), 20),
            "max_abs_err": max_abs_err(d0, d1), "ntiles": plan.ntiles,
            **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks))}
    phase("workflow_k3_batch1", **{f"nprobe{n}": r for n, r in out.items()})
    r32, r64 = out[32], out[64]
    return {
        "name": "ivf_scan_fused_batch1",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:466",
        "launches": launches,
        "max_abs_err": max(r32["max_abs_err"], r64["max_abs_err"]),
        "ms": r32["ms"],
        "plain_ms": r32["plain_ms"],
        "bound_ms": r32["bound_ms"],
        "bound_by": r32["bound_by"],
        "library_ms": None,
        "ms_nprobe64": r64["ms"],
        "plain_ms_nprobe64": r64["plain_ms"],
        "bound_ms_nprobe64": r64["bound_ms"],
    }


def reopen_check(hidx, xq, gt, dev, tmp):
    """Phase 14a: save the namesake index, reopen it with load and with
    read_index(mmap=True), and hold both to the original (auto: bit for
    bit; quantizer: phase 9's floors). Returns the mmap reopen, the list
    sizes its file's assignments give, and its batch (D, I) by (mode,
    nprobe)."""
    path = os.path.join(tmp, "ivfhnsw15625.tann")
    t0 = time.perf_counter()
    hidx.save_to_disk(path)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = T.IndexIVFHNSW.load(path, device=dev)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapped = T.read_index(path, mmap=True, device=dev)
    read_mmap_s = time.perf_counter() - t0
    sizes = np.bincount(file_assign(path), minlength=hidx.nlist)
    repack_s = {}
    for name, idx in (("load", loaded), ("mmap", mapped)):
        if not (isinstance(idx, T.IndexIVFHNSW) and idx.invlists is None):
            raise AssertionError(f"{name}: not an il_from_host reopen")
        t0 = time.perf_counter()
        idx._ready()                      # the first search's repack
        torch.cuda.synchronize()
        repack_s[name] = time.perf_counter() - t0
    xq_dev = torch.from_numpy(xq).to(dev)
    before = counts()
    batch, rows = {}, {}
    for nprobe in (32, 64):
        p = T.SearchParametersIVF(nprobe=nprobe)
        hidx.coarse_mode = "auto"
        D0, I0 = hidx.search(xq, K, params=p)
        for name, idx in (("load", loaded), ("mmap", mapped)):
            idx.coarse_mode = "auto"
            D1, I1 = idx.search(xq, K, params=p)
            if not (np.array_equal(D0, D1) and np.array_equal(I0, I1)):
                raise AssertionError(f"{name} nprobe={nprobe}: the reopened "
                                     f"index's (D, I) differ")
            if name == "mmap":
                batch["auto", nprobe] = (D1, I1)
            idx.coarse_mode = "quantizer"
            Dq, Iq = idx.search(xq, K, params=p)
            _, hp = idx._coarse_search_device(xq_dev, nprobe)
            idx.coarse_mode = "auto"
            _, ep = idx._coarse_search_device(xq_dev, nprobe)
            hp, ep = hp.cpu().numpy(), ep.cpu().numpy()
            fid = float(np.mean([len(set(a) & set(b)) / nprobe
                                 for a, b in zip(hp, ep)]))
            ra, rq = T.recall_k_at_k(I1, gt, K), T.recall_k_at_k(Iq, gt, K)
            if ra < IVFHNSW_FLOORS[nprobe] or fid < 0.99 or \
                    abs(rq - ra) > 0.01:
                raise AssertionError(f"{name} nprobe={nprobe}: auto {ra}, "
                                     f"quantizer {rq}, fidelity {fid}")
            rows[f"{name}_{nprobe}"] = {"auto_recall": ra,
                                        "quantizer_recall": rq,
                                        "fidelity": fid}
            if name == "mmap":
                batch["quantizer", nprobe] = (Dq, Iq)
    phase("workflow_reopen", file_bytes=nbytes, write_s=write_s,
          read_s=read_s, read_mmap_s=read_mmap_s, repack_s=repack_s,
          auto_bit_equal=True, quantizer=rows, launches=launched(before))
    del loaded
    os.remove(path)
    return mapped, sizes, batch


def ivf_file_check(name, idx, xq, path, dev, nprobe=32):
    """Write idx, reopen it with mmap, and hold the reopened index's (D, I)
    at nprobe to idx's bit for bit; returns the reopened index and the
    seconds of the write, the read and the first search."""
    p = T.SearchParametersIVF(nprobe=nprobe)
    D0, I0 = idx.search(xq, K, params=p)
    t0 = time.perf_counter()
    T.write_index(idx, path)
    t_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = T.read_index(path, mmap=True, device=dev)
    t_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    D1, I1 = back.search(xq, K, params=p)
    t_s = time.perf_counter() - t0
    if not (np.array_equal(D0, D1) and np.array_equal(I0, I1)):
        raise AssertionError(f"{name}: the reopened index's (D, I) differ in "
                             f"{int((D0 != D1).sum())} / "
                             f"{int((I0 != I1).sum())} entries")
    return back, {"file_bytes": os.path.getsize(path), "write_s": t_w,
                  "read_s": t_r, "first_search_s": t_s}


def workflow_phase(hidx, quant3, paged, xb, xt, xq, gt, dev, tmp) -> dict:
    """Phase 14: the fork's workflow on the earlier phases' indexes, every
    file under tmp; returns the batch-1 K3 record of the kernels line."""
    t_phase = time.perf_counter()
    # -- 14a. the namesake index, saved and reopened -------------------------
    reset_counts()
    mapped, sizes, batch = reopen_check(hidx, xq, gt, dev, tmp)

    # -- 14b. per-query latency over K3 at batch 1 ---------------------------
    reset_counts()
    runs = [per_query_check(mapped, xq, dev, nprobe, mode,
                            batch[mode, nprobe], sizes)
            for mode, nprobe in (("auto", 32), ("auto", 64),
                                 ("quantizer", 64))]
    per_query_launches = sum(r["launches"] for r in runs)
    mapped.coarse_mode = "auto"
    for r in runs:
        phase("workflow_per_query", **r)

    # -- 14c. K3 at batch 1 against its plain version ------------------------
    k3_b1 = k3_batch1(mapped, xq, dev, per_query_launches)
    del mapped
    torch.cuda.empty_cache()

    # -- 14d. the out-of-core index through an index file --------------------
    reset_counts()
    path = os.path.join(tmp, "paged.tann")
    _, st_d = ivf_file_check("paged", paged, xq, path, dev)
    got = launched()
    if set(got) != {"ivf_scan_paged"}:
        raise AssertionError(f"the paged reopen launched {got}")
    phase("workflow_paged", **st_d, launches=got)
    os.remove(path)

    # -- 14e. two shards of the first MERGE_NB rows merged on disk ----------
    reset_counts()
    xm = xb[:MERGE_NB]
    half = len(xm) // 2
    paths, t0 = [], time.perf_counter()
    for j, (lo, hi) in enumerate(((0, half), (half, len(xm)))):
        shard = T.IndexIVFFlat(quant3, D, NLIST, device=dev)
        shard.is_trained = True
        shard.add_with_ids(xm[lo:hi], np.arange(lo, hi, dtype=np.int64))
        paths.append(os.path.join(tmp, f"shard{j}.tann"))
        T.write_index(shard, paths[-1])
        del shard
    t_shards = time.perf_counter() - t0
    empty = T.IndexIVFFlat(quant3, D, NLIST, device=dev)
    empty.is_trained = True
    dst = os.path.join(tmp, "merged.tann")
    t0 = time.perf_counter()
    n = T.merge_ondisk(empty, [T.FileInvlistSource(p) for p in paths], dst)
    t_merge = time.perf_counter() - t0
    for p in paths:
        os.remove(p)
    merged = T.read_index(dst, mmap=True, device=dev)
    single = T.IndexIVFFlat(quant3, D, NLIST, device=dev)
    single.is_trained = True
    single.add(xm)
    p32 = T.SearchParametersIVF(nprobe=32)
    D0, I0 = single.search(xq, K, params=p32)
    D1, I1 = merged.search(xq, K, params=p32)
    if n != len(xm) or not (np.array_equal(D0, D1) and
                            np.array_equal(I0, I1)):
        raise AssertionError("the merged file's (D, I) differ from a single "
                             "index over the same rows")
    got = launched()
    if got != {"ivf_scan_fused": 2}:
        raise AssertionError(f"the merge check launched {got}")
    phase("workflow_merge", ntotal=n, shards_s=t_shards, merge_s=t_merge,
          file_bytes=os.path.getsize(dst), bit_equal=True, launches=got)
    del merged, single
    os.remove(dst)

    # -- 14f. IVF-SQ8 through an index file, per query through K3-SQ8 ----------
    reset_counts()
    sq = T.IndexIVFScalarQuantizer(quant3, D, NLIST, T.QT_8BIT, device=dev)
    sq.quantizer_trains_alone = 1
    sq.train(xt)
    sq.add(xb)
    path = os.path.join(tmp, "ivfsq8.tann")
    back, st_f = ivf_file_check("ivf_sq8", sq, xq, path, dev)
    p32 = T.SearchParametersIVF(nprobe=32)
    Db, Ib = back.search(xq[:100], K, params=p32)
    Dq, Iq, _ = back.search_stats_per_query(xq[:100], K, params=p32)
    # the dequantized rows are not integers: a batch-1 re-rank product
    # rounds apart from the batch's
    err = assert_close_pairs("IVF-SQ8 per query", *(torch.from_numpy(a) for a
                                                    in (Db, Ib, Dq, Iq)))
    got = launched()
    if got != {"ivf_scan_sq8": 3 + 101}:
        raise AssertionError(f"the IVF-SQ8 reopen launched {got}")
    phase("workflow_ivf_sq8", **st_f, per_query_max_abs_err=err,
          launches=got)
    del sq, back
    os.remove(path)

    # -- 14g. the opted-in IndexFlat through an index file (K1, K2) ---------
    reset_counts()
    flat = T.IndexFlat(D, device=dev)
    flat.add(xb)
    path = os.path.join(tmp, "flat.tann")
    T.write_index(flat, path)
    back = T.read_index(path, mmap=True, device=dev)
    for idx in (flat, back):
        idx.compute_dtype, idx.approx_topk = "bfloat16", True
    D0, I0 = flat.search(xq, K)
    D1, I1 = back.search(xq, K)
    if not (np.array_equal(D0, D1) and np.array_equal(I0, I1)):
        raise AssertionError("the reopened IndexFlat's (D, I) differ")
    got = launched()
    if got != {"flat_knn_fused": 2, "reservoir_topk": 2}:
        raise AssertionError(f"the flat reopen launched {got}")
    phase("workflow_flat", file_bytes=os.path.getsize(path), bit_equal=True,
          launches=got)
    del flat, back
    os.remove(path)
    torch.cuda.empty_cache()
    phase("workflow", seconds=time.perf_counter() - t_phase)
    return k3_b1


# -- phase 15: the IVF API ----------------------------------------------------

# queries of the range searches
RANGE_NQ = 1000


def timed(fn, reps: int = 1, warm=None):
    """(fn()'s last result, median wall seconds of ``reps`` calls, each
    ending in a device sync) after one warm-up call of ``warm`` (default
    fn)."""
    (warm or fn)()
    torch.cuda.synchronize()
    ts, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def ivf_over(quant, rows, ids, xt, qtype=None, dev="cuda"):
    """An IVF-Flat (``qtype`` None) or IVF-SQ index over phase 3's quantizer
    (quantizer_trains_alone=1: no k-means) holding ``rows`` under ``ids``;
    over all rows it equals phase 3's index list for list."""
    if qtype is None:
        idx = T.IndexIVFFlat(quant, D, NLIST, device=dev)
    else:
        idx = T.IndexIVFScalarQuantizer(quant, D, NLIST, qtype, device=dev)
    idx.quantizer_trains_alone = 1
    idx.train(xt)
    idx.add_with_ids(rows, np.asarray(ids, np.int64))
    return idx


def expect_launches(name, before, want) -> dict:
    got = launched(before)
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return got


def hits_by_id(lims, Dv, Iv):
    """A range result as (query, id, distance) rows sorted by query, then
    id: the same hits in any order compare equal."""
    q = np.repeat(np.arange(len(lims) - 1), np.diff(lims))
    order = np.lexsort((Iv, q))
    return q[order], np.asarray(Iv)[order], np.asarray(Dv)[order]


def in_probed_lists(probes, assign_dev, dev):
    """(nq, rows) bool: row r lies in one of the query's probed lists."""
    member = torch.zeros((len(probes), NLIST), dtype=torch.bool, device=dev)
    member.scatter_(1, torch.from_numpy(probes).to(dev), True)
    return member[:, assign_dev]


def brute_range(xb_dev, xr, radius, dev, probes=None, assign_dev=None):
    """The hits of an exact f32 filter of every row (or, with ``probes``,
    of the rows of each query's probed lists) within ``radius`` (L2 <)."""
    qs, ids, ds = [], [], []
    for q0 in range(0, len(xr), 100):
        qd = torch.from_numpy(xr[q0:q0 + 100]).to(dev)
        dis = TD.pairwise_distances(qd, xb_dev)
        hit = dis < radius
        if probes is not None:
            hit &= in_probed_lists(probes[q0:q0 + 100], assign_dev, dev)
        qi, ri = torch.nonzero(hit, as_tuple=True)
        qs.append((qi + q0).cpu().numpy())
        ids.append(ri.cpu().numpy())
        ds.append(dis[qi, ri].cpu().numpy())
        del dis, hit
    q, i, d = np.concatenate(qs), np.concatenate(ids), np.concatenate(ds)
    order = np.lexsort((i, q))
    return q[order], i[order], d[order]


def brute_knn_probed(xdec, xr, probes, assign_dev, dev):
    """Exact f32 top-K of each query over the rows ``xdec`` (device) of its
    probed lists only: what the query-major scan must return."""
    Ds, Is = [], []
    for q0 in range(0, len(xr), 100):
        qd = torch.from_numpy(xr[q0:q0 + 100]).to(dev)
        dis = TD.pairwise_distances(qd, xdec)
        dis = torch.where(in_probed_lists(probes[q0:q0 + 100], assign_dev,
                                          dev), dis, float("inf"))
        d, i = torch.topk(dis, K, dim=1, largest=False)
        Ds.append(d)
        Is.append(i)
        del dis
    return torch.cat(Ds), torch.cat(Is)


def same_hits(name, a, b) -> None:
    for x, y, what in zip(a, b, ("queries", "ids", "distances")):
        if not np.array_equal(x, y):
            raise AssertionError(f"{name}: range hits differ ({what}; "
                                 f"{len(a[0])} vs {len(b[0])} hits)")


def ivf_api_phase(quant3, xb, xt, xq, gt, flat_rec, dev) -> None:
    """Phase 15: selectors, max_codes, range_search, the DirectMap
    mutations, merge_from and the query-major IVF-SQ qtypes, on an
    IVF4096,Flat over phase 3's quantizer and data (= phase 3's index)."""
    t_phase = time.perf_counter()
    reset_counts()
    ids_all = np.arange(NB, dtype=np.int64)
    t0 = time.perf_counter()
    A = ivf_over(quant3, xb, ids_all, xt, dev=dev)
    t_build = time.perf_counter() - t0
    p32 = T.SearchParametersIVF(nprobe=32)
    warm = lambda: A.search(xq[:256], K, params=p32)     # noqa: E731
    before = counts()
    (Dk, Ik), t_k3 = timed(lambda: A.search(xq, K, params=p32), TIMED_REPS)
    expect_launches("K3 search", before, {"ivf_scan_fused": 1 + TIMED_REPS})
    k3_rec = T.recall_k_at_k(Ik, gt, K)

    # -- 15a. selectors: the query-major scan with an id mask --------------
    sel_all = T.SearchParametersIVF(nprobe=32, sel=T.IDSelectorAll())
    before = counts()
    (Da, Ia), t_all = timed(lambda: A.search(xq, K, params=sel_all),
                            warm=lambda: A.search(xq[:256], K,
                                                  params=sel_all))
    expect_launches("IDSelectorAll", before, {})
    assert_same_topk(Dk, Ik, Da, Ia)
    phase("ivf_api_selector", selector="all", selected=NB, nprobe=32,
          qps=NQ / t_all, k3_qps=NQ / t_k3, recall_at_10=k3_rec,
          d_bit_equal_to_k3=True)
    rs = np.random.RandomState(15)
    batch = np.sort(rs.choice(NB, NB // 10, replace=False))
    sparse = np.sort(rs.choice(NB, NB // 100, replace=False))
    bitmap = np.zeros(NB // 8 + 1, np.uint8)
    np.bitwise_or.at(bitmap, sparse >> 3,
                     (1 << (sparse & 7)).astype(np.uint8))
    for name, sel, rows in (
            ("range", T.IDSelectorRange(0, NB // 2), np.arange(NB // 2)),
            ("batch", T.IDSelectorBatch(batch), batch),
            ("bitmap", T.IDSelectorBitmap(bitmap), sparse)):
        p = T.SearchParametersIVF(nprobe=32, sel=sel)
        before = counts()
        (Ds, Is), t_sel = timed(lambda: A.search(xq, K, params=p),
                                warm=lambda: A.search(xq[:256], K, params=p))
        expect_launches(f"selector {name}", before, {})
        got = Is[Is >= 0]
        if not sel.member_array(got).all():
            raise AssertionError(f"selector {name}: an id it excludes")
        sub = ivf_over(quant3, xb[rows], rows, xt, dev=dev)
        before = counts()
        (Dr, Ir), t_sub = timed(lambda: sub.search(xq, K, params=p32))
        expect_launches(f"K3 over the {name} rows", before,
                        {"ivf_scan_fused": 2})
        assert_same_topk(Dr, Ir, Ds, Is)
        phase("ivf_api_selector", selector=name, selected=len(rows),
              nprobe=32, qps=NQ / t_sel, k3_qps=NQ / t_k3,
              k3_selected_index_qps=NQ / t_sub, filled=float((Is >= 0)
                                                             .mean()),
              d_bit_equal_to_k3_over_selected=True)
        del sub

    # -- 15b. max_codes: at most ceil(max_codes / B) blocks a list ----------
    lsizes = A._list_sizes_host()
    probes32 = A.coarse_assign(xq, 32)
    for mc in (256, 1024):
        p = T.SearchParametersIVF(nprobe=32, max_codes=mc)
        before = counts()
        (Dc, Ic), t_c = timed(lambda: A.search(xq, K, params=p),
                              warm=lambda: A.search(xq[:256], K, params=p))
        _, _, st = A.search_stats(xq, K, params=p)
        cap = -(-mc // A.block_size) * A.block_size
        # a cap below the default one takes the query-major scan; one that
        # truncates no list is no cap, and K3 serves it (the reference's
        # rule)
        capped = cap // A.block_size < A._default_capped_mnb()
        expect_launches(f"max_codes {mc}", before,
                        {} if capped else {"ivf_scan_fused": 3})
        want = int(np.minimum(lsizes[probes32], cap).sum())
        if st.ndis != want:
            raise AssertionError(f"max_codes {mc}: ndis {st.ndis}, the cap "
                                 f"allows {want}")
        phase("ivf_api_max_codes", max_codes=mc, nprobe=32,
              blocks_a_list=cap // A.block_size, query_major=capped,
              longest_list_blocks=A.invlists.max_nblocks_per_list,
              ndis=st.ndis,
              uncapped_ndis=int(lsizes[probes32].sum()),
              recall_at_10=T.recall_k_at_k(Ic, gt, K),
              uncapped_recall_at_10=k3_rec, qps=NQ / t_c, k3_qps=NQ / t_k3)

    # -- 15c. range_search: IVF, IndexFlat, IndexScalarQuantizer ------------
    xr = xq[:RANGE_NQ]
    flat = T.IndexFlat(D, device=dev)
    flat.add(xb)
    Dex, _ = flat.search(xr, K)
    radius = float(np.median(Dex[:, K - 1]))
    A.nprobe = 32
    before = counts()
    res_ivf, t_ivf = timed(lambda: A.range_search(xr, radius),
                           warm=lambda: A.range_search(xr[:50], radius))
    assign_dev = torch.from_numpy(np.concatenate(A._assign_host)).to(dev)
    same_hits("IVF range_search",
              hits_by_id(*res_ivf),
              brute_range(flat.vectors, xr, radius, dev,
                          A.coarse_assign(xr, 32), assign_dev))
    res_flat, t_flat = timed(lambda: flat.range_search(xr, radius),
                             warm=lambda: flat.range_search(xr[:50], radius))
    same_hits("IndexFlat range_search", hits_by_id(*res_flat),
              brute_range(flat.vectors, xr, radius, dev))
    sqf = T.IndexScalarQuantizer(D, T.QT_8BIT_DIRECT, device=dev)
    sqf.add(xb)
    res_sq, t_sq = timed(lambda: sqf.range_search(xr, radius),
                         warm=lambda: sqf.range_search(xr[:50], radius))
    for a, b in zip(res_sq, res_flat):
        if not np.array_equal(a, b):
            raise AssertionError("IndexScalarQuantizer(QT_8BIT_DIRECT) "
                                 "range hits differ from IndexFlat's")
    expect_launches("range_search", before, {})
    phase("ivf_api_range", nq=RANGE_NQ, radius=radius, nprobe=32,
          ivf_s=t_ivf, ivf_hits=int(res_ivf[0][-1]), flat_s=t_flat,
          flat_hits=int(res_flat[0][-1]), sq8_direct_s=t_sq,
          equal_to_brute_force=True, sq8_direct_equal_to_flat=True)
    del flat, sqf, assign_dev
    torch.cuda.empty_cache()

    # -- 15d. merge_from of two halves == the whole index (K3) -------------
    h = NB // 2
    t0 = time.perf_counter()
    a1 = ivf_over(quant3, xb[:h], ids_all[:h], xt, dev=dev)
    a2 = ivf_over(quant3, xb[h:], ids_all[h:], xt, dev=dev)
    t_halves = time.perf_counter() - t0
    t0 = time.perf_counter()
    a1.merge_from(a2)
    t_merge = time.perf_counter() - t0
    before = counts()
    Dm, Im = a1.search(xq, K, params=p32)
    expect_launches("merged search", before, {"ivf_scan_fused": 1})
    if not (np.array_equal(Dm, Dk) and np.array_equal(Im, Ik)
            and torch.equal(a1.invlists.ids, A.invlists.ids)):
        raise AssertionError("merge_from of two halves differs from the "
                             "whole index")
    phase("ivf_api_merge", halves_s=t_halves, merge_s=t_merge,
          bit_equal=True, other_ntotal=a2.ntotal)
    del a1, a2

    # -- 15d. IVF-SQ8 after remove_ids through K3-SQ8 -----------------------
    sq8 = ivf_over(quant3, xb, ids_all, xt, T.QT_8BIT, dev)
    t0 = time.perf_counter()
    sq8.remove_ids(T.IDSelectorBatch(batch))
    t_rm_sq = time.perf_counter() - t0
    keep = np.setdiff1d(ids_all, batch)
    sq8_rest = ivf_over(quant3, xb[keep], keep, xt, T.QT_8BIT, dev)
    before = counts()
    Ds8, Is8 = sq8.search(xq, K, params=p32)
    Dr8, Ir8 = sq8_rest.search(xq, K, params=p32)
    expect_launches("IVF-SQ8 after remove_ids", before,
                    {"ivf_scan_sq8": 2})
    if np.isin(Is8, batch).any():
        raise AssertionError("K3-SQ8 returned a removed id")
    assert_same_topk(Dr8, Ir8, Ds8, Is8)
    phase("ivf_api_sq8_remove", removed=len(batch), remove_s=t_rm_sq,
          no_removed_id=True, d_bit_equal_to_rebuilt=True,
          recall_at_10=T.recall_k_at_k(Is8, gt, K))
    del sq8, sq8_rest
    torch.cuda.empty_cache()

    # -- 15e. IVF-SQ qtypes through the query-major scan -------------------
    A.scan_mode = "query"
    qm, probes_of = {}, {}
    for nprobe in (16, 32, 64):
        probes_of[nprobe] = A.coarse_assign(xq[:RANGE_NQ], nprobe)
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = counts()
        qm[nprobe], t_q = timed(lambda: A.search(xq, K, params=p),
                                warm=lambda: A.search(xq[:256], K, params=p))
        expect_launches("IVF-Flat query-major", before, {})
        phase("ivf_api_query_major", nprobe=nprobe, qps=NQ / t_q,
              recall_at_10=T.recall_k_at_k(qm[nprobe][1], gt, K),
              k3_recall_at_10=flat_rec[nprobe])
    A.scan_mode = "auto"
    for name, qtype in (("QT_FP16", T.QT_FP16), ("QT_BF16", T.QT_BF16),
                        ("QT_4BIT", T.QT_4BIT), ("QT_6BIT", T.QT_6BIT)):
        t0 = time.perf_counter()
        idx = ivf_over(quant3, xb, ids_all, xt, qtype, dev)
        t_add = time.perf_counter() - t0
        lossless = qtype in (T.QT_FP16, T.QT_BF16)
        codec_rec = None if lossless else codec_recall(idx.sq, xb, xq, gt,
                                                       dev)
        if not lossless:
            dec = SQ.sq_decode(SQ.sq_encode(torch.from_numpy(xb).to(dev),
                                            idx.sq), idx.sq)
            assign_dev = torch.from_numpy(
                np.concatenate(idx._assign_host)).to(dev)
        for nprobe in (16, 32, 64):
            p = T.SearchParametersIVF(nprobe=nprobe)
            before = counts()
            (Dq, Iq), t_q = timed(lambda: idx.search(xq, K, params=p),
                                  warm=lambda: idx.search(xq[:256], K,
                                                          params=p))
            expect_launches(f"IVF-SQ {name}", before, {})
            rec = T.recall_k_at_k(Iq, gt, K)
            floor = err = None
            if lossless:
                assert_same_topk(*qm[nprobe], Dq, Iq)
            else:
                # the scan is exact over the decoded rows of the probed
                # lists; its recall is the codec's and the probes' losses
                # compounded (both lose: a floor of min(codec, IVF) - 0.01
                # fails at nprobe 16 with recall equal to the exact answer)
                Dp, Ip = brute_knn_probed(dec, xq[:RANGE_NQ],
                                          probes_of[nprobe][:RANGE_NQ],
                                          assign_dev, dev)
                err = assert_close_pairs(
                    f"IVF-SQ {name} nprobe={nprobe}", Dp, Ip,
                    torch.from_numpy(Dq[:RANGE_NQ]),
                    torch.from_numpy(Iq[:RANGE_NQ]))
                floor = codec_rec * flat_rec[nprobe] - 0.01
                if rec < floor:
                    raise AssertionError(f"IVF-SQ {name} nprobe={nprobe}: "
                                         f"recall@10 {rec} < {floor}")
            phase("ivf_api_sq_query", qtype=name, nprobe=nprobe,
                  recall_at_10=rec, floor=floor, codec_recall_at_10=codec_rec,
                  max_abs_err_vs_exact_over_probed_lists=err,
                  ivf_flat_recall_at_10=flat_rec[nprobe], qps=NQ / t_q,
                  d_bit_equal_to_ivf_flat_query_major=lossless or None,
                  build_s=t_add, **device_stream_bytes(idx))
        del idx
        if not lossless:
            del dec, assign_dev
        torch.cuda.empty_cache()

    # -- 15d. mutation of the index itself, through K3 ----------------------
    def check_rest(step, gone_ids):
        """K3 over A returns no removed id, and D bit-equal (ids up to
        ties) to K3 over an index of the remaining rows."""
        keep = np.setdiff1d(ids_all, gone_ids)
        before = counts()
        t0 = time.perf_counter()
        D1, I1 = A.search(xq, K, params=p32)
        t_search = time.perf_counter() - t0
        rest = ivf_over(quant3, xb[keep], keep, xt, dev=dev)
        D0, I0 = rest.search(xq, K, params=p32)
        expect_launches(step, before, {"ivf_scan_fused": 2})
        if np.isin(I1, gone_ids).any():
            raise AssertionError(f"{step}: K3 returned a removed id")
        assert_same_topk(D0, I0, D1, I1)
        if A.ntotal != len(keep):
            raise AssertionError(f"{step}: ntotal {A.ntotal}")
        return t_search

    gone = batch
    t0 = time.perf_counter()
    n1 = A.remove_ids(T.IDSelectorBatch(batch))
    t_rm_batch = time.perf_counter() - t0
    if A._dirty:
        raise AssertionError("a removal below the hole threshold marked "
                             "the index for a repack")
    check_rest("remove_ids by IDSelectorBatch", gone)
    t0 = time.perf_counter()
    n2 = A.remove_ids(T.IDSelectorRange(NB - NB // 10, NB))
    t_rm_range = time.perf_counter() - t0
    gone = np.union1d(gone, np.arange(NB - NB // 10, NB))
    holes = A._holes
    if A._dirty:
        raise AssertionError("a removal below the hole threshold marked "
                             "the index for a repack")
    check_rest("remove_ids by IDSelectorRange", gone)
    n3 = A.remove_ids(T.IDSelectorRange(0, NB // 10))
    gone = np.union1d(gone, np.arange(NB // 10))
    if not A._dirty:
        raise AssertionError("the hole threshold did not mark the index")
    t_compact_search = check_rest("removal past the hole threshold", gone)
    phase("ivf_api_remove", removed=[n1, n2, n3],
          remove_batch_s=t_rm_batch, remove_range_s=t_rm_range,
          holes_before_threshold=holes, threshold_crossed=True,
          search_with_compaction_s=t_compact_search, ntotal=A.ntotal)
    live = np.setdiff1d(ids_all, gone)
    upd = np.sort(rs.choice(live, NB // 100, replace=False))
    pool = np.setdiff1d(live, upd)
    assign = A._row_list[A._rows_of_ids(pool)]
    cur = A.list_of_ids(upd)
    # each updated id takes the vector of a row in another list, one whose
    # block padding has room for it (a move into a full list repacks)
    room = A.invlists.list_nblocks.cpu().numpy().astype(np.int64) \
        * A.block_size - A._list_fill
    src = []
    for c in rs.permutation(len(pool)):
        lst = assign[c]
        if room[lst] > 0 and lst != cur[len(src)]:
            room[lst] -= 1
            src.append(c)
            if len(src) == len(upd):
                break
    src = np.asarray(src)
    holes = A._holes
    t0 = time.perf_counter()
    A.update_vectors(upd, xb[pool[src]])
    t_update = time.perf_counter() - t0
    if A._holes != holes + len(upd):
        raise AssertionError("update_vectors repacked instead of moving "
                             "the rows in place")
    moved = A.list_of_ids(upd)
    if not np.array_equal(moved, assign[src]):
        raise AssertionError("update_vectors left rows in their lists")
    before = counts()
    Du, Iu = A.search(xb[pool[src]], K, params=T.SearchParametersIVF(
        nprobe=1))
    expect_launches("search after update_vectors", before,
                    {"ivf_scan_fused": 1})
    pos = Iu == upd[:, None]
    if not (pos.any(1).all() and (Du[pos] == 0).all()):
        raise AssertionError("an updated id is not found at distance 0")
    t0 = time.perf_counter()
    A._repack()
    t_repack = time.perf_counter() - t0
    phase("ivf_api_update", updated=len(upd), update_s=t_update,
          in_place=True, moved_all=True, found_at_0=True,
          full_repack_s=t_repack, build_s=t_build)
    got = launched()
    if not got.get("ivf_scan_fused") or not got.get("ivf_scan_sq8"):
        raise AssertionError(f"phase 15 did not run K3 and K3-SQ8: {got}")
    phase("ivf_api", seconds=time.perf_counter() - t_phase, launches=got)
    del A
    torch.cuda.empty_cache()


# -- phase 16: PQ and refine ---------------------------------------------

# queries of the exact checks over decoded rows (E) and of the per-query run
PQ_NQ_E = 1000
PQ_NQ_PER_QUERY = 100


def list_of_rows(lists) -> torch.Tensor:
    """(stream rows,) the list of each stream position of packed lists (-1
    for the dummy block and padding past the last list)."""
    total, B = lists.ids.shape
    runs = torch.repeat_interleave(
        torch.arange(lists.nlist, device=lists.ids.device),
        lists.list_nblocks.long())
    b2l = torch.full((total,), -1, dtype=torch.long, device=lists.ids.device)
    b2l[:len(runs)] = runs
    return b2l.repeat_interleave(B)


def exact_over_lists(lists, xr, probes, dev):
    """E: the exact top-K of each query over the rows of its probed lists of
    a raw layout (a decoded cache), ||q||^2 + norm - 2 <q, x> with the
    layout's own rows and norms (what K3's re-rank computes), evaluated in
    float64: (D, I, S) tensors, I the stored ids, S = ||q||^2 + norm, the
    size of the terms the distance is the difference of (an f32
    evaluation is good to a few ulps of S, not of D)."""
    rows = lists.data.view(-1, D).double()
    norms = lists.norms.view(-1).double()
    ids = lists.ids.view(-1).long()
    r2l = list_of_rows(lists)
    Ds, Is, Ss = [], [], []
    for q0 in range(0, len(xr), 100):
        qd = torch.from_numpy(xr[q0:q0 + 100]).to(dev).double()
        qn = (qd * qd).sum(1)
        dis = torch.clamp(qn[:, None] + norms[None] - 2.0 * (qd @ rows.T),
                          min=0.0)
        member = torch.zeros((len(qd), lists.nlist + 1), dtype=torch.bool,
                             device=dev)
        pq = probes[q0:q0 + 100].long()
        member.scatter_(1, torch.where(pq >= 0, pq, lists.nlist), True)
        ok = member[:, r2l] & (ids >= 0)[None]
        dis = torch.where(ok, dis, float("inf"))
        d, pos = torch.topk(dis, K, dim=1, largest=False)
        Ds.append(d)
        Is.append(ids[pos])
        Ss.append(qn[:, None] + norms[pos])
        del dis, ok
    del rows
    return torch.cat(Ds), torch.cat(Is), torch.cat(Ss)


def rows_by_id(lists, n: int, dev) -> torch.Tensor:
    """(n, d) the rows of a raw layout in stored-id order."""
    ids = lists.ids.view(-1).long()
    ok = ids >= 0
    d = lists.data.shape[-1]
    out = torch.zeros((n, d), device=dev)
    out[ids[ok]] = lists.data.view(-1, d)[ok].float()
    return out


def codec_recall_rows(rows, xq, gt, dev, k=K) -> float:
    """C: recall@k of an exact f32 search over decoded rows."""
    _, I = TD.knn(torch.from_numpy(xq).to(dev), rows, k)
    return T.recall_k_at_k(I.cpu().numpy(), gt, k)


def overlap_close(name, E, Dv, Iv, rtol) -> float:
    """(a)'s check against E: ids overlapping >= 0.99, the distances of the
    ids in common within rtol, or within 8 f32 ulps of E's S where that is
    more: an f32 distance is the difference of terms of size S, and two
    summation orders round apart by a few of their ulps (1.5 at S ~1e6
    against rtol 1e-5 of a distance of 8200, seen on the H100). Returns
    the overlap."""
    De, Ie, Se = (t.cpu().numpy() for t in E)
    ov = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(Ie, Iv)]))
    if ov < 0.99:
        raise AssertionError(f"{name}: id overlap with E {ov} < 0.99")
    for q in range(len(Ie)):
        m = {i: (dd, sc) for i, dd, sc in zip(Ie[q].tolist(), De[q].tolist(),
                                               Se[q].tolist())}
        for i, dd in zip(Iv[q].tolist(), Dv[q].tolist()):
            if i not in m:
                continue
            tol = max(rtol * max(abs(m[i][0]), 1.0),
                      8 * float(np.spacing(np.float32(m[i][1]))))
            if abs(dd - m[i][0]) > tol:
                raise AssertionError(f"{name}: query {q} id {i}: {dd} vs "
                                     f"E's {m[i][0]} (S {m[i][1]})")
    return ov


def pq_searches(idx, xq, gt, name, want, nprobes=(16, 32, 64), E=None,
                rtol=1e-5, floors=None):
    """Searches of one PQ route at each nprobe: a warm-up, TIMED_REPS timed
    searches and search_stats, each launching exactly ``want`` (a launches
    dict per search); recall@10 >= floors[nprobe]; the first PQ_NQ_E rows
    against E (a function of nprobe giving their exact (D, I)): at rtol
    1e-5 as overlap_close says, at a wider rtol as assert_close_pairs says
    (the same ids up to near-ties). Returns {nprobe: {recall, qps, ...}}."""
    out = {}
    for nprobe in nprobes:
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = counts()
        Dv, Iv = idx.search(xq, K, params=p)
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = idx.search(xq, K, params=p)
            times.append(time.perf_counter() - t1)
        Ds, Is, st = idx.search_stats(xq, K, params=p)
        expect_launches(f"{name} nprobe={nprobe}", before,
                        {k: v * (2 + TIMED_REPS) for k, v in want.items()})
        if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
            raise AssertionError(f"{name}: search and search_stats differ")
        if not (Dv.shape == Iv.shape == (len(xq), K) and
                np.isfinite(Dv).all() and (Iv >= 0).all()):
            raise AssertionError(f"{name} nprobe={nprobe}: malformed")
        rec = T.recall_k_at_k(Iv, gt, K)
        r = {"recall_at_10": rec, "qps": len(xq) / float(np.median(times)),
             "search_ms": [t * 1e3 for t in times],
             "list_scan_ms": st.list_scan_us / 1e3}
        if floors is not None:
            r["floor"] = floors[nprobe]
            if rec < floors[nprobe]:
                raise AssertionError(f"{name} nprobe={nprobe}: recall@10 "
                                     f"{rec} < {floors[nprobe]}")
        if E is not None and rtol <= 1e-5:
            r["overlap_e"] = overlap_close(f"{name} nprobe={nprobe}",
                                           E(nprobe), Dv[:PQ_NQ_E],
                                           Iv[:PQ_NQ_E], rtol)
        elif E is not None:
            r["max_abs_err_e"] = assert_close_pairs(
                f"{name} nprobe={nprobe} vs E", *E(nprobe)[:2],
                *(torch.from_numpy(a[:PQ_NQ_E]) for a in (Dv, Iv)), rtol=rtol)
        out[nprobe] = r
    return out


def probes_of(idx, xq, nprobe, dev):
    """The first PQ_NQ_E queries' probes, from the whole batch's coarse
    search (the very product a search of the batch computes)."""
    _, probes = idx._coarse_search_device(torch.from_numpy(xq).to(dev),
                                          nprobe)
    return probes[:PQ_NQ_E]


def ivf_pq_over(quant, M, nbits, xt, rows, ids, dev, codec=None,
                cls=None, **kw):
    """An IndexIVFPQ (or ``cls``) over ``quant`` (quantizer_trains_alone=1:
    no k-means), trained on xt (or given ``codec``, the (base, refine)
    codebooks), holding ``rows`` under ``ids``; seconds of train and add."""
    cls = cls or T.IndexIVFPQ
    idx = cls(quant, D, quant.ntotal, M, nbits, **kw, device=dev)
    idx.quantizer_trains_alone = 1
    t0 = time.perf_counter()
    if codec is None:
        idx.train(xt)
    else:
        idx.is_trained = True
        idx._set_codec(codec[0])
        if len(codec) > 1:
            idx._set_refine_codec(codec[1])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add_with_ids(rows, np.asarray(ids, np.int64))
    torch.cuda.synchronize()
    return idx, t_train, time.perf_counter() - t0


def cache_bytes(lists) -> int:
    """Device bytes of a decoded cache's own tensors (the id plane and list
    ranges are the code lists'), each tensor once (a bf16 cache's ``data``
    is its ``data_bf16``)."""
    names = ("data", "data_bf16", "codes", "norms", "sq_bias", "sq_scale")
    held = {getattr(lists, n).data_ptr(): getattr(lists, n).nbytes
            for n in names if getattr(lists, n, None) is not None}
    return sum(held.values())


def same_search(name, a, b) -> None:
    """(D, I) bit for bit, ids up to ties."""
    assert_same_topk(a[0], a[1], b[0], b[1])


def pq_phase(quant3, hquant, hnsw_auto, xb, xt, xq, gt, flat_rec, dev,
             tmp) -> dict:
    """Phase 16: IVFPQ through its decoded cache (K3, K3-SQ8) and the table
    scan, 4-bit PQ, IVFPQR, the refine indexes, IndexPQ, the namesake
    IVF15625_HNSW16,PQ32, files and mutations. Returns the K3 / K3-SQ8
    launches of the phase and K3's record at kp 46 (16e)."""
    t_phase = time.perf_counter()
    reset_counts()
    ids = np.arange(NB, dtype=np.int64)
    k3, sq8 = {"ivf_scan_fused": 1}, {"ivf_scan_sq8": 1}

    # -- 16a. IVF4096,PQ32: the bf16 decoded cache through K3 ----------------
    A, t_train, t_add = ivf_pq_over(quant3, 32, 8, xt, xb, ids, dev)
    t0 = time.perf_counter()
    cache = A._decoded_cache()
    torch.cuda.synchronize()
    t_cache = time.perf_counter() - t0
    f32 = A._decode_lists(torch.float32)
    C = codec_recall_rows(rows_by_id(f32, NB, dev), xq, gt, dev)
    del f32
    floors = {n: C * flat_rec[n] - 0.01 for n in (16, 32, 64)}
    probes = {n: probes_of(A, xq, n, dev) for n in (16, 32, 64)}
    res_a = pq_searches(
        A, xq, gt, "IVFPQ bf16 cache", k3, floors=floors,
        E=lambda n: exact_over_lists(cache, xq[:PQ_NQ_E], probes[n], dev))
    rule = (A.invlists.nblocks + 1) * A.block_size * D * 2
    phase("pq_ivf_bf16", train_s=t_train, add_s=t_add, cache_build_s=t_cache,
          codec_recall=C, cache_bytes=cache_bytes(cache),
          rule_bytes=rule, code_bytes=A.invlists.codes.nbytes,
          searches=res_a)
    save_pq32(A, tmp)                                   # for phase 21

    # -- 16b. the same codes, decoded_cache_dtype "sq8": K3-SQ8 ---------------
    A.decoded_cache_dtype = "sq8"
    A._decoded = None
    t0 = time.perf_counter()
    c8 = A._decoded_cache()
    torch.cuda.synchronize()
    t_c8 = time.perf_counter() - t0
    if not isinstance(c8, T.PackedInvListsSQ8) or hasattr(c8, "data") or \
            c8.codes.dtype != torch.uint8:
        raise AssertionError("the sq8 cache is not a uint8 stream alone")
    res_b = pq_searches(A, xq, gt, "IVFPQ sq8 cache", sq8)
    for n, r in res_b.items():
        if abs(r["recall_at_10"] - res_a[n]["recall_at_10"]) > 0.01:
            raise AssertionError(f"sq8 cache nprobe={n}: recall "
                                 f"{r['recall_at_10']} vs bf16's "
                                 f"{res_a[n]['recall_at_10']}")
    phase("pq_ivf_sq8", cache_build_s=t_c8, cache_bytes=cache_bytes(c8),
          searches=res_b)
    del c8

    # -- 16c. use_decoded_cache=False: the 8-bit table scan, no kernel --------
    A.decoded_cache_dtype = "float32"
    A._decoded = None
    f32 = A._decoded_cache()
    E32 = {n: exact_over_lists(f32, xq[:PQ_NQ_E], probes[n], dev)
           for n in (16, 32, 64)}
    A.use_decoded_cache = False
    A._decoded = None
    del f32
    res_c = pq_searches(A, xq, gt, "IVFPQ table scan", {}, E=E32.get,
                        rtol=1e-4)
    phase("pq_ivf_table_scan", searches=res_c,
          qps_bf16_cache={n: res_a[n]["qps"] for n in res_a})
    A.use_decoded_cache = None
    A.decoded_cache_dtype = "bfloat16"
    A._decoded = None
    del E32

    # -- 16d. IVF4096,PQ64x4: 4-bit codes, the table scan over packed codes ---
    B4, t4_train, t4_add = ivf_pq_over(quant3, 64, 4, xt, xb, ids, dev)
    f32 = B4._decode_lists(torch.float32)
    C4 = codec_recall_rows(rows_by_id(f32, NB, dev), xq, gt, dev)
    E4 = {n: exact_over_lists(f32, xq[:PQ_NQ_E], probes[n], dev)
          for n in (16, 32, 64)}
    del f32
    res_d = pq_searches(B4, xq, gt, "IVFPQ 4-bit", {}, E=E4.get, rtol=1e-4,
                        floors={n: C4 * flat_rec[n] - 0.01
                                for n in (16, 32, 64)})
    phase("pq_ivf_4bit", train_s=t4_train, add_s=t4_add, codec_recall=C4,
          code_bytes=B4.invlists.codes.nbytes, searches=res_d)
    del B4, E4
    torch.cuda.empty_cache()

    # -- 16e. IVF4096,PQ32+16: IVFPQR, one K3 launch a search + the re-rank ---
    R, tr_train, tr_add = ivf_pq_over(quant3, 32, 8, xt, xb, ids, dev,
                                      cls=T.IndexIVFPQR, M_refine=16,
                                      nbits_refine=8)
    res_e = pq_searches(R, xq, gt, "IVFPQR", k3,
                        floors={n: res_a[n]["recall_at_10"]
                                for n in (16, 32, 64)})
    p32 = T.SearchParametersIVF(nprobe=32)
    xs = xq[:PQ_NQ_PER_QUERY]
    Ds, Is = R.search(xs, K, params=p32)
    Dp, Ip = R.search_preassigned(xs, K, R.coarse_assign(xs, 32))
    same_search("IVFPQR search_preassigned", (Ds, Is), (Dp, Ip))
    Dq, Iq, _ = R.search_stats_per_query(xs, K, params=p32)
    errq = assert_close_pairs("IVFPQR per query", *(torch.from_numpy(a) for a
                                                   in (Ds, Is, Dq, Iq)))
    # K3 at the width IVFPQR asks for: k * k_factor = 40 wants
    # default_kp(40) = 46 rows a (query, list), above 32, so the search's
    # one launch is K3's wide-list kernel (two entries a lane), and at
    # nprobe 1, k 100 (kp 106, above KP_MAX 64, where a 32-row cap would
    # drop hits) one launch of its kernel whose lists live in global
    # memory.
    # Held against the plain version on the same inputs, per pair and for
    # the whole scan before the re-rank, at the search's shapes (10k q,
    # nprobe 32, k 40) and at nprobe 1, k 100, and faster than it: bit for
    # bit on R's cache
    # rounded to integers (exact bf16 products, phase 4's standard), and
    # within rtol 1e-5, positions up to near-ties, on the cache itself
    # (float rows: the kernel's products sum in another order). These
    # comparison launches are left out of the phase's count.
    c_cmp = counts()
    dl = R._decoded_cache()
    ri = torch.round(dl.data.float())
    dl_int = T.PackedInvLists(
        data=ri.to(torch.bfloat16), data_bf16=ri.to(torch.bfloat16),
        ids=dl.ids, norms=(ri * ri).sum(-1),
        list_block_start=dl.list_block_start, list_nblocks=dl.list_nblocks)
    del ri
    wide = {}
    for nq_w, np_w, k_w in ((NQ, 32, R.k_factor * K), (PQ_NQ_E, 1, 100)):
        xw = torch.from_numpy(xq[:nq_w]).to(dev)
        _, pw = R._coarse_search_device(xw, np_w)
        kp_w = F.default_kp(k_w)
        rec = {"queries": nq_w, "kp": kp_w, "pairs": int(pw.numel())}
        for name, lists in (("int", dl_int), ("cache", dl)):
            q16, qn = F.fold_queries(xw, lists, False)
            plan = F.plan_pairs(pw, lists)
            d1, p1 = F.scan_pairs(q16, qn, plan, lists, kp_w, False)
            d0, p0 = F.scan_pairs_reference(q16, qn, plan, lists, kp_w,
                                            False)
            D1, I1, _ = F.scan_invlists_fused(xw, pw, lists, k_w)
            D0, I0, _ = F.scan_invlists_fused_reference(xw, pw, lists, k_w)
            what = f"K3 at kp {kp_w}, nprobe {np_w}, {name} rows"
            if name == "int":
                if not (torch.equal(d0, d1) and torch.equal(p0, p1)):
                    raise AssertionError(f"{what}: per-pair top-kp differs "
                                         f"from the plain version")
                if not (torch.equal(D0, D1) and torch.equal(I0, I1)):
                    raise AssertionError(f"{what}: the scan differs from "
                                         f"the plain version")
                continue
            rec["max_abs_err"] = assert_close_pairs(f"{what} per pair", d0,
                                                    p0, d1, p1)
            rec["scan_max_abs_err"] = assert_close_pairs(f"{what} scan", D0,
                                                         I0, D1, I1)
            rec["hits"] = int((I1 >= 0).sum())
            rec["ms"] = cuda_ms(lambda: F.scan_pairs(q16, qn, plan, lists,
                                                     kp_w, False), 5)
            rec["ms_kp32"] = cuda_ms(lambda: F.scan_pairs(
                q16, qn, plan, lists, 32, False), 5)
            rec["plain_ms"] = host_ms(lambda: F.scan_pairs_reference(
                q16, qn, plan, lists, kp_w, False), 1)
            rec.update(bound(*pair_scan_work(plan, lists.ids,
                                             lists.block_size, D, kp_w, 0,
                                             lists.nblocks)))
            if rec["ms"] >= rec["plain_ms"]:
                raise AssertionError(f"{what}: K3 takes {rec['ms']} ms, its "
                                     f"plain version {rec['plain_ms']}")
        wide[f"nprobe{np_w}_k{k_w}"] = rec
        del d0, p0, d1, p1, plan
    del dl_int
    cmp_launches = launched(c_cmp)
    phase("pq_ivf_pqr", train_s=tr_train, add_s=tr_add, searches=res_e,
          preassigned_equal=True, per_query_max_abs_err=errq,
          k3_wide_kp=wide)

    # -- 16f. IVF4096,PQ32,RFlat and ,RSQ8t, built as users build them ------
    # RFlat: the constructor over a fresh IVFPQ with (a)'s codebook, then
    # add (base and refine rows); RSQ8t: the factory string, train and add.
    # Each is held bit for bit against a wrapper put together by hand from
    # the same parts (RFlat over (a) itself and an IndexFlat of the base;
    # RSQ8t over its own base index with codes encoded in one call).
    xb_flat = T.IndexFlat(D, device=dev)
    xb_flat.add(xb)
    RF0 = T.IndexRefineFlat(A, xb_flat)
    RF0.ntotal = NB
    base_f = T.IndexIVFPQ(quant3, D, NLIST, 32, 8, device=dev)
    base_f.quantizer_trains_alone = 1
    base_f.is_trained = True
    base_f._set_codec(A.pq.centroids)
    RF = T.IndexRefineFlat(base_f)
    t0 = time.perf_counter()
    RF.add(xb)
    torch.cuda.synchronize()
    t_rf_add = time.perf_counter() - t0
    RT = T.index_factory(D, f"IVF{NLIST},PQ32,RSQ8t", device=dev)
    t0 = time.perf_counter()
    RT.train(xt)
    torch.cuda.synchronize()
    t_rt_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    RT.add(xb)
    torch.cuda.synchronize()
    t_rt_add = time.perf_counter() - t0
    RT0 = T.IndexRefineSQ8Tier(RT.base_index)
    RT0.codec = RT.codec
    RT0._codes = SQ.sq_encode(torch.from_numpy(xb).to(dev), RT.codec)
    RT0.is_trained, RT0.ntotal = True, NB
    if not torch.equal(RT0._codes, RT._codes):
        raise AssertionError("RSQ8t's add encoded other codes")
    res_f = {}
    for name, idx in (("RFlat", RF), ("RSQ8t", RT)):
        res_f[name] = pq_searches(idx, xq, gt, name, k3,
                                  floors={n: res_a[n]["recall_at_10"]
                                          for n in (16, 32, 64)})
    for name, a, b in (("RFlat", RF, RF0), ("RSQ8t", RT, RT0)):
        same_search(f"{name} built by add vs by hand",
                    a.search(xq, K, params=p32), b.search(xq, K, params=p32))
    xq_dev = torch.from_numpy(xq).to(dev)
    Dv, Iv = RF.search(xq, K, params=p32)
    recomp = ((xb_flat.vectors[torch.from_numpy(Iv).to(dev)]
               - xq_dev[:, None]) ** 2).sum(-1).cpu().numpy()
    if not np.allclose(Dv, recomp, rtol=1e-6, atol=0):
        raise AssertionError("RFlat's D differ from an f32 recomputation")
    _, t_base = timed(lambda: base_f.search(xq, 4 * K, params=p32), 3)
    _, t_rf = timed(lambda: RF.search(xq, K, params=p32), 3)
    phase("pq_refine", searches=res_f, rflat_d_exact=True,
          rflat_add_s=t_rf_add, rsq8t_train_s=t_rt_train,
          rsq8t_add_s=t_rt_add, equal_to_hand_built=True,
          rerank_share={"RFlat": 1.0 - t_base / t_rf})
    del RF0, RT0

    # -- 16g. IndexPQ(128, 32, 8) over the 1M base: no kernel ----------------
    before = counts()
    P = T.IndexPQ(D, 32, 8, device=dev)
    P.train(xt)
    P.add(xb)
    (Dp, Ip), t_pq = timed(lambda: P.search(xq, K), 1)
    rec_pq = T.recall_k_at_k(Ip, gt, K)
    rec_adc = codec_recall_rows(P._decode(P._codes), xq, gt, dev)
    if abs(rec_pq - rec_adc) > 0.005:
        raise AssertionError(f"IndexPQ ST_PQ recall {rec_pq} vs exact ADC "
                             f"{rec_adc}")
    P.search_type = P.ST_SDC
    (Dd, Id), t_sdc = timed(lambda: P.search(xq[:PQ_NQ_E], K), 1)
    expect_launches("IndexPQ", before, {})
    phase("pq_flat", recall_pq=rec_pq, recall_exact_adc=rec_adc,
          qps_pq=NQ / t_pq, recall_sdc=T.recall_k_at_k(Id, gt[:PQ_NQ_E], K),
          qps_sdc=PQ_NQ_E / t_sdc, cache_bytes=P._dec.nbytes)
    del P

    # -- 16h. IVF15625_HNSW16,PQ32 over phase 9's graph quantizer -------------
    H, th_train, th_add = ivf_pq_over(hquant, 32, 8, xt, xb, ids, dev)
    Ch = codec_recall_rows(rows_by_id(H._decode_lists(torch.float32), NB,
                                      dev), xq, gt, dev)
    n_chunks = -(-NQ // hquant.search_chunk)
    hops = hquant.hnsw.fused_hops
    res_h = {}
    for mode in ("auto", "quantizer"):
        H.coarse_mode = mode
        want = {"ivf_scan_fused": 1 if mode == "auto"
                else n_chunks * (1 + hops) + 1}
        res_h[mode] = pq_searches(
            H, xq, gt, f"IVFHNSW PQ32 {mode}", want, nprobes=(32, 64),
            floors={n: Ch * hnsw_auto[n] - 0.01 for n in (32, 64)}
            if mode == "auto" else None)
    H.coarse_mode = "auto"
    for n in (32, 64):
        a, q = (res_h[m][n]["recall_at_10"] for m in ("auto", "quantizer"))
        if abs(a - q) > 0.01:
            raise AssertionError(f"IVFHNSW PQ32 nprobe={n}: quantizer {q} "
                                 f"vs auto {a}")
    phase("pq_ivf_hnsw", nlist=hquant.ntotal, train_s=th_train,
          add_s=th_add, codec_recall=Ch, searches=res_h)
    del H

    # -- 16i. through files: (a), (e), (f); two shards merged on disk --------
    files = {}
    for name, idx in (("IVFPQ", A), ("IVFPQR", R), ("RFlat", RF)):
        path = os.path.join(tmp, f"{name}.tann")
        want = idx.search(xq, K, params=p32)
        T.write_index(idx, path)
        back = T.read_index(path, mmap=True, device=dev)
        t0 = time.perf_counter()
        base = getattr(back, "base_index", back)
        base._ready()
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t0
        same_search(f"{name} through a file", want,
                    back.search(xq, K, params=p32))
        files[name] = {"file_bytes": os.path.getsize(path),
                       "cache_rebuild_s": t_rebuild}
        del back
        os.remove(path)
    half = NB // 2
    paths = []
    for j, (lo, hi) in enumerate(((0, half), (half, NB))):
        shard, _, _ = ivf_pq_over(quant3, 32, 8, xt, xb[lo:hi], ids[lo:hi],
                                  dev, codec=(A.pq.centroids,))
        paths.append(os.path.join(tmp, f"pq_shard{j}.tann"))
        T.write_index(shard, paths[-1])
        del shard
    empty = T.IndexIVFPQ(quant3, D, NLIST, 32, 8, device=dev)
    empty.is_trained = True
    empty._set_codec(A.pq.centroids)
    dst = os.path.join(tmp, "pq_merged.tann")
    t0 = time.perf_counter()
    n = T.merge_ondisk(empty, [T.FileInvlistSource(p) for p in paths], dst)
    t_merge = time.perf_counter() - t0
    merged = T.read_index(dst, mmap=True, device=dev)
    if n != NB:
        raise AssertionError(f"merge_ondisk wrote {n} rows")
    same_search("the merged IVFPQ file", A.search(xq, K, params=p32),
                merged.search(xq, K, params=p32))
    phase("pq_files", files=files, merge_s=t_merge,
          merged_bytes=os.path.getsize(dst))
    del merged
    for p in paths + [dst]:
        os.remove(p)

    # -- 16j. remove_ids on (a) through K3 and (b) through K3-SQ8 -------------
    gone = np.random.RandomState(16).choice(NB, NB // 10, replace=False)
    keep = np.setdiff1d(ids, gone)
    rest, _, _ = ivf_pq_over(quant3, 32, 8, xt, xb[keep], keep, dev,
                             codec=(A.pq.centroids,))
    t0 = time.perf_counter()
    A.remove_ids(T.IDSelectorBatch(gone))
    t_remove = time.perf_counter() - t0
    for dtype, want in (("bfloat16", k3), ("sq8", sq8)):
        for idx in (A, rest):
            idx.decoded_cache_dtype = dtype
            idx._decoded = None
        before = counts()
        D1, I1 = A.search(xq, K, params=p32)
        expect_launches(f"IVFPQ {dtype} after remove_ids", before, want)
        if np.isin(I1, gone).any():
            raise AssertionError(f"{dtype}: a removed id came back")
        same_search(f"IVFPQ {dtype} after remove_ids",
                    rest.search(xq, K, params=p32), (D1, I1))
    phase("pq_remove", removed=len(gone), remove_s=t_remove,
          bit_equal=True)
    del A, R, RF, RT, rest, xb_flat, base_f
    torch.cuda.empty_cache()
    got = {k: v - cmp_launches.get(k, 0) for k, v in launched().items()
           if v != cmp_launches.get(k, 0)}
    phase("pq", seconds=time.perf_counter() - t_phase, launches=got)
    return got, wide["nprobe32_k40"]


# -- phase 17: the rest of HNSW -------------------------------------------

# queries of the beam checks (17e) and the range search (17h), and added
# rows searched back as queries (17g)
HNSW_NQ_SMALL = 1000
# 17e's float-set indexes: the first 250k rows of phase 5's float set (cut
# from 1M to pay for phase 23)
BEAM_NB = 250_000
HNSW_EFS = (16, 64)


def on_graph(idx, src, xb):
    """``idx`` (an empty IndexHNSW) holding xb with ``src``'s graph and
    coarse order, set by hand (no build)."""
    idx.storage.add(xb)
    idx.ntotal = idx._built_n = len(xb)
    idx.graph, idx._coarse_assign = src.graph, src._coarse_assign
    return idx


def hnsw_searches(idx, xq, gt, name, want_per_chunk, efs=HNSW_EFS, k=K):
    """At each efSearch a warm-up and TIMED_REPS timed searches of all
    queries at ``k``, each launching ``want_per_chunk`` (a launches dict)
    per 8192-query chunk; returns {ef: {recall_at_<k>, qps, D, I}}."""
    out = {}
    n_chunks = -(-len(xq) // idx.search_chunk)
    for ef in efs:
        p = T.SearchParametersHNSW(efSearch=ef)
        before = counts()
        Dv, Iv = idx.search(xq, k, params=p)
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = idx.search(xq, k, params=p)
            times.append(time.perf_counter() - t1)
        expect_launches(f"{name} ef={ef}", before,
                        {n: v * n_chunks * (1 + TIMED_REPS)
                         for n, v in want_per_chunk.items()})
        if not (Dv.shape == Iv.shape == (len(xq), k) and
                np.isfinite(Dv).all() and (Iv >= 0).all()):
            raise AssertionError(f"{name} ef={ef}: malformed")
        out[ef] = {f"recall_at_{k}": T.recall_k_at_k(Iv, gt, k),
                   "qps": len(xq) / float(np.median(times)), "D": Dv,
                   "I": Iv}
    return out


def public(res) -> dict:
    return {str(ef): {k: v for k, v in r.items() if k not in ("D", "I")}
            for ef, r in res.items()}


def codec_floor(name, res, C, flat, k=K) -> None:
    """recall@k >= C x F - 0.01 at each efSearch."""
    key = f"recall_at_{k}"
    for ef, r in res.items():
        floor = C * flat[ef][key] - 0.01
        r["floor"] = floor
        if r[key] < floor:
            raise AssertionError(f"{name} ef={ef}: recall@{k} {r[key]} < "
                                 f"{floor}")


def uncounted(fn, acc: dict):
    """fn()'s result; the launches it made are added to ``acc`` (launches
    that compare a kernel with its plain version, or a route with another,
    are left out of a phase's count)."""
    before = counts()
    out = fn()
    for k, v in launched(before).items():
        acc[k] = acc.get(k, 0) + v
    return out


# 17a at k 100: the efSearch values (hop-0 tile budgets of 64 and 128)
HNSW_EFS_K100 = (128, 256)


def hnsw_sq8_k100(A, FL, rows8, xq, xq_dev, gt100, dev, cmp) -> dict:
    """Phase 17a at k 100: HNSW16,SQ8 (``A``, K3-SQ8) and IndexHNSWFlat
    ``FL`` on its graph (K3) at efSearch 128 and 256. The kp rule gives kp
    64 on every scan: each 8192-query chunk makes 1 + fused_hops launches,
    all of the wide-list kernels (kp 33-64). recall@100 against the exact
    f32 ground truth >= C x FL's - 0.01, C the codec's own recall@100.
    K3-SQ8 at kp 64 on the hop-0 plan of one chunk at efSearch 128 (64
    tiles a query) against its plain version (within rtol 1e-5), its time
    beside the plain version's and the bound. Returns {"k3": FL's launches,
    "sq8": A's, "hop0": the K3-SQ8 record}."""
    k = gt100.shape[1]
    hops = A.hnsw.fused_hops
    w0 = F.LAUNCHES_WIDE
    res_f = hnsw_searches(FL, xq, gt100, "IndexHNSWFlat FL k100",
                          {"ivf_scan_fused": 1 + hops}, HNSW_EFS_K100, k)
    n_fl = F.LAUNCHES_WIDE - w0
    res_a = hnsw_searches(A, xq, gt100, "HNSW16,SQ8 k100",
                          {"ivf_scan_sq8": 1 + hops}, HNSW_EFS_K100, k)
    n_sq8 = F.LAUNCHES_WIDE - w0 - n_fl
    want = (len(HNSW_EFS_K100) * -(-len(xq) // A.search_chunk) * (1 + hops)
            * (1 + TIMED_REPS))
    if (n_fl, n_sq8) != (want, want):
        raise AssertionError(f"17a at k {k}: wide-list launches FL {n_fl}, "
                             f"SQ8 {n_sq8}, want {want} each")
    C = codec_recall_rows(rows8, xq, gt100, dev, k)
    codec_floor(f"HNSW16,SQ8 k {k}", res_a, C, res_f, k)
    ftg = A._tiles_fused
    il = ftg.il
    kp = max(A.hnsw.fused_kp, min(ftg.b, k, A.hnsw.fused_kp_max))
    x8 = xq_dev[:A.search_chunk]
    nprobe0 = max(8, HNSW_EFS_K100[0] // 2)
    _, seeds = TD.knn(x8, ftg.cent, min(nprobe0, il.nlist),
                      compute_dtype="bfloat16", approx=il.nlist > 4096)
    plan = F.plan_pairs(seeds.to(torch.int32), il)
    q8, qn8 = F.fold_queries(x8, il, False)

    def scan():
        return F.scan_pairs(q8, qn8, plan, il, kp, False)

    d1, p1 = uncounted(scan, cmp)
    d0, p0 = F.scan_pairs_reference(q8, qn8, plan, il, kp, False)
    hop0 = {"kp": kp, "nq": len(x8), "tiles": int(seeds.shape[1]),
            "max_abs_err": assert_close_pairs(f"K3-SQ8 hop 0 kp {kp}", d0,
                                              p0, d1, p1),
            "ms": uncounted(lambda: cuda_ms(scan, WIDE["reps"]), cmp),
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q8, qn8, plan, il, kp, False), 1),
            **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks, elem_bytes=1))}
    del d0, p0, d1, p1
    phase("hnsw_sq8_k100", k=k, kp=kp, codec_recall_at_100=C,
          flat=public(res_f), sq8=public(res_a),
          wide_launches={"k3": n_fl, "k3_sq8": n_sq8}, hop0_k3_sq8=hop0)
    return {"k3": n_fl, "sq8": n_sq8, "hop0": hop0}


def hnsw_rest_phase(hidx, hnsw_auto, xb, xt, xq, gt, gt100, dev,
                    tmp) -> dict:
    """Phase 17: IndexHNSWSQ (sq8 / bf16 / fp16), IndexHNSWPQ,
    IndexHNSW2Level, the tile beam, wave insertion, extend_graph,
    range_search, their files and the fused tiles above kp 32, on phase
    3's SIFT surrogate (phase 5's float set for the IP beam, phase 9's
    IVFHNSW15625 for the quantizer); 17a also at k 100 against ``gt100``.
    Returns the phase's K3 / K3-SQ8 launches, 17j's kp-64 record and
    `hnsw_sq8_k100`'s."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp = {}                             # comparison launches
    hops = 1                            # fused_hops, the default
    per = {"ivf_scan_fused": 1 + hops}
    per8 = {"ivf_scan_sq8": 1 + hops}
    xq_dev = torch.from_numpy(xq).to(dev)

    # -- 17a. HNSW16,SQ8: the graph built once, the uint8 tiles (K3-SQ8) ---
    A = T.index_factory(D, "HNSW16,SQ8", device=dev)
    t0 = time.perf_counter()
    A.add(xb)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"HNSW16,SQ8 build launched {counts()}")
    FL = on_graph(T.IndexHNSWFlat(D, 16, device=dev), A, xb)
    res_f = hnsw_searches(FL, xq, gt, "IndexHNSWFlat FL", per)
    res_a = hnsw_searches(A, xq, gt, "HNSW16,SQ8", per8)
    il = A._tiles_fused.il
    if not (isinstance(il, T.PackedInvListsSQ8) and not hasattr(il, "data")
            and A.storage.ntotal == 0 and A.storage.vectors.numel() == 0
            and A._vec_dev is None and il.codes.dtype == torch.uint8):
        raise AssertionError("HNSW16,SQ8 holds more than its uint8 tiles")
    rows8 = A._vectors()                 # the codes, dequantized
    C8 = codec_recall_rows(rows8, xq, gt, dev)
    codec_floor("HNSW16,SQ8", res_a, C8, res_f)
    ftg = A._tiles_fused
    pos_of = torch.empty(NB, dtype=torch.long, device=dev)
    pos_of[ftg.orig_ids[:NB].long()] = torch.arange(NB, device=dev)
    slot_of = torch.full((il.ids.numel(),), -1, dtype=torch.long, device=dev)
    ok = il.ids.view(-1) >= 0
    slot_of[il.ids.view(-1)[ok].long()] = torch.nonzero(ok).squeeze(1)
    for key in (0, 12345, NB - 1):
        slot = slot_of[pos_of[key]]
        want = (il.codes.view(-1, D)[slot].float() * il.sq_scale
                + il.sq_bias).cpu().numpy()
        if not np.array_equal(A.reconstruct(key), want):
            raise AssertionError(f"HNSW16,SQ8 reconstruct({key}) differs "
                                 f"from its dequantized code")
    phase("hnsw_sq8", build_s=t_build, tiles_s=A.build_seconds.get("tiles"),
          codec_recall=C8, tile_bytes=il.codes.nbytes,
          device_bytes=sum(t.nbytes for t in (il.codes, il.ids, il.norms)),
          flat=public(res_f), sq8=public(res_a))
    wide8 = hnsw_sq8_k100(A, FL, rows8, xq, xq_dev, gt100, dev, cmp)
    del rows8

    # -- 17b. SQbf16 / SQfp16 on (a)'s graph: bit for bit FL's (K3) ---------
    res_b = {}
    for spec in ("HNSW16,SQbf16", "HNSW16,SQfp16"):
        S = on_graph(T.index_factory(D, spec, device=dev), A, xb)
        r = hnsw_searches(S, xq, gt, spec, per)
        for ef in HNSW_EFS:
            if not (np.array_equal(r[ef]["D"], res_f[ef]["D"]) and
                    np.array_equal(r[ef]["I"], res_f[ef]["I"])):
                raise AssertionError(f"{spec} ef={ef}: (D, I) differ from "
                                     f"IndexHNSWFlat's")
        sil = S._tiles_fused.il
        res_b[spec] = {"stream_bytes": sum(
            {t.data_ptr(): t.nbytes for t in (sil.data, sil.data_bf16)}
            .values()), "bit_equal_to_flat": True, **public(r)}
        del S, sil
    phase("hnsw_sq16", **res_b)
    torch.cuda.empty_cache()

    # -- 17c. HNSW16,PQ32: the PQ tiles, ADC, no launch ----------------------
    P = T.index_factory(D, "HNSW16,PQ32", device=dev)
    t0 = time.perf_counter()
    P.train(xt)
    P.add(xb)
    torch.cuda.synchronize()
    t_pq = time.perf_counter() - t0
    res_c = hnsw_searches(P, xq, gt, "HNSW16,PQ32", {})
    dec = PQ.pq_decode(P._codes, P._cent)
    Cpq = codec_recall_rows(dec, xq, gt, dev)
    # the PQ route scans max(4, ef / 8) tiles at hop 0 where F's scans
    # max(8, ef / 2) (the reference's knobs): its floor takes F's tiles
    # searched at the PQ route's budget (K3 launches left out of the count)
    ftg = FL._ensure_tiles_fused()
    f_pq = {}
    for ef in HNSW_EFS:
        _, _, Im = uncounted(lambda: HT.tile_search_fused(
            ftg, xq_dev, K, nprobe0=max(4, ef // 8), hops=hops,
            expand=FL.hnsw.expand_tiles * 2, F=FL.hnsw.fused_F,
            kp=FL.hnsw.fused_kp, rk=max(2 * K, min(ef, 64))), cmp)
        f_pq[ef] = {"recall_at_10": T.recall_k_at_k(Im.cpu().numpy(), gt,
                                                    K)}
        res_c[ef]["flat_at_its_budget"] = f_pq[ef]["recall_at_10"]
    codec_floor("HNSW16,PQ32", res_c, Cpq, f_pq)
    lut = PQ.query_tables(xq_dev, P._cent)
    for ef, r in res_c.items():
        Ir = torch.from_numpy(r["I"]).to(dev)
        adc = PQ.adc_scan(lut, P._codes[Ir]).cpu().numpy()
        if not np.allclose(r["D"], adc, rtol=1e-4, atol=0):
            raise AssertionError(f"HNSW16,PQ32 ef={ef}: D are not the ADC "
                                 f"distances of the returned ids")
    phase("hnsw_pq", build_s=t_pq, codec_recall=Cpq,
          code_bytes=P._codes.nbytes, tile_code_bytes=P._ptiles.il.codes.nbytes,
          storage_rows=P.storage.ntotal, searches=public(res_c))
    del dec, lut

    # -- 17d. HNSW16,4096+PQ32: IndexHNSW2Level, bf16 decoded tiles (K3) ---
    L = T.index_factory(D, "HNSW16,4096+PQ32", device=dev)
    t0 = time.perf_counter()
    L.train(xt)
    L.add(xb)
    torch.cuda.synchronize()
    t_2l = time.perf_counter() - t0
    back = L.sa_decode(L.sa_encode(xb))
    if not np.array_equal(back, L.storage.vectors.cpu().numpy()):
        raise AssertionError("2-level: sa_decode(sa_encode(x)) differs from "
                             "the rows the graph was built on")
    del back
    res_d = hnsw_searches(L, xq, gt, "HNSW16,4096+PQ32", per)
    C2 = codec_recall_rows(L._vectors(), xq, gt, dev)
    codec_floor("HNSW16,4096+PQ32", res_d, C2, res_f)
    phase("hnsw_2level", build_s=t_2l, codec_recall=C2,
          code_bytes=L.codec._codes.nbytes + L.codec._list_ids.nbytes,
          searches=public(res_d))

    # -- 17i. (a), (c), (d) through files: (D, I) bit for bit ---------------
    files = {}
    p64 = T.SearchParametersHNSW(efSearch=64)
    for name, idx in (("SQ8", A), ("PQ32", P), ("4096+PQ32", L)):
        path = os.path.join(tmp, "hnsw.tann")
        want = idx.search(xq, K, params=p64)
        t0 = time.perf_counter()
        T.write_index(idx, path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = T.read_index(path, mmap=True, device=dev)
        got = again.search(xq, K, params=p64)
        t_reopen = time.perf_counter() - t0
        if not (np.array_equal(want[0], got[0]) and
                np.array_equal(want[1], got[1])):
            raise AssertionError(f"HNSW16,{name}: (D, I) differ after a "
                                 f"reopen")
        files[name] = {"file_bytes": os.path.getsize(path),
                       "write_s": t_write, "read_and_search_s": t_reopen}
        del again
        os.remove(path)
    phase("hnsw_files", bit_equal=True, **files)
    del A, P, L
    torch.cuda.empty_cache()

    # -- 17e. the tile beam on phase 5's float set: IP in "auto", L2 forced;
    # and L2 forced on F (the SIFT surrogate); no launch
    rng = np.random.default_rng(7)          # phase 5's float set
    xb_f = (xb + rng.random(xb.shape, dtype=np.float32))[:BEAM_NB]
    xq_f = (xq[:1024] + rng.random(xq[:1024].shape, dtype=np.float32)
            )[:HNSW_NQ_SMALL]
    beam = {}
    for name in ("ip_auto", "l2_beam", "sift_l2_beam"):
        if name == "sift_l2_beam":
            idx, q, g = FL, xq[:HNSW_NQ_SMALL], gt[:HNSW_NQ_SMALL]
        else:
            metric = T.METRIC_INNER_PRODUCT if name == "ip_auto" else \
                T.METRIC_L2
            idx = T.IndexHNSWFlat(D, 16, metric, device=dev)
            idx.add(xb_f)
            _, g = TD.knn(torch.from_numpy(xq_f).to(dev), idx._vectors(), K,
                          metric)
            q, g = xq_f, g.cpu().numpy()
        if name != "ip_auto":
            idx.hnsw.tile_mode = "beam"
        before = counts()
        res = hnsw_searches(idx, q, g, name, {}, efs=(64,))[64]
        q_dev = torch.from_numpy(q).to(dev)
        (_, In, _), t_node = timed(lambda: HN.hnsw_search(
            idx._vectors(), idx.graph, q_dev, ef=64, k=K,
            metric=idx.metric_type), 1)
        r_node = T.recall_k_at_k(In.cpu().numpy(), g, K)
        tg = idx._ensure_tiles()
        _, _, st = idx._tile_search_chunk(q_dev, K, 64)
        expect_launches(f"beam {name}", before, {})
        beam[name] = {
            "recall_at_10": res["recall_at_10"], "qps": res["qps"],
            "per_node_recall_at_10": r_node,
            "per_node_qps": len(q) / t_node,
            "hops": int(st["nhops"]),
            "visited_table_bytes": len(q) * (tg.ntiles + 1),
            "visited_table_bytes_8192": 8192 * (tg.ntiles + 1),
            "tiles_bytes": tg.device_bytes(),
            "beam_tiles_s": idx.build_seconds.get("beam_tiles")}
        # the same beam from the reference's 8 entry tiles (the index's
        # default takes efSearch / 2 = 32), and with 16 tiles a hop
        for key, kw in (("reference_seeds_8", dict(seed_count=8)),
                        ("scan_tiles_16", dict(scan_tiles=16))):
            _, Ik, _ = HT.tile_search(
                tg, q_dev, K, ef=64, expand=idx.hnsw.expand_tiles,
                metric=idx.metric_type, refine_vectors=idx._vectors(), **kw)
            beam[name][f"recall_at_10_{key}"] = T.recall_k_at_k(
                Ik.cpu().numpy(), g, K)
        if res["recall_at_10"] < r_node - 0.01:
            raise AssertionError(f"beam {name}: recall@10 "
                                 f"{res['recall_at_10']} < the per-node "
                                 f"beam's {r_node} - 0.01")
        if idx is not FL:
            del idx
        torch.cuda.empty_cache()
    FL.hnsw.tile_mode = "auto"
    phase("hnsw_beam", nq=HNSW_NQ_SMALL, efSearch=64, **beam)
    del xb_f

    # -- 17f. wave insertion over phase 9's 15625 centroids ------------------
    knn_q = hidx.quantizer
    Q = T.IndexHNSWFlat(D, 16, device=dev)
    Q.hnsw.build_mode = "insert"
    Q.hnsw.efConstruction = 40
    Q.add(knn_q._vectors().cpu().numpy())
    t_insert = Q.build_seconds["graph"]
    hidx.quantizer = Q
    n_chunks = -(-NQ // Q.search_chunk)
    ins = {}
    try:
        for nprobe in (32, 64):
            r = ivf_hnsw_search(hidx, xq_dev, xq, gt, nprobe, "quantizer",
                                n_chunks)
            _, hp = hidx._coarse_search_device(xq_dev, nprobe)
            hidx.coarse_mode = "auto"
            _, ep = hidx._coarse_search_device(xq_dev, nprobe)
            hp, ep = hp.cpu().numpy(), ep.cpu().numpy()
            fid = float(np.mean([len(set(a) & set(b)) / nprobe
                                 for a, b in zip(hp, ep)]))
            ins[nprobe] = {"recall_at_10": r["recall_at_10"],
                           "auto_recall_at_10": hnsw_auto[nprobe],
                           "qps": r["qps"], "fidelity": fid}
            if fid < 0.99 or abs(r["recall_at_10"] - hnsw_auto[nprobe]) \
                    > 0.01:
                raise AssertionError(f"insertion quantizer nprobe={nprobe}: "
                                     f"{ins[nprobe]}")
    finally:
        hidx.quantizer = knn_q
        hidx.coarse_mode = "auto"
    phase("hnsw_insert", nodes=Q.ntotal, insert_build_s=t_insert,
          knn_build_s=knn_q.build_seconds.get("graph"),
          max_level=Q.graph.max_level,
          searches={str(n): r for n, r in ins.items()})
    del Q

    # -- 17j. the fused tiles above kp 32: phase 9's quantizer at nprobe 64,
    # whose hop-0 scan is one launch of K3's wide-list kernel (kp 64) ------
    hidx.coarse_mode = "quantizer"
    qr = ivf_hnsw_search(hidx, xq_dev, xq, gt, 64, "quantizer", n_chunks)
    hidx.coarse_mode = "auto"
    c_cmp = counts()
    hq = hidx.quantizer
    ftq = hq._ensure_tiles_fused()
    x8 = xq_dev[:hq.search_chunk]
    ef = max(hq.hnsw.efSearch, hidx.coarse_ef_factor * 64)
    kp = max(hq.hnsw.fused_kp, min(ftq.b, 64, hq.hnsw.fused_kp_max))
    _, seeds = TD.knn(x8, ftq.cent, max(8, ef // 2), compute_dtype="bfloat16")
    plan = F.plan_pairs(seeds.to(torch.int32), ftq.il)
    # the centroids are floats: K3 and its plain version sum the exact
    # bf16 products in another order, so the pairs agree bit for bit on
    # an integer-rounded copy of the tiles (phase 16e's standard) and
    # within rtol 1e-5, positions up to near-ties, on the tiles themselves
    ri = torch.round(ftq.il.data)
    il_int = T.PackedInvLists(
        data=ri, data_bf16=ri.to(torch.bfloat16), ids=ftq.il.ids,
        norms=(ri * ri).sum(-1), list_block_start=ftq.il.list_block_start,
        list_nblocks=ftq.il.list_nblocks)
    for lists in (il_int, ftq.il):
        q16, qn = F.fold_queries(torch.round(x8) if lists is il_int
                                 else x8, lists, False)
        d1, p1 = F.scan_pairs(q16, qn, plan, lists, kp, False)
        d0, p0 = F.scan_pairs_reference(q16, qn, plan, lists, kp, False)
        if lists is il_int and not (torch.equal(d0, d1) and
                                    torch.equal(p0, p1)):
            raise AssertionError("the quantizer's hop-0 scan at kp 64 "
                                 "differs from its plain version on "
                                 "integer tiles")
    err = assert_close_pairs("the quantizer's hop-0 scan at kp 64", d0, p0,
                             d1, p1)
    wide = {"kp": kp, "pairs": int(seeds.numel()),
            "ms": cuda_ms(lambda: F.scan_pairs(q16, qn, plan, ftq.il, kp,
                                                False), 5),
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q16, qn, plan, ftq.il, kp, False), 1),
            "max_abs_err": err, "integer_tiles_bit_equal": True,
            **bound(*pair_scan_work(plan, ftq.il.ids, ftq.il.block_size, D,
                                    kp, 0, ftq.il.nblocks))}
    if wide["ms"] >= wide["plain_ms"]:
        raise AssertionError(f"the quantizer's hop-0 scan at kp 64: K3 takes "
                             f"{wide['ms']} ms, its plain version "
                             f"{wide['plain_ms']}")
    del il_int, ri
    for k, v in launched(c_cmp).items():
        cmp[k] = cmp.get(k, 0) + v
    phase("hnsw_quantizer_kp64", qps=qr["qps"],
          recall_at_10=qr["recall_at_10"], hop0_scan=wide)
    del d0, p0, d1, p1, plan

    # -- 17g. extend_graph: 900k by the kNN build, 100k added by waves ------
    nb0 = NB - NB // 10
    G = T.IndexHNSWFlat(D, 16, device=dev)
    G.add(xb[:nb0])
    t_g_build = G.build_seconds["graph"]
    before = counts()
    G.add(xb[nb0:])
    t_extend = G.build_seconds["extend"]
    expect_launches("extend_graph", before, {})
    res_g = hnsw_searches(G, xq, gt, "extended", per, efs=(64,))[64]
    if abs(res_g["recall_at_10"] - res_f[64]["recall_at_10"]) > 0.01:
        raise AssertionError(f"extended: recall@10 {res_g['recall_at_10']} "
                             f"vs a fresh build's {res_f[64]['recall_at_10']}")
    # rows searched back as queries: 1000 added and 1000 built ones. Not
    # every row comes back first, added or not (an approximate search on
    # this surrogate): through the route G.search takes (the fused tiles,
    # efSearch 64) the added rows must come back first at distance 0 (the
    # row or an exact duplicate) as often as the built ones, within 2% of
    # the sample (at a 3% miss rate two 1000-row samples differ by 7.6 rows
    # at one standard deviation: 20 is 2.6 of them); the graph walk's
    # misses (the per-node beam over G's graph) are printed beside them
    rs = np.random.RandomState(17)
    sample = {"added": rs.choice(np.arange(nb0, NB), HNSW_NQ_SMALL, False),
              "built": rs.choice(nb0, HNSW_NQ_SMALL, False)}

    def misses(D1, I1, rows):
        found = (D1[:, 0] == 0) & ((I1[:, 0] == rows) |
                                   (xb[I1[:, 0]] == xb[rows]).all(1))
        return int((~found).sum())

    missed = {}
    for name, rows in sample.items():
        q_dev = torch.from_numpy(xb[rows]).to(dev)
        Dn, In, _ = HN.hnsw_search(G._vectors(), G.graph, q_dev, ef=64, k=1)
        missed[f"{name}_graph"] = misses(Dn.cpu().numpy(), In.cpu().numpy(),
                                         rows)
        missed[f"{name}_fused"] = misses(
            *G.search(xb[rows], 1, params=p64), rows)
    if missed["added_fused"] > missed["built_fused"] + HNSW_NQ_SMALL // 50:
        raise AssertionError(f"extended: the added rows are found less "
                             f"often than the built ones: {missed}")
    # the fused tiles in two other orders, searched by the same calls: the
    # carried cells with their rows in id order (the build's own rule,
    # under which the added rows close every cell), and `spatial_order`'s
    # own k-means order (the reference's after an extension, as it drops
    # the coarse assignment)
    ca, order = G._coarse_assign, G._tile_order
    others = {}
    orders = [("kmeans", None)]
    if ca is not None:
        orders.insert(0, ("id_in_cell", np.lexsort((np.arange(NB), ca))))
    for key, o in orders:
        G._coarse_assign = ca if o is not None else None
        G._tile_order, G._tiles_fused = o, None
        _, Io = uncounted(lambda: G.search(xq, K, params=p64), cmp)
        others[key] = {"recall_at_10": T.recall_k_at_k(Io, gt, K)}
        for name, rows in sample.items():
            others[key][f"{name}_fused_missed"] = misses(*uncounted(
                lambda: G.search(xb[rows], 1, params=p64), cmp), rows)
    G._coarse_assign, G._tile_order, G._tiles_fused = ca, order, None
    phase("hnsw_extend", base=nb0, added=NB - nb0, build_s=t_g_build,
          extend_s=t_extend, recall_at_10=res_g["recall_at_10"],
          fresh_recall_at_10=res_f[64]["recall_at_10"], qps=res_g["qps"],
          sampled=HNSW_NQ_SMALL, missed_first=missed, other_orders=others)

    # -- 17h. range_search on (g)'s index --------------------------------------
    xr = xq[:HNSW_NQ_SMALL]
    xr_dev = xq_dev[:HNSW_NQ_SMALL]
    xb_dev = G._vectors()
    De, _ = TD.knn(xr_dev, xb_dev, K)
    radius = float(De[:, K - 1].median())
    before = counts()
    (lims, Dr, Ir), t_range = timed(lambda: G.range_search(xr, radius), 1)
    qr_ = np.repeat(np.arange(len(xr)), np.diff(lims))
    exact = ((xb[Ir] - xr[qr_]) ** 2).sum(1)
    if not ((Dr < radius).all() and np.allclose(Dr, exact, rtol=1e-5,
                                                atol=0)):
        raise AssertionError("range_search: a hit outside the radius or at "
                             "another distance")
    hit_keys = set((qr_ * NB + Ir).tolist())
    brute = set()
    for q0 in range(0, len(xr), 100):
        dist = TD.pairwise_l2sqr(xr_dev[q0:q0 + 100], xb_dev)
        qi, ii = torch.nonzero(dist < radius, as_tuple=True)
        brute.update(((qi + q0) * NB + ii).cpu().numpy().tolist())
        del dist
    n_brute, missing = len(brute), len(hit_keys - brute)
    if missing:
        raise AssertionError(f"range_search: {missing} hits outside the "
                             f"brute-force range set")
    phase("hnsw_range", nq=len(xr), radius=radius, hits=int(lims[-1]),
          brute_force=n_brute, share=lims[-1] / max(n_brute, 1),
          seconds=t_range, launches=launched(before))
    del G, FL
    torch.cuda.empty_cache()
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()
           if v != cmp.get(k, 0)}
    phase("hnsw_rest", seconds=time.perf_counter() - t_phase, launches=got,
          comparison_launches=cmp, kp64=wide)
    return got, wide, wide8


# -- phase 18: the index API breadth -------------------------------------------

# extra metrics of phase 18h: (name, metric, metric_arg, rtol of the f32
# search against the f64 evaluation). JensenShannon sums terms of both
# signs (x log(x / m)), whose f32 rounding is relative to the terms, not to
# the small sum: 1e-4 there
EXTRA = (("L1", 2, 0.0, 1e-5), ("Linf", 3, 0.0, 1e-5),
         ("Lp3", 4, 3.0, 1e-5), ("Canberra", 20, 0.0, 1e-5),
         ("BrayCurtis", 21, 0.0, 1e-5), ("JensenShannon", 22, 0.0, 1e-4),
         ("Jaccard", 23, 0.0, 1e-5), ("NaNEuclidean", 24, 0.0, 1e-5),
         ("AbsInnerProduct", 25, 0.0, 1e-5))
EXTRA_NQ, EXTRA_NB64, EXTRA_NQ64 = 256, 100_000, 32
# 18h's base: the first 250k rows (cut from 1M to pay for phase 23)
EXTRA_NB = 250_000
# 18g's slices: 10 of 25k rows (cut from 100k to pay for phase 23)
WINDOW_ROWS = 25_000
# 18c's rows: the first 250k (cut from 1M to pay for phase 23)
IDMAP_NB = 250_000
# 18f: the least share of a split list's rows each of its two parts holds
SPLIT_MIN_SHARE = 0.05
# 18f: the lists one round splits, the largest (cut from 8 to pay for
# phase 23)
BALANCE_SPLITS = 4


def exact_recall(xq_dev, rows_dev, gt) -> float:
    """recall@10 of exact f32 search of xq over rows (device tensors)."""
    _, I = TD.knn(xq_dev, rows_dev, K)
    return T.recall_k_at_k(I.cpu().numpy(), gt, K)


def ivf_searches(idx, xq, gt, name, want, nprobes=(16, 32, 64)) -> dict:
    """One warm-up and one timed search a nprobe, each launching ``want``;
    {nprobe: (recall, qps, (D, I))}."""
    out = {}
    for nprobe in nprobes:
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = counts()
        idx.search(xq, K, params=p)
        (Dv, Iv), s = timed(lambda: idx.search(xq, K, params=p), warm=lambda:
                            None)
        expect_launches(f"{name} nprobe={nprobe}", before,
                        {k: 2 * v for k, v in want.items()})
        out[nprobe] = (T.recall_k_at_k(Iv, gt, K), len(xq) / s, (Dv, Iv))
    return out


def same_topk_within(name, D64, I64, Dv, Iv, rtol) -> None:
    """Ids equal up to ties, where a tie is a run of the f64 reference's
    distances within rtol of each other (the f32 search may order those
    either way; the run at the cut may differ), and the f32 distances
    within rtol of the f64 ones."""
    for r in range(len(D64)):
        row, start = D64[r], 0
        for i in range(1, len(row) + 1):
            if i < len(row) and abs(row[i] - row[start]) <= \
                    rtol * max(abs(row[start]), 1e-30):
                continue
            if i < len(row) and sorted(I64[r, start:i]) != \
                    sorted(Iv[r, start:i]):
                raise AssertionError(f"{name} row {r}: ids {Iv[r]} vs the "
                                     f"f64 evaluation's {I64[r]}")
            start = i
    fin = np.isfinite(D64)
    if not np.allclose(Dv[fin], D64[fin], rtol=rtol, atol=0):
        raise AssertionError(f"{name}: distances beyond rtol {rtol} of f64")


def breadth_transforms(quant3, xb, xt, xq, gt, flat_rec, dev, cmp) -> dict:
    """18a PCA64,IVF4096,Flat and 18b OPQ16_64,IVF4096,PQ16 (beside
    IVF4096,PQ16). Returns K3 at d 64 (10k q, nprobe 32) for the kernels
    line; the launches of the direct IVF, of IVF4096,PQ16 and of K3's
    comparison with its plain version go to ``cmp``."""
    xq_dev = torch.from_numpy(xq).to(dev)
    k3 = {"ivf_scan_fused": 1}

    # -- 18a. PCA64,IVF4096,Flat ----------------------------------------------
    A = T.index_factory(D, f"PCA64,IVF{NLIST},Flat", device=dev)
    vt, ivf = A.chain[0], A.index
    (_, t_train) = timed(lambda: A.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: A.add(xb), warm=lambda: None)
    x64 = vt.apply(torch.from_numpy(xb).to(dev))
    q64 = vt.apply(xq_dev)
    c_pca = exact_recall(q64, x64, gt)
    # the same centroids, an IndexIVFFlat over vt.apply(x) built directly
    q_direct = T.IndexFlat(64, device=dev)
    q_direct.add(ivf.quantizer.vectors.cpu().numpy())
    B = T.IndexIVFFlat(q_direct, 64, NLIST, device=dev)
    B.quantizer_trains_alone = 1
    B.train(x64[:1000].cpu().numpy())
    B.add(vt.apply(xb))
    del x64
    res_a = ivf_searches(A, xq, gt, "PCA64,IVF4096,Flat", k3)
    res_b = uncounted(lambda: ivf_searches(B, vt.apply(xq), gt,
                                           "direct IVF over PCA64", k3), cmp)
    for n, (rec, _, out) in res_a.items():
        floor = c_pca * flat_rec[n] - 0.01
        if rec < floor:
            raise AssertionError(f"PCA64 nprobe={n}: recall@10 {rec} < "
                                 f"{floor}")
        for a, b in zip(out, res_b[n][2]):
            assert_equal(f"PCA64 nprobe={n} vs the direct IVF",
                         torch.from_numpy(a), torch.from_numpy(b))
    # K3 at d 64: 10k queries, nprobe 32, against its plain version
    il = ivf.invlists
    _, probes = ivf._coarse_search_device(q64, 32)
    plan = F.plan_pairs(probes, il)
    kp = F.default_kp(K)
    qn, q16 = TD.l2_norms(q64), q64.to(torch.bfloat16)

    def k3_at_d64() -> dict:
        d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, False)
        d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, False)
        err = assert_close_pairs("K3 at d 64", d0, p0, d1, p1)
        return {"d64_max_abs_err": err,
                "d64_ms": cuda_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp,
                                                       False), 10),
                "d64_plain_ms": host_ms(lambda: F.scan_pairs_reference(
                    q16, qn, plan, il, kp, False), 1),
                "d64_bound_ms": bound(*pair_scan_work(
                    plan, il.ids, il.block_size, 64, kp, 0,
                    il.nblocks))["bound_ms"]}

    k3_d64 = uncounted(k3_at_d64, cmp)
    phase("breadth_pca", train_s=t_train, add_s=t_add, codec_recall=c_pca,
          searches={n: {"recall_at_10": r[0], "qps": r[1],
                        "floor": c_pca * flat_rec[n] - 0.01}
                    for n, r in res_a.items()},
          equal_to_direct_ivf=True, k3_launches_per_search=1, **k3_d64)
    del A, B, res_a, res_b, il, plan
    torch.cuda.empty_cache()

    # -- 18b. OPQ16_64,IVF4096,PQ16 (faiss's OPQ-IVF-PQ deployment) ----------
    O = T.index_factory(D, f"OPQ16_64,IVF{NLIST},PQ16", device=dev)
    opq, ivfpq = O.chain[0], O.index
    (_, t_opq) = timed(lambda: opq.train(xt), warm=lambda: None)
    (_, t_train) = timed(lambda: O.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: O.add(xb), warm=lambda: None)
    f32 = ivfpq._decode_lists(torch.float32)
    C = exact_recall(opq.apply(xq_dev), rows_by_id(f32, NB, dev), gt)
    del f32
    floors = {n: C * flat_rec[n] - 0.01 for n in (16, 32, 64)}
    res_o = pq_searches(O, xq, gt, "OPQ16_64,IVF4096,PQ16", k3,
                        floors=floors)
    ivfpq.decoded_cache_dtype = "sq8"
    ivfpq._decoded = None
    res_o8 = pq_searches(O, xq, gt, "OPQ16_64,IVF4096,PQ16 sq8 cache",
                         {"ivf_scan_sq8": 1})
    for n, r in res_o8.items():
        if abs(r["recall_at_10"] - res_o[n]["recall_at_10"]) > 0.01:
            raise AssertionError(f"OPQ sq8 cache nprobe={n}: recall "
                                 f"{r['recall_at_10']} vs bf16's "
                                 f"{res_o[n]['recall_at_10']}")
    del O, ivfpq
    torch.cuda.empty_cache()
    P16, t16_train, t16_add = ivf_pq_over(quant3, 16, 8, xt, xb,
                                          np.arange(NB), dev)
    f32 = P16._decode_lists(torch.float32)
    C16 = exact_recall(xq_dev, rows_by_id(f32, NB, dev), gt)
    del f32
    res_p = uncounted(lambda: pq_searches(P16, xq, gt, "IVF4096,PQ16", k3),
                      cmp)
    phase("breadth_opq", opq_train_s=t_opq, train_s=t_train, add_s=t_add,
          codec_recall=C, searches=res_o, sq8_cache=res_o8,
          without_opq={"train_s": t16_train, "add_s": t16_add,
                       "codec_recall": C16, "searches": res_p})
    del P16
    torch.cuda.empty_cache()
    return k3_d64


def unique_ids(n: int, seed: int) -> np.ndarray:
    """n distinct random int64 ids above 2^32."""
    rs = np.random.RandomState(seed)
    ids = np.unique(rs.randint(0, 1 << 60, size=n + n // 8,
                               dtype=np.int64))
    return (rs.permutation(ids)[:n] + (1 << 32)).astype(np.int64)


def breadth_idmap(quant3, xb, xt, xq, gt, dev, tmp, cmp) -> None:
    """18c IDMap2,IVF4096,Flat over the first IDMAP_NB rows with random
    external ids; 18d IndexShards and IndexReplicas. The launches of the indexes they are held against
    (the sub-index searched alone, a fresh IDMap2, the index a file is
    held against) go to ``cmp``."""
    k3 = {"ivf_scan_fused": 1}
    p32 = T.SearchParametersIVF(nprobe=32)
    nb = min(IDMAP_NB, NB)
    xm = xb[:nb]
    nmore = nb // 10                     # rows removed, then added
    ext = unique_ids(nb + nmore, 18)

    def idmap2(rows, ids):
        ivf = T.IndexIVFFlat(quant3, D, NLIST, device=dev)
        ivf.quantizer_trains_alone = 1
        ivf.train(xt)
        idx = T.IndexIDMap2(ivf)
        idx.add_with_ids(rows, ids)
        return idx

    # -- 18c. IDMap2,IVF4096,Flat ------------------------------------------
    (M, t_add) = timed(lambda: idmap2(xm, ext[:nb]), warm=lambda: None)
    before = counts()
    Ds, Is = uncounted(lambda: M.index.search(xq, K, params=p32), cmp)
    Dm, Im = M.search(xq, K, params=p32)
    expect_launches("IDMap2 search", before, {"ivf_scan_fused": 2})
    if not (np.array_equal(Dm, Ds) and
            np.array_equal(Im, np.where(Is >= 0, M.id_map[Is], -1))):
        raise AssertionError("IDMap2: search differs from the sub-index's "
                             "mapped through id_map")
    # a selector over external ids: the query-major scan over every list
    # equals exact search over the selected rows
    rs = np.random.RandomState(19)
    pick = np.sort(rs.choice(nb, nb // 10, replace=False))
    xs = xq[:200]
    (Dsel, Isel), t_sel = timed(lambda: M.search(
        xs, K, params=T.SearchParametersIVF(
            nprobe=NLIST, sel=T.IDSelectorBatch(ext[pick]))),
        warm=lambda: None)
    De, Ie = TD.knn(torch.from_numpy(xs).to(dev),
                    torch.from_numpy(xm[pick]).to(dev), K)
    assert_same_topk(De.cpu().numpy(), ext[pick][Ie.cpu().numpy()], Dsel,
                     Isel)
    # remove 100k external ids; a fresh IDMap2 over the survivors
    gone = rs.choice(nb, nmore, replace=False)
    (n_rm, t_rm) = timed(lambda: M.remove_ids(T.IDSelectorBatch(ext[gone])),
                         warm=lambda: None)
    if n_rm != len(gone) or M.ntotal != nb - len(gone):
        raise AssertionError(f"IDMap2 removed {n_rm} of {len(gone)}")
    keep = np.ones(nb, bool)
    keep[gone] = False
    fresh = idmap2(xm[keep], ext[:nb][keep])
    same_search("IDMap2 after removal vs a fresh IDMap2",
                uncounted(lambda: fresh.search(xq, K, params=p32), cmp),
                M.search(xq, K, params=p32))
    del fresh
    # 100k more rows (the train slice) under new ids: no id repeats, each
    # added row found back at distance 0 under its own id
    new = xt[:nmore]
    (_, t_add2) = timed(lambda: M.add_with_ids(new, ext[nb:]),
                        warm=lambda: None)
    live = M.id_map if M._gone is None else M.id_map[~M._gone]
    if len(np.unique(live)) != len(live) or len(live) != M.ntotal:
        raise AssertionError("IDMap2: external ids repeat after the add")
    sample = rs.choice(len(new), 200, replace=False)
    Dn, In = M.search(new[sample], 1, params=p32)
    back = M.reconstruct_batch(In[:, 0])
    if not ((Dn[:, 0] == 0).all() and np.array_equal(back, new[sample])):
        raise AssertionError("IDMap2: added rows not found back")
    rows = rs.choice(np.nonzero(keep)[0], 200, replace=False)
    if not np.array_equal(M.reconstruct_batch(ext[rows]), xm[rows]):
        raise AssertionError("IDMap2: reconstruct by external id differs")
    path = os.path.join(tmp, "idmap2.tann")
    (_, t_write) = timed(lambda: T.write_index(M, path), warm=lambda: None)
    (R, t_read) = timed(lambda: T.read_index(path, device=dev),
                        warm=lambda: None)
    a = uncounted(lambda: M.search(xq, K, params=p32), cmp)
    b = R.search(xq, K, params=p32)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError("IxM2 file: reopened index differs")
    nbytes = os.path.getsize(path)
    os.remove(path)
    del R
    phase("breadth_idmap2", nb=nb, add_s=t_add, selector_nq=len(xs),
          selector_rows=len(pick), selector_s=t_sel, removed=n_rm,
          remove_s=t_rm, add_after_remove_s=t_add2, ntotal=M.ntotal,
          file_bytes=nbytes, write_s=t_write, read_s=t_read,
          bit_equal=True)

    # -- 18d. IndexShards (two adds) and IndexReplicas --------------------------
    S = T.IndexShards(D, device=dev)
    for _ in range(4):
        S.add_shard(T.IndexFlat(D, device=dev))
    S.add(xb[:NB // 2])
    S.add(xb[NB // 2:])
    # the ids follow the order of the adds: one IndexFlat over xb as it is
    flat = T.IndexFlat(D, device=dev)
    flat.add(xb)
    before = counts()
    (Dsh, Ish), t_sh = timed(lambda: S.search(xq, K), reps=3)
    Df, If = flat.search(xq, K)
    expect_launches("IndexShards", before, {})
    same_search("IndexShards (two adds) vs IndexFlat", (Df, If), (Dsh, Ish))
    rows = np.sort(np.random.RandomState(22).choice(NB, 1000, replace=False))
    _, Iself = S.search(xb[rows], 1)
    if not np.array_equal(Iself[:, 0], rows):
        raise AssertionError("IndexShards: rows searched for themselves "
                             "come back under other ids")
    del S, flat
    torch.cuda.empty_cache()
    Rp = T.IndexReplicas(D, device=dev)
    Rp.add_replica(M.index)
    Rp.add_replica(T.clone_index(M.index))
    before = counts()
    (Dr, Ir), t_rp = timed(lambda: Rp.search(xq, K, params=p32))
    expect_launches("IndexReplicas", before, {"ivf_scan_fused": 4})
    Dsub, Isub = uncounted(lambda: M.index.search(xq, K, params=p32), cmp)
    if not (np.array_equal(Dr, Dsub) and np.array_equal(Ir, Isub)):
        raise AssertionError("IndexReplicas differ from their sub-index")
    phase("breadth_shards", shards=4, adds=2, shards_qps=NQ / t_sh,
          equal_to_flat=True, self_search_rows=len(rows), replicas=2,
          replicas_qps=NQ / t_rp,
          replicas_bit_equal=True)


def breadth_tune(quant3, hidx, xb, xt, xq, gt, flat_rec, dev, cmp) -> None:
    """18e ParameterSpace.explore, 18g SlidingIndexWindow (18f, on phase
    9's index, runs last: breadth_balance). The launches of the fresh IVFs
    the window is held against go to ``cmp``."""
    from tpu_ann_torch.utils import autotune as AT
    from tpu_ann_torch.utils import ivflib as IL

    # -- 18e. explore over IVF4096,Flat and over IVFHNSW15625 -----------------
    ivf = ivf_over(quant3, xb, np.arange(NB), xt, dev=dev)
    ivf.search_chunk = 2048            # bounds nprobe 2048's pair buffers
    crit = AT.IntersectionCriterion(NQ, K)
    crit.set_groundtruth(None, gt)
    ps = AT.ParameterSpace()
    ps.initialize(ivf)
    t0 = time.perf_counter()
    ops = ps.explore(ivf, xq, crit)
    t_explore = time.perf_counter() - t0
    perf = {p.key: p.perf for p in ops.all_pts}
    for n in (16, 32, 64):
        if perf[f"nprobe={n}"] != flat_rec[n]:
            raise AssertionError(f"explore nprobe={n}: {perf} vs phase 3's "
                                 f"{flat_rec[n]}")
    pareto = [(p.key, p.perf, p.t) for p in ops.optimal_pts()]
    del ivf
    torch.cuda.empty_cache()
    ef0 = hidx.quantizer.hnsw.efSearch
    hidx.coarse_mode = "quantizer"      # efSearch reaches the graph only so
    ph = AT.ParameterSpace()
    ph.initialize(hidx)
    nprobes = ph.parameter_ranges["nprobe"]
    # depth cut: nprobe up to 128 (the grid's 4096 scans 41M pairs a search)
    ph.parameter_ranges["nprobe"] = [n for n in nprobes if 8 <= n <= 128]
    t0 = time.perf_counter()
    oph = ph.explore(hidx, xq, crit)
    t_explore_h = time.perf_counter() - t0
    hidx.coarse_mode = "auto"
    hidx.nprobe = 1
    hidx.quantizer.hnsw.efSearch = ef0
    phase("breadth_explore", ivf_points=len(ops.all_pts), ivf_pareto=pareto,
          ivf_seconds=t_explore, ivfhnsw_grid=ph.parameter_ranges,
          ivfhnsw_full_nprobe_range=nprobes,
          ivfhnsw_pareto=[(p.key, p.perf, p.t) for p in oph.optimal_pts()],
          ivfhnsw_seconds=t_explore_h)

    # -- 18g. SlidingIndexWindow: 10 slices of WINDOW_ROWS, nslice 4 ---------
    W = T.IndexIVFFlat(quant3, D, NLIST, device=dev)
    W.quantizer_trains_alone = 1
    W.train(xt)
    W.nprobe = 32
    win = IL.SlidingIndexWindow(W, 4)
    step_s, sl = [], WINDOW_ROWS
    for s in range(10):
        before = counts()
        (_, t_step) = timed(lambda: win.step(xb[s * sl:(s + 1) * sl]),
                            warm=lambda: None)
        step_s.append(t_step)
        lo = max(0, s - 3) * sl
        fresh = ivf_over(quant3, xb[lo:(s + 1) * sl],
                         np.arange(lo, (s + 1) * sl), xt, dev=dev)
        fresh.nprobe = 32
        a, b = W.search(xq, K), uncounted(lambda: fresh.search(xq, K), cmp)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"SlidingIndexWindow step {s}: differs "
                                 f"from an IVF over the live slices")
        expect_launches(f"window step {s}", before, {"ivf_scan_fused": 2})
    phase("breadth_window", slices=10, slice_rows=sl, nslice=4,
          step_s=step_s, ntotal=W.ntotal, bit_equal=True)


def breadth_balance(hidx, xq, gt, dev) -> None:
    """18f: ClusterManager.balance, one round, on phase 9's IVFHNSW15625
    (after phase 17, its last reader). Each split list's own rows must
    land in both of its parts; the list that is largest after the round
    is named, with where its rows came from."""
    from tpu_ann_torch.utils import ivflib as IL

    p32 = T.SearchParametersIVF(nprobe=32)
    hidx.coarse_mode = "auto"
    rec0 = T.recall_k_at_k(hidx.search(xq, K, params=p32)[1], gt, K)
    sizes0 = hidx.list_sizes
    assign0 = np.concatenate(hidx._assign_host)       # row -> list
    imb0 = hidx.imbalance_factor()
    nlist0 = hidx.nlist
    cap = int(np.sort(sizes0)[-(BALANCE_SPLITS + 1)])
    cm = IL.ClusterManager(hidx, cap)
    # one round splits the oversized lists largest first; the j-th split
    # appends list nlist0 + j
    split = sorted(cm.oversized_lists(), key=lambda i: -sizes0[i])
    nsplit = len(split)
    t0 = time.perf_counter()
    created = cm.balance(max_rounds=1)
    t_bal = time.perf_counter() - t0
    sizes = hidx.list_sizes
    assign1 = np.concatenate(hidx._assign_host)
    if hidx.nlist != nlist0 + created or created != nsplit or \
            hidx.quantizer.ntotal != hidx.nlist:
        raise AssertionError(f"balance: nlist {nlist0} -> {hidx.nlist}, "
                             f"{created} created of {nsplit} splits")
    if sizes.sum() != hidx.ntotal or len(sizes) != hidx.nlist:
        raise AssertionError("balance: list sizes do not sum to ntotal")
    ids = hidx.invlists.ids[:-1].reshape(-1)
    ids = ids[ids >= 0].long()
    seen = torch.bincount(ids, minlength=hidx.ntotal)
    if not bool((seen == 1).all()):
        raise AssertionError("balance: a row is in no list or in two")
    if not np.array_equal(np.bincount(assign1, minlength=hidx.nlist), sizes):
        raise AssertionError("balance: host assignments disagree with the "
                             "packed lists")
    # each split list's own rows go to both of its parts, each part
    # holding at least SPLIT_MIN_SHARE of them (a degenerate 2-means or a
    # split of another list does not); the parts also take rows from
    # other lists, which every row's exact reassignment allows
    was_split0 = np.isin(assign0, split)
    splits = []
    for j, lst in enumerate(split):
        new = nlist0 + j
        mine = assign1[assign0 == lst]
        into = (assign1 == lst) | (assign1 == new)
        r = {"list": int(lst), "before": int(sizes0[lst]),
             "after": int(sizes[lst]), "new_list": new,
             "new_after": int(sizes[new]),
             "rows_kept": int((mine == lst).sum()),
             "rows_to_new": int((mine == new).sum()),
             "rows_to_others": int(((mine != lst) & (mine != new)).sum()),
             "rows_in_from_split": int((into & was_split0 &
                                        (assign0 != lst)).sum()),
             "rows_in_from_unsplit": int((into & ~was_split0).sum())}
        splits.append(r)
        if min(r["rows_kept"], r["rows_to_new"]) < \
                SPLIT_MIN_SHARE * r["before"]:
            raise AssertionError(f"balance: list {lst} was not split: "
                                 f"{r}")
    # the largest list after the round, and where its rows were before
    top = int(np.argmax(sizes))
    came = assign0[assign1 == top]
    was_split = np.isin(came, split)
    largest = {"list": top, "after": int(sizes[top]),
               "before": int(sizes0[top]) if top < nlist0 else 0,
               "split": bool(top in split or top >= nlist0),
               "rows_from_itself": int((came == top).sum()),
               "rows_from_split_lists": int((was_split & (came != top)).sum()),
               "rows_from_other_lists": int((~was_split &
                                             (came != top)).sum())}
    # lists that no split touched and yet grew: rows can reach them only
    # from a split list, whose centroid moved
    grown = np.nonzero(sizes[:nlist0] > sizes0)[0]
    grown = grown[~np.isin(grown, split)]
    moved = assign1 != assign0
    rec = T.recall_k_at_k(hidx.search(xq, K, params=p32)[1], gt, K)
    if abs(rec - rec0) > 0.01:
        raise AssertionError(f"balance: recall@10 {rec0} -> {rec}")
    phase("breadth_balance", max_cell_size=cap, splits=nsplit,
          nlist=[nlist0, hidx.nlist], largest=[int(sizes0.max()),
                                               int(sizes.max())],
          largest_after=largest, split_lists=splits,
          unsplit_lists_grown=len(grown),
          rows_gained_by_unsplit=int((sizes[grown] - sizes0[grown]).sum()),
          rows_moved_from_split=int((moved & was_split0).sum()),
          rows_moved_from_unsplit=int((moved & ~was_split0).sum()),
          imbalance=[imb0, hidx.imbalance_factor()],
          recall_at_10_nprobe32=[rec0, rec], seconds=t_bal,
          seconds_a_split=t_bal / max(nsplit, 1))


def f64_extra(name, q, b, arg) -> torch.Tensor:
    """(nq, nb) f64 values of the extra metric ``name`` (faiss's
    extra_distances-inl.h formulas), evaluated apart from
    ops/extra_distances: torch.cdist for the Minkowski family and the sums
    of |x -/+ y|, products of magnitudes and NaN masks, and a loop over the
    dimensions for the rest."""
    if name == "L1":
        return torch.cdist(q, b, p=1)
    if name == "Linf":
        return torch.cdist(q, b, p=float("inf"))
    if name == "Lp3":
        return torch.cdist(q, b, p=arg) ** arg
    if name == "AbsInnerProduct":
        return q.abs() @ b.abs().T
    if name == "BrayCurtis":                   # sum|x - y| / sum|x + y|
        return torch.cdist(q, b, p=1) / torch.cdist(q, -b, p=1)
    if name == "Jaccard":                      # x, y >= 0: min / max sums
        l1 = torch.cdist(q, b, p=1)
        s = q.sum(1)[:, None] + b.sum(1)[None, :]
        return torch.where(s + l1 > 0, (s - l1) / (s + l1), 0.0)
    if name == "NaNEuclidean":
        mq, mb = (~q.isnan()).double(), (~b.isnan()).double()
        q0, b0 = q.nan_to_num(0.0), b.nan_to_num(0.0)
        present = mq @ mb.T
        accu = (q0 * q0) @ mb.T - 2 * (q0 @ b0.T) + mq @ (b0 * b0).T
        return torch.where(present > 0,
                           q.shape[1] / present.clamp(min=1) * accu,
                           float("nan"))
    out = torch.zeros(len(q), len(b), dtype=torch.float64, device=q.device)
    for j in range(q.shape[1]):
        x, y = q[:, j, None], b[None, :, j]
        if name == "Canberra":
            den = x.abs() + y.abs()
            out += torch.where(den > 0, (x - y).abs() / den, 0.0)
        elif name == "JensenShannon":          # x log x + y log y - s log m
            s = x + y
            out += 0.5 * (torch.xlogy(x, x) + torch.xlogy(y, y)
                          - torch.xlogy(s, s / 2))
        else:
            raise ValueError(f"no f64 evaluation of {name}")
    return out


def f64_topk(name, q, b, arg):
    """The f64 top-k of ``q`` over ``b`` (Jaccard: the largest), (D, I)
    as numpy."""
    P = torch.cat([f64_extra(name, q, b[i:i + 100_000], arg)
                   for i in range(0, len(b), 100_000)], 1)
    order = torch.sort(P, dim=1, descending=name == "Jaccard",
                       stable=True).indices[:, :K]
    return (torch.gather(P, 1, order).cpu().numpy(),
            order.cpu().numpy())


def breadth_metrics(xb, xq, dev) -> None:
    """18h: IndexFlat(128, m) over the first EXTRA_NB rows for the nine
    extra metrics, 256 queries; the ids of a selector run over the first
    100k rows, and of the timed search over all EXTRA_NB for EXTRA_NQ64
    queries, against an f64 evaluation written here (f64_extra)."""
    xb = xb[:EXTRA_NB]
    xs = xq[:EXTRA_NQ]
    rs = np.random.RandomState(20)
    out = {}
    for name, metric, arg, rtol in EXTRA:
        xbm, xsm = xb, xs
        if name == "NaNEuclidean":
            xbm, xsm = xb.copy(), xs.copy()
            xbm[rs.rand(*xbm.shape) < 0.01] = np.nan
            xsm[rs.rand(*xsm.shape) < 0.01] = np.nan
        idx = T.IndexFlat(D, metric, device=dev)
        idx.metric_arg = arg
        idx.add(xbm)
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        (Dv, Iv), s = timed(lambda: idx.search(xsm, K))
        peak = torch.cuda.max_memory_allocated()
        expect_launches(f"extra metric {name}", before, {})
        if not (Dv.shape == Iv.shape == (EXTRA_NQ, K) and
                (Iv >= 0).all()):
            raise AssertionError(f"extra metric {name}: malformed")
        q64 = torch.from_numpy(xsm).to(dev).double()
        b64 = torch.from_numpy(xbm).to(dev).double()
        # the timed search, its first EXTRA_NQ64 queries
        D64, I64 = f64_topk(name, q64[:EXTRA_NQ64], b64, arg)
        same_topk_within(f"extra metric {name} ({len(xb)} rows)", D64, I64,
                         Dv[:EXTRA_NQ64].astype(np.float64),
                         Iv[:EXTRA_NQ64], rtol)
        # the first 100k rows through a selector over all of them
        sel = T.SearchParameters(sel=T.IDSelectorRange(0, EXTRA_NB64))
        Dsel, Isel = idx.search(xsm, K, params=sel)
        D64, I64 = f64_topk(name, q64, b64[:EXTRA_NB64], arg)
        same_topk_within(f"extra metric {name} (selector, 100k rows)", D64,
                         I64, Dsel.astype(np.float64), Isel, rtol)
        del b64
        out[name] = {"qps": EXTRA_NQ / s, "peak_bytes": peak,
                     "search_ms": s * 1e3}
        del idx
        torch.cuda.empty_cache()
    phase("breadth_metrics", nb=len(xb), nq=EXTRA_NQ, f64_rows=EXTRA_NB64,
          f64_nq_1m=EXTRA_NQ64, metrics=out)


def breadth_phase(quant3, hidx, xb, xt, xq, gt, flat_rec, dev, tmp):
    """Phase 18: the index API breadth (PCA / OPQ chains, IDMap2, shards
    and replicas, autotune, the sliding window, ClusterManager, the extra
    metrics) at full width. Returns the K3 / K3-SQ8 launches of its paths
    (those of the indexes and plain versions they are held against left
    out) and K3 at d 64."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp = {}                             # comparison launches
    k3_d64 = breadth_transforms(quant3, xb, xt, xq, gt, flat_rec, dev, cmp)
    breadth_idmap(quant3, xb, xt, xq, gt, dev, tmp, cmp)
    breadth_tune(quant3, hidx, xb, xt, xq, gt, flat_rec, dev, cmp)
    breadth_metrics(xb, xq, dev)
    breadth_balance(hidx, xq, gt, dev)
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()
           if v != cmp.get(k, 0)}
    if set(got) != {"ivf_scan_fused", "ivf_scan_sq8"}:
        raise AssertionError(f"phase 18 launched {got}")
    phase("breadth", seconds=time.perf_counter() - t_phase, launches=got,
          comparison_launches=cmp)
    return got, k3_d64


# -- phase 19: the codecs -------------------------------------------------------

# queries of the table scan, flat RQ, polysemous, QINCo and lattice checks
CODEC_NQ = 1000
# LSQ's training rounds (the reference's default)
LSQ_TRAIN_ITERS = 8
# annealing steps a sub-quantizer of polysemous training (the reference's
# default is 20000: 32 sub-quantizers take ~2 min on the host at that; cut
# from 2500 to pay for phase 24: the checks do not depend on the ordering
# the annealing reaches)
POLY_ITERS = 1250
# rows of the QINCo code check on the host
QINCO_CPU_ROWS = 2000
# 19f's base: the first 125k rows (cut from 1M to pay for phase 23, then
# from 250k for phase 24)
QINCO_NB = 125_000
# rows the lattice encodes: its host encode of the 1M rows took 41.6 s on
# the H100 machine's host, over the 30 s the phase allows it (100k until
# phase 24)
LATTICE_NB = 50_000
# the additive coarse quantizers' codes: 2 stages of RCQ_BITS bits
RCQ_BITS = 8


def k3_check(name, lists, xw, probes, cmp) -> dict:
    """K3 (a bf16 stream) or K3-SQ8 (an SQ8 stream) against its plain
    version on one plan: the per-pair top-kp and the whole scan within
    rtol 1e-5, positions up to near-ties (float rows); CUDA-event ms, the
    plain version's ms, the bound (valid rows) and the padded blocks'
    bound beside it. Its launches go to ``cmp``."""
    def run():
        kp = F.default_kp(K)
        q16, qn = F.fold_queries(xw, lists, False)
        plan = F.plan_pairs(probes, lists)
        d1, p1 = F.scan_pairs(q16, qn, plan, lists, kp, False)
        d0, p0 = F.scan_pairs_reference(q16, qn, plan, lists, kp, False)
        err = assert_close_pairs(f"{name} per pair", d0, p0, d1, p1)
        D1, I1, _ = F.scan_invlists_fused(xw, probes, lists, K)
        D0, I0, _ = F.scan_invlists_fused_reference(xw, probes, lists, K)
        err_scan = assert_close_pairs(f"{name} scan", D0, I0, D1, I1)
        ms = cuda_ms(lambda: F.scan_pairs(q16, qn, plan, lists, kp, False),
                     10)
        plain = host_ms(lambda: F.scan_pairs_reference(q16, qn, plan, lists,
                                                       kp, False), 1)
        work = (plan, lists.ids, lists.block_size, xw.shape[1], kp, 0,
                lists.nblocks)
        eb = 1 if isinstance(lists, T.PackedInvListsSQ8) else 2
        return {"nq": len(xw), "nprobe": probes.shape[1], "kp": kp,
                "max_abs_err": err, "scan_max_abs_err": err_scan, "ms": ms,
                "plain_ms": plain,
                **bound(*pair_scan_work(*work, elem_bytes=eb)),
                "padded_bound_ms": bound(*pair_scan_work(
                    *work, elem_bytes=eb, padded=True))["bound_ms"]}
    return uncounted(run, cmp)


def residual_mse(idx, xt) -> float:
    """MSE of an IVF codec on the residuals of 20k training rows."""
    x = xt[:20000]
    a = torch.as_tensor(idx._assign(x)).to(idx.device)
    r = torch.from_numpy(x).to(idx.device) - idx._coarse_centroids()[a]
    rec = RQ.rq_decode(idx._encode_residuals(r), idx._books)
    return float(((r - rec) ** 2).sum(1).mean())


def ivf_codec(cls, shape, quant, xt, xb, ids, dev, **knobs):
    """An IVF additive index over ``quant`` (quantizer_trains_alone=1),
    trained on xt and holding xb; seconds of train and add."""
    idx = cls(quant, D, quant.ntotal, *shape, device=dev)
    idx.quantizer_trains_alone = 1
    for k, v in knobs.items():
        setattr(idx, k, v)
    (_, t_train) = timed(lambda: idx.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: idx.add_with_ids(xb, ids), warm=lambda: None)
    return idx, t_train, t_add


def codec_c(idx, xq, gt, dev) -> float:
    """C of an IVF codec: exact f32 over all its decoded rows."""
    f32 = idx._decode_lists(torch.float32)
    c = codec_recall_rows(rows_by_id(f32, NB, dev), xq, gt, dev)
    del f32
    return c


def codecs_ivf_rq(quant3, xb, xt, xq, gt, flat_rec, dev, cmp) -> tuple:
    """19a: IVF4096,RQ16x8 through its bf16 cache (K3), its "sq8" cache
    (K3-SQ8) and the table scan; the kernels held against their plain
    versions on this cache. Returns (the index, its residual MSE, the K3
    and K3-SQ8 records)."""
    ids = np.arange(NB, dtype=np.int64)
    A, t_train, t_add = ivf_codec(T.IndexIVFResidualQuantizer, (16, 8),
                                  quant3, xt, xb, ids, dev)
    mse = residual_mse(A, xt)
    C = codec_c(A, xq, gt, dev)
    floors = {n: C * flat_rec[n] - 0.01 for n in (16, 32, 64)}
    (cache, t_cache) = timed(A._decoded_cache, warm=lambda: None)
    res_a = pq_searches(A, xq, gt, "IVF-RQ bf16 cache",
                        {"ivf_scan_fused": 1}, floors=floors)
    p32 = T.SearchParametersIVF(nprobe=32)
    Dv, Iv = A.search(xq, K, params=p32)
    Ds, Is, _ = A.search_stats(xq, K, params=p32)
    Dp, Ip = A.search_preassigned(xq, K, A.coarse_assign(xq, 32))
    for what, other in (("search_stats", (Ds, Is)),
                        ("search_preassigned", (Dp, Ip))):
        if not (np.array_equal(other[0], Dv) and
                np.array_equal(other[1], Iv)):
            raise AssertionError(f"IVF-RQ {what} differs from search")
    xw = torch.from_numpy(xq).to(dev)
    _, probes = A._coarse_search_device(xw, 32)
    k3 = k3_check("K3 on the IVF-RQ cache", cache, xw, probes, cmp)
    rec_small = T.recall_k_at_k(A.search(xq[:CODEC_NQ], K, params=p32)[1],
                                gt[:CODEC_NQ], K)
    phase("codecs_ivf_rq", train_s=t_train, add_s=t_add, residual_mse=mse,
          codec_recall=C, cache_build_s=t_cache,
          cache_bytes=cache_bytes(cache), code_bytes=A.invlists.codes.nbytes,
          searches=res_a, stats_preassigned_equal=True, k3=k3)
    del cache
    # the "sq8" cache: K3-SQ8, within 0.01 of the bf16 cache's recall
    A.decoded_cache_dtype = "sq8"
    A._lists_changed()
    (c8, t_c8) = timed(A._decoded_cache, warm=lambda: None)
    res_b = pq_searches(A, xq, gt, "IVF-RQ sq8 cache", {"ivf_scan_sq8": 1})
    for n, r in res_b.items():
        if abs(r["recall_at_10"] - res_a[n]["recall_at_10"]) > 0.01:
            raise AssertionError(f"IVF-RQ sq8 cache nprobe={n}: recall "
                                 f"{r['recall_at_10']} vs the bf16 cache's "
                                 f"{res_a[n]['recall_at_10']}")
    k3sq8 = k3_check("K3-SQ8 on the IVF-RQ sq8 cache", c8, xw, probes, cmp)
    phase("codecs_ivf_rq_sq8", cache_build_s=t_c8, cache_bytes=cache_bytes(c8),
          searches=res_b, k3_sq8=k3sq8)
    del c8
    # the table scan (no cache), 1000 queries at nprobe 32
    A.use_decoded_cache = False
    A._lists_changed()
    res_c = pq_searches(A, xq[:CODEC_NQ], gt[:CODEC_NQ], "IVF-RQ table scan",
                        {}, nprobes=(32,), floors={32: rec_small - 0.01})
    phase("codecs_ivf_rq_table", searches=res_c,
          bf16_cache_recall_same_queries=rec_small)
    A.use_decoded_cache = None
    A.decoded_cache_dtype = "bfloat16"
    A._lists_changed()
    return A, mse, k3, k3sq8


def codecs_ivf_others(quant3, xb, xt, xq, gt, flat_rec, rq_mse, dev) -> None:
    """19b: IVF4096,LSQ16x8 / PRQ2x8x8 / PLSQ2x8x8: train / encode seconds,
    residual MSE, C and recall@10 at nprobe 32 through the bf16 cache."""
    ids = np.arange(NB, dtype=np.int64)
    out = {}
    for name, cls, shape in (
            ("LSQ16x8", T.IndexIVFLocalSearchQuantizer, (16, 8)),
            ("PRQ2x8x8", T.IndexIVFProductResidualQuantizer, (2, 8, 8)),
            ("PLSQ2x8x8", T.IndexIVFProductLocalSearchQuantizer, (2, 8, 8))):
        knobs = {"train_iters": LSQ_TRAIN_ITERS} if "LSQ" in name else {}
        idx, t_train, t_add = ivf_codec(cls, shape, quant3, xt, xb, ids, dev,
                                        **knobs)
        mse = residual_mse(idx, xt)
        C = codec_c(idx, xq, gt, dev)
        floor = C * flat_rec[32] - 0.01
        res = pq_searches(idx, xq, gt, f"IVF-{name}", {"ivf_scan_fused": 1},
                          nprobes=(32,), floors={32: floor})
        out[name] = {"train_s": t_train, "add_s": t_add, "residual_mse": mse,
                     "codec_recall": C, **res[32], **knobs}
        if name == "LSQ16x8" and mse > rq_mse:
            raise AssertionError(f"LSQ16x8 residual MSE {mse} > RQ16x8's "
                                 f"{rq_mse}")
        del idx
        torch.cuda.empty_cache()
    phase("codecs_ivf_aq", rq16x8_residual_mse=rq_mse, codecs=out)


def codecs_rcq(xb, xt, xq, gt, dev, cmp):
    """19c: IVF65536(RCQ2x8),Flat (the beam route, and the exact
    enumeration of its 65,536 centroids) and IVF65536(LSCQ2x8),Flat (exact
    enumeration): coarse fidelity, quantization_us, recall@10, and K3 on
    the 1-2-block lists at 10k q, nprobe 64. Returns (the RCQ quantizer,
    K3's record)."""
    out, k3 = {}, None
    xw = torch.from_numpy(xq).to(dev)
    keep = None
    for kind in ("RCQ", "LSCQ"):
        nlist = 1 << (2 * RCQ_BITS)
        idx = T.index_factory(D, f"IVF{nlist}({kind}2x{RCQ_BITS}),Flat",
                              device=dev)
        (_, t_train) = timed(lambda: idx.train(xt), warm=lambda: None)
        (_, t_add) = timed(lambda: idx.add(xb), warm=lambda: None)
        q = idx.quantizer
        cents = q.reconstruct_device(torch.arange(nlist, device=dev))
        r = {"nlist": nlist, "train_s": t_train, "add_s": t_add,
             "list_blocks_max": idx._longest_list_blocks(),
             "mean_rows_a_list": NB / nlist}
        modes = (("beam", 4.0), ("exact", -1.0)) if kind == "RCQ" else \
            (("exact", -1.0),)
        for mode, bf in modes:
            q.beam_factor = bf
            for nprobe in (64, 256):
                p = T.SearchParametersIVF(nprobe=nprobe)
                _, exact = TD.knn(xw, cents, nprobe)
                (_, I), s = timed(lambda: idx.search(xq, K, params=p))
                _, _, st = idx.search_stats(xq, K, params=p)
                probes = idx.coarse_assign(xq, nprobe)
                ex = exact.cpu().numpy()
                fid = float(np.mean([len(set(a) & set(b)) / nprobe
                                     for a, b in zip(ex, probes)]))
                r[f"{mode}_nprobe{nprobe}"] = {
                    "recall_at_10": T.recall_k_at_k(I, gt, K),
                    "qps": NQ / s, "quantization_us": st.quantization_us,
                    "list_scan_us": st.list_scan_us, "coarse_fidelity": fid}
                if mode == "exact" and fid < 0.999:
                    raise AssertionError(f"{kind} exact enumeration "
                                         f"fidelity {fid}")
        if kind == "RCQ":
            for nprobe in (64, 256):
                b, e = (r[f"{m}_nprobe{nprobe}"]["recall_at_10"]
                        for m in ("beam", "exact"))
                if b < e - 0.02:
                    raise AssertionError(f"RCQ beam recall {b} vs the "
                                         f"enumeration's {e}")
            q.beam_factor = 4.0
            _, probes = idx._coarse_search_device(xw, 64)
            k3 = k3_check("K3 on the 65536-list RCQ lists", idx.invlists,
                          xw, probes, cmp)
            r["k3"] = k3
            keep = q
        out[kind] = r
        del idx, cents
        torch.cuda.empty_cache()
    phase("codecs_rcq", **out)
    return keep, k3


def codecs_flat_rq(xb, xt, xq, gt, dev):
    """19d: the flat IndexResidualQuantizer RQ16x8 over 1M rows: recall on
    1000 queries within 0.002 of C, the sa_encode / sa_decode round trip,
    range_search on 100 queries against brute force on the decoded rows."""
    R = T.IndexResidualQuantizer(D, 16, 8, device=dev)
    (_, t_train) = timed(lambda: R.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: R.add(xb), warm=lambda: None)
    rows = RQ.rq_decode(R._codes, R._books)
    xs, gs = xq[:CODEC_NQ], gt[:CODEC_NQ]
    C = codec_recall_rows(rows, xs, gs, dev)
    (_, Iv), s = timed(lambda: R.search(xs, K))
    rec = T.recall_k_at_k(Iv, gs, K)
    if abs(rec - C) > 0.002:
        raise AssertionError(f"flat RQ recall {rec} vs C {C}")
    codes = R.sa_encode(xb[:CODEC_NQ])
    want = RQ.with_norms(R._codes[:CODEC_NQ],
                         rows[:CODEC_NQ]).cpu().numpy()
    if not np.array_equal(codes, want):
        raise AssertionError("flat RQ sa_encode differs from the stored "
                             "codes")
    if not np.array_equal(R.sa_decode(codes), rows[:CODEC_NQ].cpu().numpy()):
        raise AssertionError("flat RQ sa_decode differs from the decode")
    xr = xq[:100]
    qd = torch.from_numpy(xr).to(dev)
    dis = torch.cdist(qd.double(), rows.double()) ** 2
    radius = float(torch.sort(dis, dim=1).values[:, 20].median())
    lims, Dr, Ir = R.range_search(xr, radius)
    for qi in range(len(xr)):
        got = set(Ir[lims[qi]:lims[qi + 1]].tolist())
        sure = set(torch.nonzero(dis[qi] < radius * (1 - 1e-5))[:, 0]
                   .tolist())
        maybe = set(torch.nonzero(dis[qi] < radius * (1 + 1e-5))[:, 0]
                    .tolist())
        if not sure <= got <= maybe:
            raise AssertionError(f"flat RQ range query {qi}: hits differ "
                                 "from brute force")
    phase("codecs_flat_rq", train_s=t_train, add_s=t_add, codec_recall=C,
          recall_at_10=rec, qps=len(xs) / s, sa_round_trip=True,
          range_radius=radius, range_hits=int(lims[-1]))
    return R


def codecs_polysemous(xb, xt, xq, gt, dev) -> None:
    """19e: IndexPQ PQ32 with polysemous training: ST_POLYSEMOUS with the
    filter off equals ST_PQ's table scan bit for bit; at three thresholds
    the pass share, recall@10, QPS and QPS over ST_PQ's (above 1 at the
    ~1% share: only the pairs that pass are scored); every distance is
    ST_PQ's ADC distance of its id."""
    P = T.IndexPQ(D, 32, 8, device=dev)
    P.do_polysemous_training = True
    P.polysemous_iters = POLY_ITERS
    P.use_decoded_cache = False
    (_, t_train) = timed(lambda: P.train(xt), warm=lambda: None)
    P.add(xb)
    xs, gs = xq[:CODEC_NQ], gt[:CODEC_NQ]
    (D_pq, I_pq), s_pq = timed(lambda: P.search(xs, K), 3)
    P.search_type = P.ST_POLYSEMOUS
    D0, I0 = P.search(xs, K)
    if not (np.array_equal(D0, D_pq) and np.array_equal(I0, I_pq)):
        raise AssertionError("ST_POLYSEMOUS with the filter off differs "
                             "from ST_PQ")
    # thresholds at Hamming quantiles of a sample of (query, code) pairs;
    # the card's distances (an f16 product of bits) equal the host's
    qc = PQ.pq_encode(torch.from_numpy(xs[:100]).to(dev), P._cent)
    ham = HM.hamming_distances(qc, P._codes[:100_000])
    if not torch.equal(ham.cpu(), HM.hamming_distances(
            qc.cpu(), P._codes[:100_000].cpu())):
        raise AssertionError("Hamming distances on the card differ from "
                             "the host's")
    ham = ham.float().view(-1)
    hts = [int(torch.quantile(ham, f)) for f in (0.01, 0.05, 0.3)]
    lut = PQ.query_tables(torch.from_numpy(xs).to(dev), P._cent)
    out, last = {}, 0
    for ht in hts:
        P.polysemous_ht = ht
        (Dv, Iv), s = timed(lambda: P.search(xs, K), 3)
        share = P.last_hamming_pass / (len(xs) * NB)
        if P.last_hamming_pass <= last:
            raise AssertionError(f"polysemous ht {ht}: pass count "
                                 f"{P.last_hamming_pass} <= {last}")
        last = P.last_hamming_pass
        # ST_PQ's ADC of each returned id, its sub-quantizers added in
        # adc_scan_db's order
        ok = Iv >= 0
        cl = P._codes[torch.from_numpy(np.maximum(Iv, 0)).to(dev)].long()
        adc = torch.zeros(Iv.shape, device=dev)
        for m in range(P.M):
            adc += torch.gather(lut[:, m, :], 1, cl[:, :, m])
        if not np.array_equal(adc.cpu().numpy()[ok], Dv[ok]):
            raise AssertionError(f"polysemous ht {ht}: distances differ "
                                 "from ST_PQ's ADC")
        out[ht] = {"pass_share": share, "recall_at_10":
                   T.recall_k_at_k(Iv, gs, K), "qps": len(xs) / s,
                   "qps_over_st_pq": s_pq / s}
    # the filter must save the ADC of what it rejects: at the ~1% share
    # the search beats ST_PQ's dense scan
    if out[hts[0]]["qps_over_st_pq"] <= 1.0:
        raise AssertionError(f"polysemous at a {out[hts[0]]['pass_share']} "
                             f"pass share is no faster than ST_PQ: "
                             f"{out[hts[0]]['qps']} vs {len(xs) / s_pq} QPS")
    phase("codecs_polysemous", M=32, nbits=8, polysemous_iters=POLY_ITERS,
          anneal_train_s=t_train, st_pq_qps=len(xs) / s_pq,
          st_pq_recall_at_10=T.recall_k_at_k(I_pq, gs, K),
          filter_off_equal=True, thresholds=out)


def codecs_qinco(xb, xq, gt, dev):
    """19f: IndexQINCo(d 128, K 256, L 2, M 8, h 256) with the reference's
    random weights: encode the first QINCO_NB rows, decode, search 1000
    queries (recall against the exact ground truth of those rows); the
    card's codes on 2000 rows against the host's; the state dict round
    trip. Returns the index."""
    xb = xb[:QINCO_NB]
    Qi = T.IndexQINCo(D, 256, 2, 8, 256, device=dev)
    (_, t_enc) = timed(lambda: Qi.add(xb), warm=lambda: None)
    (rows, t_dec) = timed(lambda: Qi._decode_packed(Qi._codes),
                          warm=lambda: None)
    xs = xq[:CODEC_NQ]
    gs = gt[:CODEC_NQ] if len(xb) == NB else TD.knn(
        torch.from_numpy(xs).to(dev), torch.from_numpy(xb).to(dev),
        K)[1].cpu().numpy()
    (Dv, Iv), s = timed(lambda: Qi.search(xs, K))
    C = codec_recall_rows(rows, xs, gs, dev)
    if not (np.isfinite(Dv).all() and (Iv >= 0).all()):
        raise AssertionError("QINCo search: malformed")
    rec = T.recall_k_at_k(Iv, gs, K)
    if abs(rec - C) > 0.002:
        raise AssertionError(f"QINCo recall {rec} vs C {C}")
    del rows
    cpu_net = T.QINCo.random(D, 256, 2, 8, 256)
    host = QC.encode_chunked(cpu_net, xb[:QINCO_CPU_ROWS]).numpy()
    card = QC.encode_chunked(Qi.qinco, xb[:QINCO_CPU_ROWS]).cpu().numpy()
    same = float((host == card).all(1).mean())
    if same < 0.995:
        raise AssertionError(f"QINCo codes: card equals host on {same}")
    other = T.QINCo(D, 256, 2, 8, 256).to(dev)
    other.load_state_dict(Qi.qinco.state_dict())
    if not all(torch.equal(a, b) for a, b in zip(
            other.state_dict().values(), Qi.qinco.state_dict().values())):
        raise AssertionError("QINCo state dict round trip differs")
    phase("codecs_qinco", K=256, L=2, M=8, h=256, code_bytes=Qi.sa_code_size(),
          nb=len(xb), encode_s=t_enc, encode_rows_a_s=len(xb) / t_enc,
          decode_s=t_dec,
          codec_recall=C, recall_at_10=rec, qps=len(xs) / s,
          card_equals_host_rows=same, state_dict_round_trip=True)
    return Qi


def codecs_lattice(xb, xq, dev):
    """19g: ZnLattice16x10_6 (IndexLattice, dsq 8, r2 10) over LATTICE_NB
    rows: the host encode, then the search, exact f32 over the decoded
    rows: recall@10 against the exact neighbours among those rows equal to
    C up to ties. Returns the index."""
    Lt = T.index_factory(D, "ZnLattice16x10_6", device=dev)
    Lt.train(xb[:LATTICE_NB])
    (_, t_enc) = timed(lambda: Lt.add(xb[:LATTICE_NB]), warm=lambda: None)
    xs = xq[:CODEC_NQ]
    qd = torch.from_numpy(xs).to(dev)
    _, g = TD.knn(qd, torch.from_numpy(xb[:LATTICE_NB]).to(dev), K)
    gs = g.cpu().numpy()
    rows = Lt._decode_packed(Lt._codes)
    C = codec_recall_rows(rows, xs, gs, dev)
    (Dv, Iv), s = timed(lambda: Lt.search(xs, K))
    rec = T.recall_k_at_k(Iv, gs, K)
    if abs(rec - C) > 0.002:
        raise AssertionError(f"lattice recall {rec} vs C {C}")
    phase("codecs_lattice", nsq=16, r2=10, scale_nbit=6, rows=LATTICE_NB,
          nv=Lt.zn.nv, code_bytes=Lt.sa_code_size(), encode_s=t_enc,
          encode_rows_a_s=LATTICE_NB / t_enc, codec_recall=C,
          recall_at_10=rec, qps=len(xs) / s)
    return Lt


def codecs_files(named, xq, dev, tmp) -> None:
    """19h: each index written (IxRQ, IwRQ, IxCQ, IxQN, IxLt) and reopened
    with mmap returns the original's (D, I) bit for bit."""
    xs = xq[:CODEC_NQ]
    out = {}
    for tag, idx in named.items():
        path = os.path.join(tmp, f"codec_{tag}.tann")
        (_, t_w) = timed(lambda: T.write_index(idx, path), warm=lambda: None)
        (other, t_r) = timed(lambda: T.read_index(path, mmap=True,
                                                   device=dev),
                             warm=lambda: None)
        if IIO._read_container(path)[0]["tag"] != tag:
            raise AssertionError(f"{tag}: the file's tag differs")
        a, b = idx.search(xs, K), other.search(xs, K)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"{tag}: the reopened index's search "
                                 "differs")
        out[tag] = {"file_bytes": os.path.getsize(path), "write_s": t_w,
                    "read_mmap_s": t_r}
        del other
        os.remove(path)
    phase("codecs_files", bit_equal=True, files=out)


def codecs_phase(quant3, xb, xt, xq, gt, flat_rec, dev, tmp):
    """Phase 19: the codecs at full width on phase 3's data and quantizer:
    the IVF additive codes (K3, K3-SQ8), the RCQ / LSCQ coarse quantizers
    over 65,536 lists (K3), flat RQ, polysemous PQ, QINCo, the lattice and
    their files. Returns the K3 / K3-SQ8 launches of its paths (the
    comparison launches left out) and the kernels' records."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp = {}
    A, rq_mse, k3_rq, k3sq8_rq = codecs_ivf_rq(quant3, xb, xt, xq, gt,
                                               flat_rec, dev, cmp)
    codecs_ivf_others(quant3, xb, xt, xq, gt, flat_rec, rq_mse, dev)
    rcq, k3_rcq = codecs_rcq(xb, xt, xq, gt, dev, cmp)
    R = codecs_flat_rq(xb, xt, xq, gt, dev)
    codecs_polysemous(xb, xt, xq, gt, dev)
    Qi = codecs_qinco(xb, xq, gt, dev)
    Lt = codecs_lattice(xb, xq, dev)
    codecs_files({"IxRQ": R, "IwRQ": A, "IxCQ": rcq, "IxQN": Qi,
                  "IxLt": Lt}, xq, dev, tmp)
    del A, R, Qi, Lt, rcq
    torch.cuda.empty_cache()
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()
           if v != cmp.get(k, 0)}
    if set(got) != {"ivf_scan_fused", "ivf_scan_sq8"}:
        raise AssertionError(f"phase 19 launched {got}")
    phase("codecs", seconds=time.perf_counter() - t_phase, launches=got,
          comparison_launches=cmp)
    return got, {"k3_rq": k3_rq, "k3sq8_rq": k3sq8_rq, "k3_rcq": k3_rcq}


def codecs_alone() -> None:
    """--phase19: phase 19 alone, as the whole run drives it: K3 and K3-SQ8
    built, phase 3's data, ground truth and IVF4096,Flat (its quantizer,
    and its recalls at nprobe 16 / 32 / 64 for the floors), then
    codecs_phase. Its phase lines only: no kernels line, no ok line."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused", "ivf_scan_sq8"))
    quant3, xb, xt, xq, gt, rec = phase3_setup(dev)
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        codecs_phase(quant3, xb, xt, xq, gt, rec, dev, tmp)


# -- phase 20: the index families ------------------------------------------

# queries of the bit-for-bit checks of phase 20
FAM_NQ = 1000
# rows of the binary families (20a-e), with LSH's ground truth recomputed
# over them: 250k, cut from 1M to pay for phase 22 (they took 48-49 s of
# phase 20 at 1M)
FAM_NB = 250_000
# rows of the Flat NSG, with the ground truth recomputed over them: 100k
# (250k paid for phase 21, 1M before it; NN-descent took 76-90 s at 1M,
# 16.6 s at 250k)
NSG_NB = 100_000
# rows of the NN-descent index and the coded NSGs (100k before phase 22)
NSG_CODED_NB = 50_000
LSH_BITS = 256
# tie-aware recall@10 floor of IndexBinaryFromFloat's fused route (K1's
# lane-min reservoir drops one of two best rows that share a lane; ties
# at the k-th Hamming distance usually fill the slot): no reference value
FROM_FLOAT_FLOOR = 0.99


def expect_kernels(name, got: dict, want: set) -> dict:
    """``got`` (launches by kernel) if it launched exactly the kernels
    ``want``, else raise."""
    if set(got) != want:
        raise AssertionError(f"{name} launched {got}, expected {want}")
    return got


def popcount_table_dists(cq, codes, chunk: int = 8192):
    """(nq, nb) int32 Hamming distances of codes ``cq`` to ``codes`` by a
    second exact route: the XOR's bytes looked up in a 256-entry popcount
    table, in database chunks."""
    table = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int32, device=cq.device)
    out = torch.empty((len(cq), len(codes)), dtype=torch.int32,
                      device=cq.device)
    for b0 in range(0, len(codes), chunk):
        x = torch.bitwise_xor(cq[:, None, :], codes[None, b0:b0 + chunk])
        out[:, b0:b0 + chunk] = table[x.int()].sum(-1, dtype=torch.int32)
    return out


def binary_recall(Iv, cq, codes, kth) -> float:
    """Tie-aware recall@k of binary results: a returned id counts when its
    Hamming distance is at most the exact k-th distance ``kth`` (nq,)."""
    I = torch.as_tensor(np.asarray(Iv), device=codes.device)
    dis = HM.hamming_rows(cq[:, None, :], codes[I.clamp(min=0)])
    ok = (I >= 0) & (dis <= kth[:, None])
    return float(ok.float().mean())


def qps_of(fn, nq: int, reps: int = 2):
    """(fn()'s result, queries a second: nq over the median wall time)."""
    out, t = timed(fn, reps)
    return out, nq / t


def families_binary(xb, xt, xq, gt, dev, cmp, files) -> dict:
    """20a-e, over the first FAM_NB rows: LSH256rt codes, IndexBinaryFlat
    and IndexBinaryFromFloat (K1 + K2 on 0/1 rows), BIVF4096 (and
    _HNSW32), BHNSW32 (K3 on 256-wide bf16 tiles), BHash16 / BHash8x16.
    Returns the K1 and K3 records at d 256."""
    nbits = LSH_BITS
    xb = xb[:FAM_NB]
    if FAM_NB < NB:
        flat = T.IndexFlat(D, device=dev)
        flat.add(xb)
        gt = flat.search(xq, K)[1]
        del flat
    # (a) the codes
    lsh = T.IndexLSH(D, nbits, rotate_data=True, train_thresholds=True,
                     device=dev)
    (_, t_train) = timed(lambda: lsh.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: lsh.add(xb), warm=lambda: None)
    codes = lsh._bin.codes
    cq = lsh.encode_device(xq)
    ct = lsh.encode_device(xt)
    (res, lsh_qps) = qps_of(lambda: lsh.search(xq, K), NQ)
    lsh_rec = T.recall_k_at_k(res[1], gt, K)
    cpu = T.IndexLSH(D, nbits, True, True, device="cpu")
    cpu.thresholds = lsh.thresholds
    same = float((cpu.sa_encode(xb[:10000]) ==
                  codes[:10000].cpu().numpy()).all(1).mean())
    if same < 0.995:
        raise AssertionError(f"LSH: the card's codes equal the host's on "
                             f"{same} of 10k rows (< 0.995)")
    bflat = T.IndexBinaryFlat(nbits, device=dev)
    bflat.add(codes)
    (gtb, flat_qps) = qps_of(lambda: bflat.search_device(cq, K), NQ)
    Db, Ib = (t.cpu().numpy() for t in gtb)
    kth = gtb[0][:, K - 1]
    phase("families_lsh", nb=len(xb), train_s=t_train, add_s=t_add,
          encode_rows_per_s=len(xb) / t_add, recall_at_10=lsh_rec,
          qps=lsh_qps, card_equals_host=same)
    files.update(IxLs=lsh, BxFl=bflat)

    # (b) the flat index against a second exact route, its range search,
    # and IndexBinaryFromFloat through K1 + K2
    ref = popcount_table_dists(cq[:FAM_NQ], codes)
    d_ref = torch.sort(ref, dim=1).values[:, :K]
    assert_equal("IndexBinaryFlat vs the popcount table", d_ref,
                 gtb[0][:FAM_NQ])
    radius = int(np.median(Db[:100, K - 1]))
    lims, rd, ri = bflat.range_search(cq[:100], radius)
    hq, hi = torch.nonzero(ref[:100] < radius, as_tuple=True)
    if not (np.array_equal(ri, hi.cpu().numpy()) and np.array_equal(
            np.diff(lims), torch.bincount(hq, minlength=100).cpu().numpy())
            and np.array_equal(rd, ref[:100][hq, hi].cpu().numpy())):
        raise AssertionError("IndexBinaryFlat.range_search differs from "
                             "brute force")
    del ref
    fl = T.IndexFlat(nbits, device=dev)
    fl.scan_mode = "fused"
    bff = T.IndexBinaryFromFloat(fl)
    bff.add(codes)
    before = counts()
    (out_ff, ff_qps) = qps_of(lambda: bff.search(cq, K), NQ)
    got = expect_kernels("IndexBinaryFromFloat", launched(before),
                         {"flat_knn_fused", "reservoir_topk"})
    # the reservoir keeps one row a lane (K1), so two of a query's best
    # rows that share a lane lose one: the route's scores are exact, its
    # selection is not (recall floor FROM_FLOAT_FLOOR)
    If = torch.as_tensor(out_ff[1], device=dev)
    d_ff = HM.hamming_rows(cq[:, None, :], codes[If.clamp(min=0)])
    if not np.array_equal(d_ff.cpu().numpy(), out_ff[0]):
        raise AssertionError("IndexBinaryFromFloat returned a distance "
                             "that is not its id's Hamming distance")
    ff_rec = binary_recall(out_ff[1], cq, codes, kth)
    ff_rows = float((out_ff[0] == Db).all(1).mean())
    if ff_rec < FROM_FLOAT_FLOOR:
        raise AssertionError(f"IndexBinaryFromFloat recall {ff_rec} < "
                             f"{FROM_FLOAT_FLOOR}")
    data, bias = fl._fused_packed
    xw = HM.unpack_bits(cq[:1024])
    qv = torch.zeros((len(xw), data.shape[-1]), device=dev)
    qv[:, :nbits] = -2.0 * xw
    qv = qv.to(torch.bfloat16)

    def k1():
        v1, p1 = FK.flat_reservoir(qv, data, bias, 2048)
        v0, p0 = FK.flat_reservoir_reference(qv, data, bias, 2048)
        assert_equal("K1 at d 256 values", v0, v1)
        assert_equal("K1 at d 256 positions", p0, p1)
        return {"d256_ms": cuda_ms(
                    lambda: FK.flat_reservoir(qv, data, bias, 2048), 5),
                "d256_plain_ms": host_ms(
                    lambda: FK.flat_reservoir_reference(qv, data, bias,
                                                        2048), 2),
                "d256_max_abs_err": max_abs_err(v0, v1),
                **{f"d256_{k}": v for k, v in bound(
                    data.numel() * 2 + bias.numel() * 4 + qv.numel() * 2
                    + v1.numel() * 8,
                    2.0 * len(qv) * bff.ntotal * nbits).items()}}
    k1_rec = uncounted(k1, cmp)
    phase("families_flat", flat_qps=flat_qps, from_float_qps=ff_qps,
          table_route_equal=True, range_radius=radius,
          range_hits=int(lims[-1]), range_equal=True,
          from_float_launches=got, from_float_distances_exact=True,
          from_float_recall=ff_rec, from_float_rows_equal_flat=ff_rows,
          k1=k1_rec)
    files["BxFF"] = bff

    # (c) BIVF4096, then its HNSW32 quantizer
    bivf = T.IndexBinaryIVF(None, nbits, NLIST, device=dev)
    (_, t_btrain) = timed(lambda: bivf.train(ct), warm=lambda: None)
    (_, t_badd) = timed(lambda: (bivf.add(codes), bivf._ready()),
                        warm=lambda: None)
    ivf_rec = {}
    for nprobe in (16, 32, 64):
        bivf.nprobe = nprobe
        (res, qps) = qps_of(lambda: bivf.search(cq, K), NQ)
        ivf_rec[nprobe] = {"recall": binary_recall(res[1], cq, codes, kth),
                           "qps": qps}
    bivf.nprobe = NLIST
    Dall, _ = bivf.search(cq[:FAM_NQ], K)
    if not np.array_equal(Dall, Db[:FAM_NQ]):
        raise AssertionError("BIVF4096 at nprobe 4096 differs from the "
                             "flat index")
    r = [ivf_rec[n]["recall"] for n in (16, 32, 64)]
    if not r[0] <= r[1] <= r[2]:
        raise AssertionError(f"BIVF4096 recall falls with nprobe: {r}")
    bivf.nprobe = 32
    bh = T.IndexBinaryIVF(T.IndexBinaryHNSW(nbits, 32, device=dev), nbits,
                          NLIST, device=dev)
    bh.quantizer.add(bivf.quantizer.codes)
    bh.is_trained = True
    bh.nprobe = 32
    bh.add(codes)
    (res, bh_qps) = qps_of(lambda: bh.search(cq, K), NQ)
    pf, ph = bivf._probes(cq), bh._probes(cq)
    share = float((pf[:, :, None] == ph[:, None, :]).any(2).float().mean())
    phase("families_bivf", train_s=t_btrain, add_s=t_badd,
          by_nprobe=ivf_rec, nprobe4096_equal=True, hnsw32_probe_share=share,
          hnsw32_recall=binary_recall(res[1], cq, codes, kth),
          hnsw32_qps=bh_qps)
    files["BwFl"] = bivf
    del bh

    # (d) BHNSW32 over the codes, its fused tiles through K3 at d 256
    bhn = T.IndexBinaryHNSW(nbits, 32, device=dev)
    (_, t_build) = timed(lambda: bhn.add(codes), warm=lambda: None)
    hn = {}
    for ef in (64, 128):
        p = T.SearchParametersHNSW(efSearch=ef)
        before = counts()
        (res, qps) = qps_of(lambda: bhn.search(cq, K, params=p), NQ)
        hn[ef] = {"recall": binary_recall(res[1], cq, codes, kth),
                  "qps": qps, "launches": expect_kernels(
                      "BHNSW32", launched(before), {"ivf_scan_fused"})}
    ftg = bhn.index._tiles_fused
    if ftg.il.data_bf16.shape[-1] != nbits:
        raise AssertionError("BHNSW32's tiles are not 256 wide")
    _, probes = TD.knn(xw, ftg.cent, 32)
    k3_rec = k3_check("K3 on the 256-wide binary tiles", ftg.il, xw, probes,
                      cmp)
    phase("families_bhnsw", build_s=t_build, by_efsearch=hn, k3=k3_rec)
    files["BxHN"] = bhn

    # (e) the hash tables
    hashes = {}
    for spec in ("BHash16", "BHash8x16"):
        idx = T.index_binary_factory(nbits, spec, device=dev)
        idx.add(codes)
        prev, out = None, {}
        for nflip in (0, 1, 2):
            idx.nflip = nflip
            (res, qps) = qps_of(lambda: idx.search_stats(cq, K), NQ)
            Dh, Ih, st = res
            I = torch.as_tensor(Ih, device=dev)
            dh = HM.hamming_rows(cq[:, None, :], codes[I.clamp(min=0)])
            if not np.array_equal(np.where(Ih >= 0, dh.cpu().numpy(),
                                           32767), Dh):
                raise AssertionError(f"{spec}: a returned distance differs "
                                     "from the flat index's")
            keys = torch.cat([(q + q0) * NB + ids for q0, _, q, ids, _ in
                              idx._candidates(cq[:FAM_NQ])])
            if prev is not None and not bool(torch.isin(prev, keys).all()):
                raise AssertionError(f"{spec}: nflip {nflip}'s candidates "
                                     "do not hold nflip - 1's")
            prev = keys
            out[nflip] = {"candidates": st.ndis, "qps": qps,
                          "recall": binary_recall(Ih, cq, codes, kth)}
        c = [out[f]["candidates"] for f in (0, 1, 2)]
        if not c[0] < c[1] < c[2]:
            raise AssertionError(f"{spec}: candidates do not grow: {c}")
        hashes[spec] = out
        files["BxHs" if spec == "BHash16" else "BxMH"] = idx
    phase("families_hash", by_nflip=hashes, distances_equal=True,
          candidates_nested=True)
    return {"k1_d256": k1_rec, "k3_d256": k3_rec}


def nsg_recall_sample(knn_graph, xb_dev, nsample: int = 10_000) -> float:
    """Recall of an NN-descent graph (``IndexNSGFlat.build``'s) against
    the exact GK nearest rows of a sample of rows."""
    rs = np.random.RandomState(0)
    rows = torch.from_numpy(rs.choice(len(xb_dev), min(nsample, len(xb_dev)),
                                      replace=False)).to(xb_dev.device)
    gk = knn_graph.shape[1]
    _, ex = TD.knn(xb_dev[rows], xb_dev, gk + 1)
    ex = ex[:, 1:]
    g = knn_graph[rows].long()
    return float((g[:, :, None] == ex[:, None, :]).any(2).float().mean())


def families_nsg(xb, xt, xq, gt, dev, cmp, files) -> None:
    """20f: NSG32,Flat over NSG_NB rows (its build steps, the NN-descent
    graph's recall on a sample, the reachable share, recall and QPS by
    efSearch, the card's beam against the CPU's), then at NSG_CODED_NB
    rows IndexNNDescentFlat(K 32), NSG32,PQ32 and NSG32,SQ8, each coded
    one equal to an IndexNSGFlat over its decoded rows."""
    rows = xb[:NSG_NB]
    gt_n = gt
    if NSG_NB < NB:
        flat = T.IndexFlat(D, device=dev)
        flat.add(rows)
        gt_n = flat.search(xq, K)[1]
        del flat
    nsg = T.index_factory(D, "NSG32,Flat", device=dev)
    knn_g = nsg.build(rows)
    xb_dev = nsg.storage.vectors
    knn_rec = nsg_recall_sample(knn_g, xb_dev)
    del knn_g
    reach = ND.reachable_share(nsg.graph, nsg.medoid)
    by_ef, recs = {}, []
    for ef in (16, 32, 64, 128):
        p = T.SearchParametersHNSW(efSearch=ef)
        (res, qps) = qps_of(lambda: nsg.search(xq, K, params=p), NQ)
        by_ef[ef] = {"recall": T.recall_k_at_k(res[1], gt_n, K), "qps": qps}
        recs.append(by_ef[ef]["recall"])
    if recs != sorted(recs):
        raise AssertionError(f"NSG recall falls with efSearch: {recs}")
    q200 = torch.from_numpy(xq[:200]).to(dev)
    Dg, Ig = nsg.search_device(q200, K)
    Dc, Ic, _ = HN.beam_search_level0(
        xb_dev.cpu(), nsg.graph.cpu(), q200.cpu(),
        torch.full((200, 1), nsg.medoid, dtype=torch.int32),
        ef=max(nsg.efSearch, K), k=K)
    same_topk_within("NSG beam card vs CPU", Dc.numpy(), Ic.long().numpy(),
                     Dg.cpu().numpy(), Ig.cpu().numpy(), 1e-5)
    phase("families_nsg", nb=len(rows), gk=nsg.GK, r=nsg.R,
          nn_descent_s=nsg.build_seconds["nn_descent"],
          prune_s=nsg.build_seconds["prune"], knn_graph_recall=knn_rec,
          reachable_share=reach, by_efsearch=by_ef, card_equals_cpu=True)
    files["IxNS"] = nsg

    sub, out = xb[:NSG_CODED_NB], {}
    flat = T.IndexFlat(D, device=dev)
    flat.add(sub)
    gt_s = flat.search(xq[:FAM_NQ], K)[1]
    del flat
    nnd = T.IndexNNDescentFlat(D, 32, device=dev)
    (_, t_nnd) = timed(lambda: nnd.add(sub), warm=lambda: None)
    nnd.efSearch = 64
    (res, qps) = qps_of(lambda: nnd.search(xq[:FAM_NQ], K), FAM_NQ)
    out["nndescent"] = {"build_s": t_nnd, "qps": qps,
                        "recall": T.recall_k_at_k(res[1], gt_s, K)}
    files["IxND"] = nnd
    for spec, tag in (("NSG32,PQ32", "IxNP"), ("NSG32,SQ8", "IxNQ")):
        idx = T.index_factory(D, spec, device=dev)
        idx.train(xt)
        (_, t_add) = timed(lambda: idx.add(sub), warm=lambda: None)
        twin = T.IndexNSGFlat(D, 32, device=dev)
        twin.add(idx.storage.vectors)
        idx.efSearch = twin.efSearch = 64
        a, b = idx.search(xq[:FAM_NQ], K), twin.search(xq[:FAM_NQ], K)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"{spec} differs from an NSG over its "
                                 "decoded rows")
        out[spec] = {"add_s": t_add, "recall": T.recall_k_at_k(a[1], gt_s,
                                                                K)}
        files[tag] = idx
    phase("families_nsg_coded", nb=NSG_CODED_NB, by_index=out,
          decoded_twin_equal=True)


def families_ivf(quant3, xb, xt, xq, gt, flat_rec, dev, files) -> None:
    """20g: IndexIVFSpectralHash(nbit 128) over phase 3's quantizer at
    period 10 and 100, thresholds global / centroid / median; its entry
    points equal and a half selector equal to a search of the kept rows;
    IndexIVFIndependentQuantizer (phase 3's quantizer, PCA64, an
    IVF4096,Flat payload: K3 at d 64) against C x IVF-Flat - 0.01."""
    out = {}
    for period in (10.0, 100.0):
        for tt in ("global", "centroid", "median"):
            idx = T.IndexIVFSpectralHash(quant3, D, NLIST, 128, period,
                                         device=dev)
            idx.quantizer_trains_alone = 1
            idx.threshold_type = tt
            idx.train(xt)
            (_, t_add) = timed(lambda: idx.add(xb), warm=lambda: None)
            rec = {}
            for nprobe in (16, 32, 64):
                p = T.SearchParametersIVF(nprobe=nprobe)
                (res, qps) = qps_of(lambda: idx.search(xq, K, params=p), NQ)
                rec[nprobe] = {"recall": T.recall_k_at_k(res[1], gt, K),
                               "qps": qps}
            out[f"p{period:g}_{tt}"] = {"add_s": t_add, "by_nprobe": rec}
            if period == 10.0 and tt == "global":
                sh = idx
            else:
                del idx
    xs = xq[:FAM_NQ]
    p = T.SearchParametersIVF(nprobe=32)
    a = sh.search(xs, K, params=p)
    b = sh.search_stats(xs, K, params=p)[:2]
    c = sh.search_preassigned(xs, K, sh.coarse_assign(xs, 32))
    for name, o in (("search_stats", b), ("search_preassigned", c)):
        if not (np.array_equal(a[0], o[0]) and np.array_equal(a[1], o[1])):
            raise AssertionError(f"spectral hash: {name} differs from "
                                 "search")
    half = NB // 2
    sel = T.SearchParametersIVF(nprobe=32, sel=T.IDSelectorRange(0, half))
    a = sh.search(xs, K, params=sel)
    kept = T.IndexIVFSpectralHash(quant3, D, NLIST, 128, device=dev)
    kept.quantizer_trains_alone = 1
    kept.vt, kept.trained, kept.is_trained = sh.vt, sh.trained, True
    kept.add(xb[:half])
    b = kept.search(xs, K, params=p)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError("spectral hash: the half selector differs from "
                             "a search of the kept rows")
    del kept
    files["IwSH"] = sh

    pca = T.PCAMatrix(D, 64, device=dev)
    payload = T.IndexIVFFlat(T.IndexFlat(64, device=dev), 64, NLIST,
                             device=dev)
    iq = T.IndexIVFIndependentQuantizer(quant3, payload, pca)
    (_, t_train) = timed(lambda: iq.train(xt), warm=lambda: None)
    (_, t_add) = timed(lambda: iq.add(xb), warm=lambda: None)
    fl = T.IndexFlat(64, device=dev)
    fl.add(pca.apply(xb))
    C = T.recall_k_at_k(fl.search(pca.apply(xq), K)[1], gt, K)
    del fl
    rec = {}
    for nprobe in (16, 32, 64):
        iq.nprobe = nprobe
        before = counts()
        (res, qps) = qps_of(lambda: iq.search(xq, K), NQ)
        got = expect_kernels("the independent quantizer", launched(before),
                             {"ivf_scan_fused"})
        r = T.recall_k_at_k(res[1], gt, K)
        rec[nprobe] = {"recall": r, "qps": qps, "launches": got,
                       "floor": C * flat_rec[nprobe] - 0.01}
        if r < rec[nprobe]["floor"]:
            raise AssertionError(f"independent quantizer recall {r} < "
                                 f"{rec[nprobe]['floor']} at {nprobe}")
    iq.nprobe = 32
    phase("families_ivf", spectral_hash=out, entry_points_equal=True,
          selector_equal=True, independent={"train_s": t_train,
                                            "add_s": t_add, "C": C,
                                            "by_nprobe": rec})
    files["IwIQ"] = iq


def families_extra(xb, xt, xq, dev, files) -> None:
    """20h: IndexRowwiseMinMax over IVF4096,SQ8 (K3-SQ8), the IMI at 1M
    cells against the enumeration, IndexSplitVectors against
    IndexFlat(128)."""
    mm = T.IndexRowwiseMinMax(T.IndexIVFScalarQuantizer(
        T.IndexFlat(D, device=dev), D, NLIST, T.QT_8BIT, device=dev))
    mm.train(xt)
    mm.add(xb)
    xn_b, _, _ = mm._normalize(xb)
    xn_q = mm._normalize(xq)[0]
    fl = T.IndexFlat(D, device=dev)
    fl.add(xn_b)
    gt_n = fl.search(xn_q, K)[1]
    del fl
    rec = {}
    for nprobe in (16, 32, 64):
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = counts()
        (res, qps) = qps_of(lambda: mm.search(xq, K, params=p), NQ)
        expect_kernels("RowwiseMinMax", launched(before), {"ivf_scan_sq8"})
        rec[nprobe] = {"recall": T.recall_k_at_k(res[1], gt_n, K),
                       "qps": qps}
    mm.index.nprobe = 32
    sq = mm.index.sq
    worst = 0.0
    for key in (0, 1, NB // 2, NB - 1):
        err = np.abs(mm.reconstruct(key) - xb[key])
        step = float(mm._scales[key]) * sq.vdiff / 256.0
        worst = max(worst, float((err / step).max()))
    if worst > 1.0 + 1e-4:
        raise AssertionError(f"RowwiseMinMax reconstruct off by {worst} "
                             "SQ8 steps")
    files["IxMM"] = mm

    imi = T.MultiIndexQuantizer(D, 2, 10, device=dev)
    (_, t_imi) = timed(lambda: imi.train(xt), warm=lambda: None)
    (res, imi_qps) = qps_of(lambda: imi.search(xq, 64), NQ)
    worst_rel = 0.0
    for q0 in range(0, NQ, 500):
        tabs = imi.tables(xq[q0:q0 + 500])
        full = (tabs[:, 0, :, None] + tabs[:, 1, None, :]).reshape(
            len(tabs), -1)
        ref = torch.topk(full, 64, dim=1, largest=False).values.cpu().numpy()
        got = res[0][q0:q0 + 500]
        worst_rel = max(worst_rel, float(np.max(
            np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30))))
    if worst_rel > 1e-5:
        raise AssertionError(f"IMI differs from the enumeration: {worst_rel}")
    files["IxMI"] = imi

    sub = xb[:100_000]
    sv = T.IndexSplitVectors(D, device=dev)
    for _ in range(2):
        sv.add_sub_index(T.IndexFlat(64, device=dev))
    sv.add(sub)
    fl = T.IndexFlat(D, device=dev)
    fl.add(sub)
    (a, sv_qps) = qps_of(lambda: sv.search(xq[:FAM_NQ], K), FAM_NQ)
    b = fl.search(xq[:FAM_NQ], K)
    same_topk_within("IndexSplitVectors vs IndexFlat", b[0], b[1], a[0],
                     a[1], 1e-5)
    files["IxSV"] = sv
    files["IxRn"] = T.IndexRandom(D, NB, device=dev)
    phase("families_extra", minmax={"by_nprobe": rec,
                                    "reconstruct_steps": worst},
          imi={"train_s": t_imi, "cells": imi.ntotal, "qps_k64": imi_qps,
               "max_rel_err": worst_rel},
          split_vectors={"qps": sv_qps, "equal": True})


def families_files(files, xq, cq, dev, tmp) -> None:
    """20i: each of the 17 tags written and reopened with mmap returns the
    original's (D, I) bit for bit on FAM_NQ queries."""
    out = {}
    for tag, idx in sorted(files.items()):
        path = os.path.join(tmp, f"fam_{tag}.tann")
        q = cq[:FAM_NQ].cpu().numpy() if tag.startswith("B") \
            else xq[:FAM_NQ]
        (_, t_w) = timed(lambda: T.write_index(idx, path), warm=lambda: None)
        (other, t_r) = timed(lambda: T.read_index(path, mmap=True,
                                                   device=dev),
                             warm=lambda: None)
        if IIO._read_container(path)[0]["tag"] != tag:
            raise AssertionError(f"{tag}: the file's tag differs")
        if hasattr(idx, "hnsw"):
            other.hnsw.__dict__.update(idx.hnsw.__dict__)
        if tag == "BxFF":         # the fused scan's opt-in is not stored
            other.index.scan_mode = idx.index.scan_mode
        for name in ("nprobe", "efSearch"):
            if hasattr(idx, name):
                setattr(other, name, getattr(idx, name))
        a, b = idx.search(q, K), other.search(q, K)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"{tag}: the reopened index's search "
                                 "differs")
        out[tag] = {"file_bytes": os.path.getsize(path), "write_s": t_w,
                    "read_mmap_s": t_r}
        del other
        os.remove(path)
    if len(out) != 17:
        raise AssertionError(f"phase 20 wrote {len(out)} of the 17 tags")
    phase("families_files", bit_equal=True, files=out)


def families_phase(quant3, xb, xt, xq, gt, flat_rec, dev, tmp):
    """Phase 20: the index families at full width on phase 3's data and
    quantizer. Returns the launches of its paths (the comparison launches
    left out) and the K1 / K3 records at d 256."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp, files = {}, {}
    recs = families_binary(xb, xt, xq, gt, dev, cmp, files)
    t_bin = time.perf_counter() - t_phase
    families_nsg(xb, xt, xq, gt, dev, cmp, files)
    families_ivf(quant3, xb, xt, xq, gt, flat_rec, dev, files)
    families_extra(xb, xt, xq, dev, files)
    cq = files["IxLs"].encode_device(xq[:FAM_NQ])
    families_files(files, xq, cq, dev, tmp)
    files.clear()
    torch.cuda.empty_cache()
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()
           if v != cmp.get(k, 0)}
    expect_kernels("phase 20", got, {"ivf_scan_fused", "ivf_scan_sq8",
                                     "flat_knn_fused", "reservoir_topk"})
    phase("families", seconds=time.perf_counter() - t_phase,
          binary_s=t_bin, launches=got, comparison_launches=cmp)
    return got, recs


def families_alone() -> None:
    """--phase20: phase 20 alone, as the whole run drives it: K1, K2, K3
    and K3-SQ8 built, phase 3's data, ground truth and IVF4096,Flat (its
    quantizer and recalls at nprobe 16 / 32 / 64), then families_phase.
    Its phase lines only: no kernels line, no ok line."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused", "ivf_scan_sq8",
                            "flat_knn_fused", "reservoir_topk"))
    quant3, xb, xt, xq, gt, rec = phase3_setup(dev)
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        families_phase(quant3, xb, xt, xq, gt, rec, dev, tmp)


# -- phase 21: the sharded path on torch.distributed --------------------------

# the sizes of phase 21, handed to the ranks of 21b: the probes of the
# scans, the queries of the exact k-NN / PQ / refine checks, the PQ
# candidates a query that sharded_refine re-ranks to k, the queries of
# the timed K3 launch (rank 0's replica rows), the k-means (centroids,
# iterations, over the NT training rows) and the seconds the 4-rank world
# may take before it is killed
SHARD = {"k": K, "nprobe": 32, "nq_exact": 1024, "R": 40,
         "timed_nq": 5000, "km_k": 4096, "km_iters": 10, "timeout_s": 300}
# the ranks of 21b: 2 shards x 2 replicas
SHARD_MESH = (2, 2)


def save_pq32(idx, tmp) -> None:
    """Phase 16's IVF4096,PQ32 (``idx``, its rows added under ids 0..n-1)
    for phase 21: its codes by row id, each row's list and its codebooks,
    as .npy files in ``tmp``."""
    from tpu_ann_torch.ops import ivf_scan

    idx._maybe_repack()
    il = idx.invlists
    ids = il.ids.reshape(-1).long()
    valid = ids >= 0
    n = int(valid.sum())
    cw = il.codes.shape[-1]
    codes = torch.zeros((n, cw), dtype=torch.uint8, device=ids.device)
    codes[ids[valid]] = il.codes.reshape(-1, cw)[valid]
    lists = ivf_scan.block_lists(il).repeat_interleave(il.block_size)
    assign = torch.zeros(n, dtype=torch.long, device=ids.device)
    assign[ids[valid]] = lists.to(ids.device)[valid]
    np.save(os.path.join(tmp, "shard_pq_codes.npy"), codes.cpu().numpy())
    np.save(os.path.join(tmp, "shard_pq_assign.npy"), assign.cpu().numpy())
    np.save(os.path.join(tmp, "shard_pq_books.npy"),
            np.asarray(idx.pq.centroids, np.float32))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_load(tmp, name):
    return np.load(os.path.join(tmp, f"shard_{name}.npy"), mmap_mode="r")


def shard_rank(rank, world, port, tmp, device, cfg) -> None:
    """One rank of phase 21b (spawned): joins the gloo world, packs its
    shard's half of the rows (global ids) under phase 3's quantizer and of
    phase 16's PQ32 codes, runs every sharded function on ``device`` and
    writes its results to shard_rank<r>.npz in ``tmp`` (a failure: its
    traceback to shard_rank<r>.err, exit 1)."""
    import traceback

    import torch.distributed as dist

    from tpu_ann_torch import parallel as PAR
    from tpu_ann_torch.ops import ivf_scan

    try:
        torch.set_num_threads(2)
        dev = torch.device(device)
        PAR.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                 backend="gloo", timeout_s=cfg["timeout_s"])
        mesh = PAR.make_mesh(*SHARD_MESH, device=dev)
        xb, xt = shard_load(tmp, "xb"), np.array(shard_load(tmp, "xt"))
        nb, nlist, k = len(xb), len(shard_load(tmp, "cent")), cfg["k"]
        half = nb // mesh.n_shards
        lo, hi = mesh.shard * half, (mesh.shard + 1) * half
        ids = np.arange(lo, hi)
        il = ivf_scan.pack_invlists(np.array(xb[lo:hi]), ids,
                                    shard_load(tmp, "assign")[lo:hi], nlist,
                                    device=dev)
        xb_l = torch.from_numpy(np.array(xb[lo:hi])).to(dev)
        cent = torch.from_numpy(np.array(shard_load(tmp, "cent"))).to(dev)
        xq = torch.from_numpy(np.array(shard_load(tmp, "xq"))).to(dev)
        _, probes = TD.knn(xq, cent, cfg["nprobe"])
        ne = cfg["nq_exact"]
        pil = ivf_scan.pack_code_invlists(
            np.array(shard_load(tmp, "pq_codes")[lo:hi]), ids,
            shard_load(tmp, "pq_assign")[lo:hi], nlist, device=dev)
        books = np.array(shard_load(tmp, "pq_books"))
        secs, out = {}, {}

        def run(name, fn):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            res = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs[name] = time.perf_counter() - t0
            return res

        reset_counts()
        out["Df"], out["If"] = run("ivf_scan_fused", lambda: (
            PAR.sharded_ivf_scan(xq, probes, il, k,
                                 max_nblocks=il.max_nblocks_per_list,
                                 mesh=mesh, fused=True)))
        k3 = F.LAUNCHES
        out["Dp"], out["Ip"] = run("ivf_scan_plain", lambda: (
            PAR.sharded_ivf_scan(xq, probes, il, k,
                                 max_nblocks=il.max_nblocks_per_list,
                                 mesh=mesh)))
        out["Dk"], out["Ik"] = run("knn", lambda: PAR.sharded_knn(
            xq[:ne], xb_l, k, mesh=mesh))
        out["Dq"], out["Iq"] = run("ivf_scan_pq", lambda: (
            PAR.sharded_ivf_scan_pq(xq[:ne], probes[:ne], None, pil, books,
                                    cent, cfg["R"],
                                    max_nblocks=pil.max_nblocks_per_list,
                                    mesh=mesh)))
        out["Dr"], out["Ir"] = run("refine", lambda: PAR.sharded_refine(
            xq[:ne], out["Iq"], xb_l, k, mesh=mesh))
        km = run("kmeans_distributed", lambda: PAR.kmeans_distributed(
            xt, cfg["km_k"], mesh=mesh, niter=cfg["km_iters"]))
        obj = float(PAR.sharded_kmeans_iter(
            PAR.local_rows(xt, mesh, axis="world"), km, cfg["km_k"],
            mesh=mesh)[2])
        timed = {}
        if rank == 0 and dev.type == "cuda":
            # one K3 launch of this rank's scan: its replica's queries over
            # its shard's lists (not counted as a launch of the path)
            q = xq[:cfg["timed_nq"]]
            plan = F.plan_pairs(probes[:cfg["timed_nq"]], il)
            kp = F.default_kp(k)
            q16, qn = q.to(torch.bfloat16), TD.l2_norms(q)
            timed = {"nq": len(q), "ms": cuda_ms(
                lambda: F.scan_pairs(q16, qn, plan, il, kp, False), 10),
                **bound(*pair_scan_work(plan, il.ids, il.block_size,
                                        q.shape[1], kp, 0, il.nblocks))}
        np.savez(os.path.join(tmp, f"shard_rank{rank}.npz"),
                 **{n: t.cpu().numpy() for n, t in out.items()},
                 km=km, obj=obj, k3=k3,
                 info=json.dumps({"secs": secs, "k3_timed": timed,
                                  "shard": mesh.shard,
                                  "replica": mesh.replica}))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"shard_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def shard_world(tmp, dev, cfg) -> list:
    """Phase 21b's world: 4 ranks spawned (torch.multiprocessing, spawn),
    gloo, all on ``dev``, joined under cfg["timeout_s"]; a rank still
    running then is killed. Returns each rank's results."""
    import torch.multiprocessing as tmp_mp

    ctx = tmp_mp.get_context("spawn")
    world = SHARD_MESH[0] * SHARD_MESH[1]
    port = free_port()
    procs = [ctx.Process(target=shard_rank,
                         args=(r, world, port, tmp, str(dev), cfg))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + cfg["timeout_s"]
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = {r: open(os.path.join(tmp, f"shard_rank{r}.err")).read()[-3000:]
            for r in range(world)
            if os.path.exists(os.path.join(tmp, f"shard_rank{r}.err"))}
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * world:
        raise AssertionError(f"phase 21b's world failed: exit codes {codes}, "
                             f"killed {len(hung)}; {errs}")
    return [dict(np.load(os.path.join(tmp, f"shard_rank{r}.npz")))
            for r in range(world)]


def sharded_phase(quant3, xb, xt, xq, gt, flat_rec, dev, tmp) -> dict:
    """Phase 21: tpu_ann_torch.parallel at full width on phase 3's data and
    quantizer. (a) World size 1 (NCCL on the card): sharded_ivf_scan's
    fused route (K3) equal to scan_invlists_fused over the same lists bit
    for bit, sharded_knn over the whole base equal to the exact ground
    truth, and the PQ scan and k-means that (b) is held to. (b) World size
    4 (2 shards x 2 replicas, gloo, every rank on the same device): fused
    (K3 on every rank) equal to the plain sharded route, recall@10 at the
    IVF floor, sharded_knn equal to the ground truth, sharded_ivf_scan_pq
    equal to (a)'s, sharded_refine of its candidates equal to a
    one-process exact re-rank, kmeans_distributed's objective within 1e-4
    of (a)'s. Returns K3's launches and its time on one rank."""
    import torch.distributed as dist

    from tpu_ann_torch import parallel as PAR
    from tpu_ann_torch.models.refine import _rerank
    from tpu_ann_torch.ops import ivf_scan

    t_phase = time.perf_counter()
    cfg = SHARD
    k, ne = cfg["k"], cfg["nq_exact"]
    one = int(dev.type == "cuda")     # K3 launches a fused call (0: plain)
    cent = quant3.vectors.float()
    xb_dev = torch.from_numpy(xb).to(dev)
    assign = TD.knn(xb_dev, cent, 1)[1][:, 0].cpu().numpy()
    for name, a in (("xb", xb), ("xq", xq), ("xt", xt),
                    ("cent", cent.cpu().numpy()), ("assign", assign)):
        np.save(os.path.join(tmp, f"shard_{name}.npy"), a)
    xq_dev = torch.from_numpy(xq).to(dev)
    _, probes = TD.knn(xq_dev, cent, cfg["nprobe"])
    Dg, Ig = (t.cpu().numpy() for t in TD.knn(xq_dev[:ne], xb_dev, k))
    assert_same_topk(Dg, gt[:ne], Dg, Ig)       # phase 3's, up to ties
    t_setup = time.perf_counter() - t_phase

    # -- 21a. world size 1 ---------------------------------------------------
    t0 = time.perf_counter()
    PAR.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl" if dev.type == "cuda"
                             else "gloo")
    try:
        mesh = PAR.make_mesh(1, 1, device=dev)
        il = ivf_scan.pack_invlists(xb, np.arange(len(xb)), assign,
                                    len(cent), device=dev)
        D3, I3, _ = F.scan_invlists_fused(xq_dev, probes, il, k)
        before = F.LAUNCHES
        D1, I1 = PAR.sharded_ivf_scan(xq_dev, probes, il, k,
                                      max_nblocks=il.max_nblocks_per_list,
                                      mesh=mesh, fused=True)
        k3_world1 = F.LAUNCHES - before
        if k3_world1 != one:
            raise AssertionError(f"21a: {k3_world1} K3 launches")
        if not (torch.equal(D1, D3) and torch.equal(I1, I3)):
            raise AssertionError("21a: the sharded fused scan differs from "
                                 "scan_invlists_fused")
        del il
        Dk, Ik = PAR.sharded_knn(xq_dev[:ne], xb_dev, k, mesh=mesh)
        assert_same_topk(Dg, Ig, Dk.cpu().numpy(), Ik.cpu().numpy())
        books = np.load(os.path.join(tmp, "shard_pq_books.npy"))
        pil = ivf_scan.pack_code_invlists(
            np.load(os.path.join(tmp, "shard_pq_codes.npy")),
            np.arange(len(xb)),
            np.load(os.path.join(tmp, "shard_pq_assign.npy")), len(cent),
            device=dev)
        Dq1, Iq1 = (t.cpu().numpy() for t in PAR.sharded_ivf_scan_pq(
            xq_dev[:ne], probes[:ne], None, pil, books, cent, cfg["R"],
            max_nblocks=pil.max_nblocks_per_list, mesh=mesh))
        del pil
        km1 = PAR.kmeans_distributed(xt, cfg["km_k"], mesh=mesh,
                                     niter=cfg["km_iters"])
        obj1 = float(PAR.sharded_kmeans_iter(xt, km1, cfg["km_k"],
                                             mesh=mesh)[2])
    finally:
        dist.destroy_process_group()
    t_world1 = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 21b. world size 4 ---------------------------------------------------
    t0 = time.perf_counter()
    ranks = shard_world(tmp, dev, cfg)
    t_world4 = time.perf_counter() - t0
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for name in ("Df", "If", "Dp", "Ip", "Dk", "Ik", "Dq", "Iq", "Dr",
                     "Ir", "km", "obj"):
            if not np.array_equal(res[name], r0[name]):
                raise AssertionError(f"21b: rank {r}'s {name} differs from "
                                     f"rank 0's")
    launches = [int(res["k3"]) for res in ranks]
    if launches != [one] * len(ranks):
        raise AssertionError(f"21b: K3 launches by rank {launches}")
    assert_same_topk(r0["Dp"], r0["Ip"], r0["Df"], r0["If"])
    rec = T.recall_k_at_k(r0["If"], gt, k)
    want = max(RECALL_FLOORS[cfg["nprobe"]], flat_rec[cfg["nprobe"]] - 0.001)
    if rec < want:
        raise AssertionError(f"21b: recall@10 {rec} < {want}")
    assert_same_topk(Dg, Ig, r0["Dk"], r0["Ik"])
    assert_same_topk(Dq1, Iq1, r0["Dq"], r0["Iq"])
    cand = torch.from_numpy(r0["Iq"]).to(dev)
    De, Ie = _rerank(xq_dev[:ne], cand, xb_dev[cand.clamp(min=0)], k,
                     TD.METRIC_L2, diff=True)
    assert_same_topk(De.cpu().numpy(), Ie.cpu().numpy(), r0["Dr"], r0["Ir"])
    obj_rel = abs(float(r0["obj"]) - obj1) / abs(obj1)
    if obj_rel > 1e-4:
        raise AssertionError(f"21b: k-means objective {float(r0['obj'])} vs "
                             f"world size 1's {obj1}")
    info = [json.loads(str(res["info"])) for res in ranks]
    timed = info[0]["k3_timed"]
    phase("sharded", seconds=time.perf_counter() - t_phase, setup_s=t_setup,
          world1_s=t_world1, world4_s=t_world4, mesh=list(SHARD_MESH),
          nq=len(xq), nprobe=cfg["nprobe"], recall_at_10=rec,
          unsharded_recall_at_10=flat_rec[cfg["nprobe"]],
          fused_equal_plain=True, world1_equal_k3=True, knn_exact=True,
          pq_equal_world1=True, refine_equal_exact=True,
          kmeans_obj=float(r0["obj"]), kmeans_obj_world1=obj1,
          kmeans_obj_rel=obj_rel,
          k3_launches={"world1": k3_world1, "by_rank": launches},
          seconds_by_rank=[i["secs"] for i in info],
          coords_by_rank=[(i["replica"], i["shard"]) for i in info],
          k3_one_rank=timed)
    return {"launches_sharded": k3_world1 + sum(launches),
            "sharded_ms": timed.get("ms"),
            "sharded_bound_ms": timed.get("bound_ms"),
            "sharded_bound_by": timed.get("bound_by")}


def sharded_alone() -> None:
    """--phase21: phase 21 alone: K3 built, phase 3's data, ground truth
    and IVF4096,Flat, an IVF4096,PQ32 over its quantizer as phase 16a
    builds it, then sharded_phase. Its phase lines only."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused",))
    quant3, xb, xt, xq, gt, rec = phase3_setup(dev)
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        A = ivf_pq_over(quant3, 32, 8, xt, xb, np.arange(NB), dev)[0]
        save_pq32(A, tmp)
        del A
        torch.cuda.empty_cache()
        sharded_phase(quant3, xb, xt, xq, gt, rec, dev, tmp)


# -- phase 22: the tooling and serving layer ----------------------------------

# phase 22's sizes: the database chunks of knn_ground_truth, the columns of
# the kmin table, big_batch_search's batch and depth, the queries of its
# plain-route check, the nprobe of every search, the first-level cells of
# the two-level clustering, the recall@10 it may lose against phase 3's,
# and how far index_memory_bytes may be from the allocator's growth
TOOL = {"gt_chunk": 100_000, "kmin_cols": 2048, "batch": 2048, "depth": 3,
        "plain_nq": 1024, "nprobe": 32, "nc1": 64, "two_level_loss": 0.03,
        "mem_rtol": 0.10}


def index_memory(index, mem0) -> dict:
    """The memory record of phase 3's IVF: the growth of the device's
    allocated bytes since ``mem0`` (taken before its train and add) and
    index_memory_bytes of the index."""
    from tpu_ann_torch.utils.memory import index_memory_bytes

    torch.cuda.synchronize()
    return {"allocated_growth": torch.cuda.memory_allocated() - mem0,
            "index_memory_bytes": index_memory_bytes(index)}


def expect_k3(name, before, want) -> int:
    got = launched(before).get("ivf_scan_fused", 0)
    if got != want:
        raise AssertionError(f"{name}: {got} K3 launches, expected {want}")
    return got


def tooling_truth(xb, xq, gt, dev) -> None:
    """22a: knn_ground_truth over 100k-row chunks against phase 3's exact
    ground truth (its distances recomputed exactly: integer data), and
    kmin against a stable sort."""
    from tpu_ann_torch.utils import contrib as C

    t0 = time.perf_counter()
    step = TOOL["gt_chunk"]
    Dg, Ig = C.knn_ground_truth(
        xq, (xb[i:i + step] for i in range(0, len(xb), step)), K,
        device=dev)
    t_gt = time.perf_counter() - t0
    xq_dev = torch.from_numpy(xq).to(dev)
    xb_dev = torch.from_numpy(xb).to(dev)
    rows = xb_dev[torch.from_numpy(gt).to(dev)]
    D3 = ((xq_dev[:, None, :] - rows) ** 2).sum(-1).cpu().numpy()
    assert_same_topk(D3, gt, Dg, Ig)
    table = TD.pairwise_distances(
        xq_dev, xb_dev[:TOOL["kmin_cols"]]).cpu().numpy()
    del rows, xb_dev
    t0 = time.perf_counter()
    v, i = C.kmin(table, K, device=dev)
    t_kmin = time.perf_counter() - t0
    order = np.argsort(table, axis=1, kind="stable")[:, :K]
    if not (np.array_equal(i, order)
            and np.array_equal(v, np.take_along_axis(table, order, 1))):
        raise AssertionError("22a: kmin differs from a stable sort")
    ties = int((np.diff(np.take_along_axis(
        table, np.argsort(table, 1, kind="stable")[:, :K + 1], 1), axis=1)
        == 0).sum())
    phase("tooling_truth", nq=len(xq), nb=len(xb), chunk=step,
          ground_truth_s=t_gt, equal_phase3_truth=True,
          kmin_shape=list(table.shape), kmin_s=t_kmin,
          kmin_equal_stable_sort=True, kmin_ties_in_top=ties)


class PlainRoute:
    """An IVF's search_device with K3's plain version in place of the
    kernel (the coarse step, the plan and the merge are the index's)."""

    def __init__(self, index):
        self.index = index
        self._map_ids = index._map_ids
        self._check_input = index._check_input
        self._to_device = index._to_device

    def search_device(self, xq_dev, k):
        nprobe, _ = self.index._effective_params(None)
        _, probes = self.index._coarse_search_device(xq_dev, nprobe)
        Dv, Iv, _ = F.scan_invlists_fused_reference(
            xq_dev, probes, self.index.invlists, k, self.index.metric_type)
        return Dv, Iv


def tooling_batches(quant3, xb, xt, xq, gt, flat_rec, dev, tmp):
    """22b: big_batch_search over phase 3's lists. Returns (the index, its
    search's (D, I), K3 launches)."""
    from tpu_ann_torch.utils import contrib as C
    from tpu_ann_torch.utils.interrupt import (FunctionInterrupt,
                                               InterruptCallback,
                                               InterruptError)

    one = int(dev.type == "cuda")
    nprobe, bs, depth = TOOL["nprobe"], TOOL["batch"], TOOL["depth"]
    nbatch = -(-len(xq) // bs)
    before = counts()
    index = ivf_over(quant3, xb, np.arange(len(xb)), xt, dev=dev)
    index.nprobe = nprobe
    Ds, Is = index.search(xq, K)
    rec = T.recall_k_at_k(Is, gt, K)
    if rec != flat_rec[nprobe]:
        raise AssertionError(f"22b: recall@10 {rec} of phase 3's lists, "
                             f"phase 3 had {flat_rec[nprobe]}")
    ck = os.path.join(tmp, "big_batch.pkl")
    polls = []
    InterruptCallback.set(FunctionInterrupt(
        lambda: polls.append(1) or len(polls) > 3))
    try:
        C.big_batch_search(index, xq, K, batch_size=bs, pipeline_depth=1,
                           checkpoint_path=ck, checkpoint_freq=1)
        raise AssertionError("22b: the interrupt did not stop the run")
    except InterruptError:
        pass
    finally:
        InterruptCallback.clear()
    with open(ck, "rb") as f:
        done = pickle.load(f)["done"].tolist()
    if done != [True, True] + [False] * (nbatch - 2):
        raise AssertionError(f"22b: checkpoint after the interrupt {done}")
    b1 = counts()
    t0 = time.perf_counter()
    Dr, Ir = C.big_batch_search(index, xq, K, batch_size=bs,
                                pipeline_depth=depth, checkpoint_path=ck)
    t_resume = time.perf_counter() - t0
    resumed = expect_k3("22b resume", b1, one * (nbatch - 2))
    b2 = counts()
    t0 = time.perf_counter()
    Du, Iu = C.big_batch_search(index, xq, K, batch_size=bs,
                                pipeline_depth=depth)
    t_full = time.perf_counter() - t0
    expect_k3("22b run", b2, one * nbatch)
    for name, (Dv, Iv) in (("resumed", (Dr, Ir)), ("run", (Du, Iu))):
        if not (np.array_equal(Dv, Ds) and np.array_equal(Iv, Is)):
            raise AssertionError(f"22b: the {name} big_batch_search "
                                 f"differs from index.search")
    npl = TOOL["plain_nq"]
    t0 = time.perf_counter()
    Dp, Ip = C.big_batch_search(PlainRoute(index), xq[:npl], K,
                                batch_size=bs, pipeline_depth=depth)
    t_plain = time.perf_counter() - t0
    assert_same_topk(Ds[:npl], Is[:npl], Dp, Ip)
    n = expect_k3("22b", before, one * (1 + 3 + (nbatch - 2) + nbatch))
    phase("tooling_batches", nq=len(xq), nprobe=nprobe, batch=bs,
          depth=depth, batches=nbatch, recall_at_10=rec,
          interrupted_at_poll=len(polls), done_at_interrupt=done,
          resumed_equal_search=True, run_equal_search=True,
          resume_s=t_resume, run_s=t_full, run_qps=len(xq) / t_full,
          k3_launches={"resume": resumed, "run": one * nbatch,
                       "phase": n},
          plain_route_nq=npl, plain_route_equal=True, plain_route_s=t_plain)
    return index, Ds, Is, n


def tooling_serving(quant3, xb, xt, xq, Ds, Is, dev) -> int:
    """22c: two SearchServers on localhost (500k rows each, global ids)
    behind a ClientIndex, against the one index's (D, I)."""
    import socket

    from tpu_ann_torch.utils import client_server as CS
    from tpu_ann_torch.utils import rpc

    one = int(dev.type == "cuda")
    nprobe, half = TOOL["nprobe"], len(xb) // 2
    t0 = time.perf_counter()
    shards = [ivf_over(quant3, xb[lo:lo + half], np.arange(lo, lo + half),
                       xt, dev=dev) for lo in (0, half)]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(300.0)
    servers, client = [], None
    try:
        for idx in shards:
            srv = rpc.Server(CS.SearchServer(idx), host="127.0.0.1")
            srv.serve_in_background()
            servers.append(srv)
        client = CS.ClientIndex([("127.0.0.1", s.port) for s in servers])
        client.set_nprobe(nprobe)
        before = counts()
        Dc, Ic = client.search(xq, K)
        assert_same_topk(Ds, Is, Dc, Ic)
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            client.search(xq, K)
            times.append(time.perf_counter() - t1)
        n = expect_k3("22c", before, one * 2 * (1 + TIMED_REPS))
        ntotal = client.ntotal
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.shutdown()
        socket.setdefaulttimeout(old)
    del shards, servers
    torch.cuda.empty_cache()
    med = float(np.median(times))
    phase("tooling_serving", servers=2, rows_each=half, ntotal=ntotal,
          nq=len(xq), nprobe=nprobe, equal_one_index=True,
          build_s=t_build, search_s=times, qps=len(xq) / med,
          k3_launches=n, k3_launches_a_search=2 * one)
    return n


def tooling_pipeline(data_dir, xb, xq, dev, tmp, cmp) -> int:
    """22d: the offline pipeline over the 1M rows in .npy files: 2 shards
    in worker processes on the card, the merged index against one add of
    all rows onto the same trained.tann, a second run that executes
    nothing, each step's seconds."""
    from tpu_ann_torch.utils.offline_pipeline import (OfflineIVFConfig,
                                                      OfflineIVFPipeline)

    one = int(dev.type == "cuda")
    cfg = OfflineIVFConfig(
        factory=f"IVF{NLIST},Flat", d=D, workdir=os.path.join(tmp, "offline"),
        xt_path=os.path.join(data_dir, "xt.npy"),
        xb_path=os.path.join(data_dir, "xb.npy"),
        xq_path=os.path.join(data_dir, "xq.npy"),
        gt_path=os.path.join(data_dir, "gt.npy"), nshard=2,
        use_subprocess=True, max_workers=2, device=str(dev), k=K,
        nprobe=TOOL["nprobe"])
    pipe = OfflineIVFPipeline(cfg)
    secs = {}

    def timed_step(name, fn):
        def run():
            t0 = time.perf_counter()
            fn()
            secs[name] = time.perf_counter() - t0
        return run

    jobs = pipe.jobs()
    for job in jobs:
        job.fn = timed_step(job.name, job.fn)
    before = counts()
    t0 = time.perf_counter()
    executed = pipe.runner.run(jobs)
    t_run = time.perf_counter() - t0
    if executed != ["train", "shard0", "shard1", "merge", "search"]:
        raise AssertionError(f"22d: the pipeline ran {executed}")
    n = expect_k3("22d", before, one)           # the search step
    with open(os.path.join(cfg.workdir, "config.json")) as f:
        if json.load(f)["device"] != str(dev):
            raise AssertionError("22d: config.json names another device")
    Dm = np.load(os.path.join(cfg.workdir, "search_D.npy"))
    Im = np.load(os.path.join(cfg.workdir, "search_I.npy"))
    t0 = time.perf_counter()
    single = IIO.read_index(pipe.trained_path, device=dev)
    single.add(xb)
    single.nprobe = TOOL["nprobe"]
    Do, Io = uncounted(lambda: single.search(xq, K), cmp)
    t_single = time.perf_counter() - t0
    del single
    if not (np.array_equal(Dm, Do) and np.array_equal(Im, Io)):
        raise AssertionError("22d: the merged index differs from one add")
    again = OfflineIVFPipeline(cfg).run()
    if again:
        raise AssertionError(f"22d: a second run executed {again}")
    nbytes = {f: os.path.getsize(os.path.join(cfg.workdir, f))
              for f in sorted(os.listdir(cfg.workdir))
              if f.endswith(".tann")}
    shutil.rmtree(cfg.workdir)
    torch.cuda.empty_cache()
    phase("tooling_pipeline", factory=cfg.factory, nb=len(xb), nshard=2,
          worker_processes=True, device=cfg.device, step_s=secs,
          run_s=t_run, single_add_and_search_s=t_single,
          merged_equal_single_add=True, second_run_executed=again,
          knn_intersection=cfg.search_result.get("knn_intersection"),
          file_bytes=nbytes, k3_launches=n)
    return n


def tooling_bench(data_dir, xq, dev) -> int:
    """22e: a bench_fw Benchmark of IVF4096,Flat at nprobe 16 / 32 / 64
    over local .npy descriptors, then a second benchmark() that reuses
    every cached artifact."""
    from tpu_ann_torch.utils import bench_fw as BF

    one = int(dev.type == "cuda")
    nprobes = [16, 32, 64]

    def bench():
        return BF.Benchmark(
            io=BF.BenchmarkIO(path=data_dir, device=dev),
            training_vectors=BF.DatasetDescriptor(tablename="xt"),
            database_vectors=BF.DatasetDescriptor(tablename="xb"),
            query_vectors=BF.DatasetDescriptor(tablename="xq"),
            index_descs=[BF.IndexDescriptor(
                d=D, factory=f"IVF{NLIST},Flat",
                search_params={"nprobe": nprobes})], k=K)

    bm = bench()
    name = bm.index_descs[0].get_name()
    before = counts()
    t0 = time.perf_counter()
    res = bm.benchmark()
    t_first = time.perf_counter() - t0
    n = expect_k3("22e", before, one * len(nprobes) * 4)
    rows = {p: res["experiments"][f"{name}knn.nprobe={p}"] for p in nprobes}
    for p, row in rows.items():
        if row["recall"] < RECALL_FLOORS[p]:
            raise AssertionError(f"22e: recall@10 {row['recall']} < "
                                 f"{RECALL_FLOORS[p]} at nprobe {p}")
    stamps = {f: os.path.getmtime(os.path.join(data_dir, f))
              for f in os.listdir(data_dir)}
    b2 = counts()
    t0 = time.perf_counter()
    res2 = bench().benchmark()
    t_second = time.perf_counter() - t0
    expect_k3("22e second run", b2, 0)
    if {f: os.path.getmtime(os.path.join(data_dir, f))
            for f in os.listdir(data_dir)} != stamps:
        raise AssertionError("22e: the second run wrote a file")
    if res2["experiments"] != res["experiments"]:
        raise AssertionError("22e: the second run's rows differ")
    meta = res["indices"][name]
    phase("tooling_bench", factory=f"IVF{NLIST},Flat", nq=len(xq),
          recall_at_10={p: r["recall"] for p, r in rows.items()},
          floors={p: RECALL_FLOORS[p] for p in nprobes},
          qps={p: r["qps"] for p, r in rows.items()},
          train_s=meta["train_time"], add_s=meta["add_time"],
          first_s=t_first, second_s=t_second, second_reused_all=True,
          optimal=[o["key"] for o in res["optimal"]], k3_launches=n)
    return n


def tooling_tools(index, xb, xt, xq, gt, flat_rec, mem3, dev, tmp) -> int:
    """22f: analyzers, two-level clustering, the memory and energy
    monitors, index_memory_bytes and the native host helpers."""
    from tpu_ann_torch.ops import ivf_scan
    from tpu_ann_torch.utils import analyzers as AN
    from tpu_ann_torch.utils import contrib as C
    from tpu_ann_torch.utils import memory as M
    from tpu_ann_torch.utils import native as NT
    from tpu_ann_torch.utils.datasets import fvecs_read, fvecs_write

    one = int(dev.type == "cuda")
    nprobe = TOOL["nprobe"]
    before = counts()
    t0 = time.perf_counter()
    report = AN.report(index, xq, gt, k=K, nprobe=nprobe)
    t_report = time.perf_counter() - t0
    att = AN.recall_attribution(index, xq, gt, K, nprobe)
    if abs(att["recall"] - flat_rec[nprobe]) > 1e-9:
        raise AssertionError(f"22f: the analyzers' recall {att['recall']} "
                             f"vs phase 3's {flat_rec[nprobe]}")
    cov = AN.probe_coverage(index, xq, nprobe)
    two = {}
    for mode, kw in (("rebalance", {"rebalance": True}),
                     ("batched", {"rebalance": False, "batched": True})):
        idx = T.make_ivf_flat(D, NLIST, device=dev)
        t0 = time.perf_counter()
        C.train_ivf_index_with_2level(idx, xt, nc1=TOOL["nc1"], **kw)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        idx.add(xb)
        idx.nprobe = nprobe
        rec = T.recall_k_at_k(idx.search(xq, K)[1], gt, K)
        del idx
        torch.cuda.empty_cache()
        floor = flat_rec[nprobe] - TOOL["two_level_loss"]
        two[mode] = {"train_s": t_train, "recall_at_10": rec,
                     "floor": floor}
        if rec < floor:
            raise AssertionError(f"22f: two-level ({mode}) recall@10 {rec} "
                                 f"< {floor}")
    with M.EnergyMonitor() as em:
        with M.MemoryMonitor(interval_s=0.01) as mon:
            mon.set_phase("search")
            index.search(xq, K)
    n = expect_k3("22f", before, one * 5)
    growth = mem3["allocated_growth"]
    counted = mem3["index_memory_bytes"]["total"]
    rel = abs(counted - growth) / max(growth, 1)
    if dev.type == "cuda" and rel > TOOL["mem_rtol"]:
        raise AssertionError(f"22f: index_memory_bytes {counted} vs the "
                             f"allocator's growth {growth}")
    if not NT.HAVE_NATIVE:
        raise AssertionError("22f: the native library did not build")
    fv = os.path.join(tmp, "xb.fvecs")
    fvecs_write(fv, xb)
    t0 = time.perf_counter()
    xr = NT.read_fvecs_native(fv)
    t_nat_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    xn = fvecs_read(fv)
    t_np_read = time.perf_counter() - t0
    os.remove(fv)
    if not (np.array_equal(xr, xb) and np.array_equal(xn, xb)):
        raise AssertionError("22f: read_fvecs_native differs from numpy")
    del xr, xn
    assign = index._assign(xb)
    ids = np.arange(len(xb))
    B = index.block_size
    t0 = time.perf_counter()
    nat = NT.pack_rows_native(xb, ids, assign, NLIST, B)
    t_nat_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    order, slot, starts, nblk, nbt = ivf_scan._block_slots(
        assign, NLIST, B, "pack")
    data = np.zeros((nbt + 1, B, D), np.float32)
    rid = np.full((nbt + 1, B), -1, np.int32)
    data.reshape(-1, D)[slot] = xb[order]
    rid.reshape(-1)[slot] = ids[order]
    t_np_pack = time.perf_counter() - t0
    for a, b in zip(nat, (data, rid, starts, nblk)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("22f: pack_rows_native differs from numpy")
    del nat, data, rid
    phase("tooling_tools", report=report.splitlines(),
          attribution={k: att[k] for k in ("recall", "routing_loss",
                                           "ranking_loss", "probed_frac")},
          coverage_mean=cov["mean_ratio"], report_s=t_report,
          two_level=two, nc1=TOOL["nc1"],
          memory_monitor={"samples": len(mon.samples),
                          "peak_device_bytes": mon.peak_hbm(),
                          "peak_rss_bytes": mon.peak_rss()},
          energy_watts=em.watts, energy_seconds=em.seconds,
          rapl=M.rapl_available(),
          index_memory_bytes=mem3["index_memory_bytes"],
          allocated_growth=growth, index_memory_rel=rel,
          native=True, read_fvecs_s={"native": t_nat_read,
                                     "numpy": t_np_read},
          pack_rows_s={"native": t_nat_pack, "numpy": t_np_pack},
          native_equal_numpy=True, k3_launches=n)
    return n


def tooling_phase(quant3, xb, xt, xq, gt, flat_rec, mem3, dev, tmp) -> int:
    """Phase 22: the tooling and serving layer at full width on phase 3's
    data and quantizer (22a-f, one line each). Counts are reset before it;
    launches that only compare (the one-add index of 22d) are left out.
    Returns K3's launches of the phase."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp: dict = {}
    data_dir = os.path.join(tmp, "tooling")
    os.makedirs(data_dir)
    for name, a in (("xt", xt), ("xb", xb), ("xq", xq), ("gt", gt)):
        np.save(os.path.join(data_dir, f"{name}.npy"), a)
    tooling_truth(xb, xq, gt, dev)
    index, Ds, Is, n_b = tooling_batches(quant3, xb, xt, xq, gt, flat_rec,
                                         dev, tmp)
    n_c = tooling_serving(quant3, xb, xt, xq, Ds, Is, dev)
    n_d = tooling_pipeline(data_dir, xb, xq, dev, tmp, cmp)
    n_e = tooling_bench(data_dir, xq, dev)
    n_f = tooling_tools(index, xb, xt, xq, gt, flat_rec, mem3, dev, tmp)
    del index
    shutil.rmtree(data_dir)
    torch.cuda.empty_cache()
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()}
    k3 = got.pop("ivf_scan_fused", 0)
    if any(got.values()) or k3 != n_b + n_c + n_d + n_e + n_f:
        raise AssertionError(f"phase 22 launched {got}, K3 {k3}")
    phase("tooling", seconds=time.perf_counter() - t_phase, k3_launches=k3,
          by_step={"b": n_b, "c": n_c, "d": n_d, "e": n_e, "f": n_f},
          comparison_launches=cmp)
    return k3


def phase3_setup(dev, mem=None, out=None):
    """Phase 3's data, exact ground truth and IVF4096,Flat: (its
    quantizer, xb, xt, xq, gt, its recall@10 at nprobe 16 / 32 / 64).
    ``mem``, a dict, gets `index_memory`'s record of the IVF; ``out``, a
    dict, its (D, I) at each nprobe ("results") and the QPS of its
    ``search`` there ("qps": median of TIMED_REPS after a warm-up)."""
    allx = T.sift_surrogate(NB + NT + NQ, seed=123, **T.SIFT1M_CALIBRATED)
    xb, xt, xq = allx[:NB], allx[NB:NB + NT], allx[NB + NT:]
    flat = T.IndexFlat(D, device=dev)
    flat.add(xb)
    _, gt = flat.search(xq, K)
    del flat
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    index = T.make_ivf_flat(D, NLIST, device=dev)
    index.cp.niter = 10
    index.train(xt)
    index.add(xb)
    if mem is not None:
        mem.update(index_memory(index, mem0))
    rec, results, qps = {}, {}, {}
    for n in (16, 32, 64):
        p = T.SearchParametersIVF(nprobe=n)
        if out is None:
            Iv = index.search(xq, K, params=p)[1]
        else:
            (Dv, Iv), t = timed(lambda: index.search(xq, K, params=p),
                                TIMED_REPS)
            results[n], qps[n] = (Dv, Iv), NQ / t
        rec[n] = T.recall_k_at_k(Iv, gt, K)
    if out is not None:
        out.update(results=results, qps=qps)
    phase("ivf_flat", recall_at_10=rec, **({"qps": qps} if qps else {}))
    quant3 = index.quantizer
    del index
    torch.cuda.empty_cache()
    return quant3, xb, xt, xq, gt, rec


def tooling_alone() -> None:
    """--phase22: phase 22 alone: K3 built, phase 3's data, ground truth
    and IVF4096,Flat (its memory record), then tooling_phase. Its phase
    lines only."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused",))
    mem3 = {}
    quant3, xb, xt, xq, gt, rec = phase3_setup(dev, mem3)
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        tooling_phase(quant3, xb, xt, xq, gt, rec, mem3, dev, tmp)


# -- phase 23: the C handle, the demos and the entry point --------------------

# phase 23's sizes: the nprobes of the C handle's searches, the ranks of
# the entry point's dryrun, the deadline of every child process (servers,
# ranks, the standalone C example)
HANDLES = {"nprobes": (16, 32, 64), "dryrun_ranks": 4, "timeout_s": 300.0}


def c_library(path: str):
    """ctypes binding of the port's C library (tpu_ann_torch/c_api), every
    pointer passed as c_void_p."""
    import ctypes

    lib = ctypes.CDLL(path)
    vp, i64, cp = ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p
    pvp = ctypes.POINTER(ctypes.c_void_p)
    sigs = {
        "tpu_ann_init": [cp, ctypes.c_size_t],
        "tpu_ann_index_factory": [ctypes.c_int, cp, ctypes.c_int, pvp],
        "tpu_ann_index_free": [vp],
        "tpu_ann_write_index": [vp, cp],
        "tpu_ann_read_index": [cp, ctypes.c_int, pvp],
        "tpu_ann_index_ntotal": [vp, ctypes.POINTER(i64)],
        "tpu_ann_index_set_parameter": [vp, cp, ctypes.c_double],
        "tpu_ann_index_train": [vp, i64, vp],
        "tpu_ann_index_add": [vp, i64, vp],
        "tpu_ann_index_search": [vp, i64, vp, i64, vp, vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.tpu_ann_last_error.restype = cp
    return lib


def c_call(lib, name, *args) -> None:
    if getattr(lib, name)(*args) != 0:
        raise AssertionError(f"23a: {name} failed: "
                             f"{lib.tpu_ann_last_error().decode()}")


def c_search(lib, h, xq, k):
    """(D, I) of one search through the C library."""
    Dv = np.empty((len(xq), k), np.float32)
    Iv = np.empty((len(xq), k), np.int64)
    c_call(lib, "tpu_ann_index_search", h, len(xq), xq.ctypes.data, k,
           Dv.ctypes.data, Iv.ctypes.data)
    return Dv, Iv


def handle_example(built: dict, dev, tmp: str) -> dict:
    """23a.1: the standalone C example (its own embedded interpreter) on
    ``dev``: exit code 0 and its "C API example: OK" line."""
    t0 = time.perf_counter()
    run = subprocess.run([built["example"], os.path.join(tmp, "example.idx")],
                         capture_output=True, text=True, cwd=tmp,
                         timeout=HANDLES["timeout_s"],
                         env=capi.example_env(str(dev)))
    secs = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    if run.returncode != 0 or "C API example: OK" not in lines:
        raise AssertionError(f"23a: example_c exited {run.returncode}:\n"
                             f"{run.stdout}\n{run.stderr[-3000:]}")
    backend = [ln for ln in lines if ln.startswith("backend:")][0]
    if not backend.startswith(f"backend: {dev.type}"):
        raise AssertionError(f"23a: example_c ran on {backend}")
    return {"seconds": secs, "backend": backend.split(": ", 1)[1],
            "lines": lines}


def handle_index(lib, quant3, xb, xt, xq, gt, flat_rec, flat_out, qps3, dev,
                 tmp, cmp) -> int:
    """23a.2-5: IVF4096,Flat built and searched through the C functions
    alone (train on the 100k rows, add the 1M, search the 10k queries at
    nprobe 16 / 32 / 64; one K3 launch a search, recall@10 at the floors);
    its file read by tpu_ann_torch.read_index searches the same (D, I) bit
    for bit; phase 3's lists written by tpu_ann_torch and read through the
    C library search phase 3's (D, I) bit for bit. Returns K3's launches
    (the Python searches that compare are left out)."""
    import ctypes

    one = int(dev.type == "cuda")
    buf = ctypes.create_string_buffer(256)
    c_call(lib, "tpu_ann_init", buf, len(buf))
    name = buf.value.decode()
    if dev.type == "cuda" and not name.startswith("cuda:"):
        raise AssertionError(f"23a: the handle chose {name}")
    xt_c, xb_c, xq_c = (np.ascontiguousarray(a, np.float32)
                        for a in (xt, xb, xq))
    h = ctypes.c_void_p()
    t0 = time.perf_counter()
    c_call(lib, "tpu_ann_index_factory", D, f"IVF{NLIST},Flat".encode(), 1,
           ctypes.byref(h))
    c_call(lib, "tpu_ann_index_train", h, len(xt_c), xt_c.ctypes.data)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_call(lib, "tpu_ann_index_add", h, len(xb_c), xb_c.ctypes.data)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    nt = ctypes.c_int64()
    c_call(lib, "tpu_ann_index_ntotal", h, ctypes.byref(nt))
    if nt.value != NB:
        raise AssertionError(f"23a: ntotal {nt.value}")
    obj = capi._get(h.value)          # the Python index behind the handle
    n, res, out = 0, {}, {}
    for nprobe in HANDLES["nprobes"]:
        c_call(lib, "tpu_ann_index_set_parameter", h, b"nprobe",
               float(nprobe))
        times, py_times = [], []
        for rep in range(1 + TIMED_REPS):
            before = F.LAUNCHES
            t1 = time.perf_counter()
            Dv, Iv = c_search(lib, h, xq_c, K)
            times.append(time.perf_counter() - t1)
            if F.LAUNCHES - before != one:
                raise AssertionError(f"23a: a C search at nprobe {nprobe} "
                                     f"launched K3 {F.LAUNCHES - before} "
                                     f"times")
            n += F.LAUNCHES - before
            # the same object searched from Python, in turns with C
            t1 = time.perf_counter()
            Dp, Ip = uncounted(lambda: obj.search(xq, K), cmp)
            py_times.append(time.perf_counter() - t1)
            if not (np.array_equal(Dp, Dv) and np.array_equal(Ip, Iv)):
                raise AssertionError(f"23a: the C search differs from the "
                                     f"same index's Python search")
        rec = T.recall_k_at_k(Iv, gt, K)
        if rec < RECALL_FLOORS[nprobe]:
            raise AssertionError(f"23a: recall@10 {rec} < "
                                 f"{RECALL_FLOORS[nprobe]} at nprobe {nprobe}")
        out[nprobe] = (Dv, Iv)
        res[nprobe] = {"recall_at_10": rec, "floor": RECALL_FLOORS[nprobe],
                       "qps": NQ / float(np.median(times[1:])),
                       "python_qps_same_object":
                           NQ / float(np.median(py_times[1:])),
                       "phase3_qps": qps3.get(nprobe),
                       "phase3_recall_at_10": flat_rec[nprobe]}
    # the C index's file, read and searched by the Python package
    path = os.path.join(tmp, "handle_ivf.tann")
    t0 = time.perf_counter()
    c_call(lib, "tpu_ann_write_index", h, path.encode())
    t_write = time.perf_counter() - t0
    del obj
    c_call(lib, "tpu_ann_index_free", h)
    py = IIO.read_index(path, device=dev)
    for nprobe in HANDLES["nprobes"]:
        py.nprobe = nprobe
        (Dp, Ip), t = uncounted(lambda: timed(lambda: py.search(xq, K),
                                              TIMED_REPS), cmp)
        if not (np.array_equal(Dp, out[nprobe][0])
                and np.array_equal(Ip, out[nprobe][1])):
            raise AssertionError(f"23a: read_index of the C index's file "
                                 f"differs at nprobe {nprobe}")
        res[nprobe]["python_qps_read_copy"] = NQ / t
    del py
    os.remove(path)
    # phase 3's lists, written by the package, read through the C library
    idx3 = ivf_over(quant3, xb, np.arange(NB), xt, dev=dev)
    IIO.write_index(idx3, path)
    del idx3
    torch.cuda.empty_cache()
    h3 = ctypes.c_void_p()
    c_call(lib, "tpu_ann_read_index", path.encode(), 1, ctypes.byref(h3))
    for nprobe in HANDLES["nprobes"]:
        c_call(lib, "tpu_ann_index_set_parameter", h3, b"nprobe",
               float(nprobe))
        before = F.LAUNCHES
        Dv, Iv = c_search(lib, h3, xq_c, K)
        n += F.LAUNCHES - before
        if not (np.array_equal(Dv, flat_out[nprobe][0])
                and np.array_equal(Iv, flat_out[nprobe][1])):
            raise AssertionError(f"23a: phase 3's file through the C "
                                 f"library differs at nprobe {nprobe}")
    c_call(lib, "tpu_ann_index_free", h3)
    os.remove(path)
    torch.cuda.empty_cache()
    phase("handle_index", device=name, factory=f"IVF{NLIST},Flat",
          nb=NB, nq=NQ, train_s=t_train, add_s=t_add, write_s=t_write,
          by_nprobe=res, one_k3_launch_a_search=True,
          python_search_equal_c=True, python_read_equal_c=True,
          phase3_file_equal_phase3=True,
          k3_launches=n)
    return n


def handle_demos(dev) -> dict:
    """23b: the eight demos on ``dev`` at their own sizes, each with its
    asserts: the numbers each returns, its seconds and its launches (the
    client/server demo's K3 launches are its servers'). The paged demo must
    launch K4, the IVF demos K3, the codec demos nothing. Returns (K3 / K4
    launches in all, those made in this process)."""
    from tpu_ann_torch.demos import (demo_auto_tune, demo_client_server_ivf,
                                     demo_custom_invlists, demo_ondisk_ivf,
                                     demo_paged_outofcore, demo_qinco,
                                     demo_residual_quantizer,
                                     demo_sharded_search)

    want = {"custom_invlists": "K3", "ondisk_ivf": "K3",
            "paged_outofcore": "K4", "auto_tune": "K3",
            "client_server_ivf": "K3", "sharded_search": None,
            "residual_quantizer": None, "qinco": None}
    mods = {"custom_invlists": demo_custom_invlists,
            "ondisk_ivf": demo_ondisk_ivf,
            "paged_outofcore": demo_paged_outofcore,
            "auto_tune": demo_auto_tune,
            "client_server_ivf": demo_client_server_ivf,
            "sharded_search": demo_sharded_search,
            "residual_quantizer": demo_residual_quantizer,
            "qinco": demo_qinco}
    total = {"ivf_scan_fused": 0, "ivf_scan_paged": 0}
    here = dict(total)
    for name, mod in mods.items():
        kw = ({"timeout_s": HANDLES["timeout_s"]}
              if name in ("client_server_ivf", "sharded_search") else {})
        before = counts()
        t0 = time.perf_counter()
        out = mod.main(device=str(dev), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launched(before)
        for k in here:
            here[k] += got.get(k, 0)
        got["ivf_scan_fused"] = (got.get("ivf_scan_fused", 0)
                                 + out.get("server_k3_launches", 0))
        got = {k: v for k, v in got.items() if v}
        one = dev.type == "cuda"
        kernel = {"K3": "ivf_scan_fused", "K4": "ivf_scan_paged",
                  None: None}[want[name]]
        if one and (set(got) != ({kernel} if kernel else set())):
            raise AssertionError(f"23b: demo {name} launched {got}, "
                                 f"expected {want[name] or 'nothing'}")
        for k in total:
            total[k] += got.get(k, 0)
        phase("handle_demo", demo=name, seconds=secs, launches=got, **out)
    return total, here


def handle_entry(dev) -> dict:
    """23c: entry()'s step on the card against the same step on a CPU copy
    of its index (ids equal, distances within rtol 1e-5), then
    dryrun_multichip over 2 x 2 ranks on the card (gloo). Returns K3 / K4
    launches (the dryrun's, summed over its ranks)."""
    from tpu_ann_torch import graft_entry as G

    t0 = time.perf_counter()
    fn, (xq_dev,) = G.entry(str(dev))
    before = counts()
    Dg, Ig = fn(xq_dev)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    if launched(before):
        raise AssertionError(f"23c: entry's step launched {launched(before)}")
    cpu_index = IIO.deserialize_index(IIO.serialize_index(fn.index),
                                      device="cpu")
    fn_c, _ = G.entry("cpu", index=cpu_index)
    Dc, Ic = fn_c(xq_dev.cpu())
    if xq_dev.device.type != dev.type or not np.array_equal(
            Ig.cpu().numpy(), Ic.numpy()):
        raise AssertionError("23c: entry's ids differ from the CPU step's")
    np.testing.assert_allclose(Dg.cpu().numpy(), Dc.numpy(), rtol=1e-5)
    derr = float(np.abs(Dg.cpu().numpy() - Dc.numpy()).max())
    t0 = time.perf_counter()
    dry = G.dryrun_multichip(HANDLES["dryrun_ranks"], str(dev),
                             timeout_s=HANDLES["timeout_s"])
    t_dry = time.perf_counter() - t0
    ranks = HANDLES["dryrun_ranks"]
    if dev.type == "cuda" and not (dry["k3_launches"] == 2 * ranks
                                   and dry["k4_launches"] >= ranks):
        raise AssertionError(f"23c: the dryrun launched K3 "
                             f"{dry['k3_launches']}, K4 {dry['k4_launches']}")
    phase("handle_entry", entry_s=t_entry, entry_equal_cpu_ids=True,
          entry_max_abs_err_vs_cpu=derr, dryrun_s=t_dry, **dry)
    return {"ivf_scan_fused": dry["k3_launches"],
            "ivf_scan_paged": dry["k4_launches"]}


def handles_phase(quant3, xb, xt, xq, gt, flat_rec, flat_out, qps3, dev,
                  tmp) -> dict:
    """Phase 23: the port's C handle, its eight demos and its entry point
    on the card (23a-c). Counts are reset before it; launches that only
    compare are left out. Returns K3's and K4's launches of the phase."""
    t_phase = time.perf_counter()
    reset_counts()
    cmp: dict = {}
    t0 = time.perf_counter()
    built = capi.build_library()
    t_build = time.perf_counter() - t0
    ex = handle_example(built, dev, tmp)
    phase("handle_example", build_s=t_build, **ex)
    lib = c_library(built["library"])
    n_a = handle_index(lib, quant3, xb, xt, xq, gt, flat_rec, flat_out, qps3,
                       dev, tmp, cmp)
    n_b, n_b_here = handle_demos(dev)
    n_c = handle_entry(dev)
    got = {k: v - cmp.get(k, 0) for k, v in launched().items()}
    got = {k: v for k, v in got.items() if v}
    want = {"ivf_scan_fused": n_a + n_b_here["ivf_scan_fused"],
            "ivf_scan_paged": n_b_here["ivf_scan_paged"]}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"phase 23 launched {got} in this process, "
                             f"expected {want}")
    total = {k: n_a * (k == "ivf_scan_fused") + n_b[k] + n_c[k]
             for k in ("ivf_scan_fused", "ivf_scan_paged")}
    phase("handles", seconds=time.perf_counter() - t_phase,
          launches=total, launches_in_process=got,
          comparison_launches=cmp)
    return total


def handles_alone() -> None:
    """--phase23: phase 23 alone: K3 and K4 built, phase 3's data, ground
    truth, IVF4096,Flat and its searches, then handles_phase. Its phase
    lines only."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused", "ivf_scan_paged"))
    out3 = {}
    quant3, xb, xt, xq, gt, rec = phase3_setup(dev, out=out3)
    with tempfile.TemporaryDirectory(prefix="tpu_ann_smoke_") as tmp:
        handles_phase(quant3, xb, xt, xq, gt, rec, out3["results"],
                      out3["qps"], dev, tmp)


# -- phase 24: the per-pair top-kp above kp 64 --------------------------------

# phase 24's sizes: the searches' k and nprobes (kp 106), the kp K3 is held
# at on the 10k-query plan at nprobe 32 and on nq_big queries, the timed
# repetitions; the k of the IVF4096,SQ8 searches (kp 56 and 106), and how
# much recall QT_8BIT may lose against IVF-Flat at the same k and nprobe
# (its largest loss at k 10, 0.0122 at nprobe 64, is what SQ8_MAX_LOSS
# allows there)
WIDE = {"k": 100, "nprobes": (16, 32, 64), "kps": (106, 262),
        "kp_big": 1030, "nq_big": 1024, "reps": 3, "sq8_ks": (50, 100),
        "sq8_max_loss": 0.015}


def exact_ground_truth(xb, xq, k, dev) -> np.ndarray:
    """(nq, k) ids of the exact f32 top-k of xq over xb."""
    flat = T.IndexFlat(D, device=dev)
    flat.add(xb)
    return flat.search(xq, k)[1]


def wide_check(name, q16, qn, plan, lists, kp, exact) -> dict:
    """One kernel at kp (above KP_MAX) on ``plan``: per-pair (D, P) against
    the plain version on the card (bit for bit if ``exact``, else within
    rtol 1e-5, positions up to near-ties); its CUDA-event time beside the
    plain version's, the parent route's (`scan_pairs_wide` over the kp-32
    launch) and the bound."""
    before = (F.LAUNCHES + F.LAUNCHES_SQ8, F.LAUNCHES_GLOBAL)
    d1, p1 = F.scan_pairs(q16, qn, plan, lists, kp, False)
    torch.cuda.synchronize()
    got = (F.LAUNCHES + F.LAUNCHES_SQ8 - before[0],
           F.LAUNCHES_GLOBAL - before[1])
    if got != (1, 1):
        raise AssertionError(f"{name} kp {kp}: launches {got}, want one of "
                             f"the global-list kernel")
    d0, p0 = F.scan_pairs_reference(q16, qn, plan, lists, kp, False)
    if exact:
        assert_equal(f"{name} kp {kp} distances", d0, d1)
        assert_equal(f"{name} kp {kp} positions", p0, p1)
        err = max_abs_err(d0, d1)
    else:
        err = assert_close_pairs(f"{name} kp {kp}", d0, p0, d1, p1)
    del d0, p0, d1, p1
    u8 = F.stream_of(lists).dtype == torch.uint8
    return {"kp": kp, "pairs": int(plan.pair_q.numel()), "max_abs_err": err,
            "ms": cuda_ms(lambda: F.scan_pairs(q16, qn, plan, lists, kp,
                                               False), WIDE["reps"]),
            "parent_ms": cuda_ms(lambda: F.scan_pairs_wide(
                q16, qn, plan, lists, kp, False, F._launch), WIDE["reps"]),
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q16, qn, plan, lists, kp, False), 1),
            **bound(*pair_scan_work(plan, lists.ids, lists.block_size, D, kp,
                                    0, lists.nblocks,
                                    elem_bytes=1 if u8 else 2))}


def scan_launches() -> tuple:
    """(K3, K3-SQ8, kp 33-64, kp >= 65, K4) launch counts."""
    return (F.LAUNCHES, F.LAUNCHES_SQ8, F.LAUNCHES_WIDE, F.LAUNCHES_GLOBAL,
            P.LAUNCHES)


def since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(scan_launches(), before))


def sq8_wide_searches(idx, name, xq, xq_dev, gt100, probes, flat,
                      flat_rec) -> dict:
    """Phase 24(c) for one IVF4096,SQ8 index: at each nprobe a search at
    k 50 (kp 56) and one at k 100 (kp 106), each exactly one K3-SQ8 launch,
    of the kp 33-64 kernel and of the global-list kernel; then k 10's
    warm-up and three timed searches at each k in turns, no K3 or K4
    launch among them. (D, I) against the plain route on the SQ8 view (bit
    for bit for QT_8BIT_DIRECT; QT_8BIT within rtol 1e-5, ids apart only
    on near-ties); QT_8BIT_DIRECT's equal to IVF4096,Flat's (``flat``)
    bit for bit; recall@50 / @100 against the exact top 100 must not fall
    with nprobe, and QT_8BIT's stays within WIDE["sq8_max_loss"] of
    IVF-Flat's (``flat_rec``). The kernel on each search's plan: its
    CUDA-event time, the plain version's and the bound; at nprobe 32 and
    kp 56 its per-pair (D, P) against the plain version's (kp 106's is
    `wide_check`'s). Returns {"searches":
    {nprobe: {k: record}}, "launches": the path's K3-SQ8 launches (kp
    33-64, kp >= 65, all)}."""
    lossy = idx.qtype != T.QT_8BIT_DIRECT
    view = idx._sq8_view()
    q8, qn8 = F.fold_queries(xq_dev, view, False)
    ks = WIDE["sq8_ks"]
    out, path = {}, [0, 0, 0]
    for nprobe in WIDE["nprobes"]:
        p = T.SearchParametersIVF(nprobe=nprobe)
        res = {}
        for k in ks:
            before = scan_launches()
            res[k] = idx.search(xq, k, params=p)
            wide = F.default_kp(k) <= F.KP_MAX
            if since(before) != (0, 1, int(wide), int(not wide), 0):
                raise AssertionError(f"{name} k {k} nprobe {nprobe}: "
                                     f"launches {since(before)}, want one "
                                     f"K3-SQ8 launch of the "
                                     f"{'wide' if wide else 'global'}-list "
                                     f"kernel")
            path[0 if wide else 1] += 1
            path[2] += 1
        before = scan_launches()
        idx.search(xq, K, params=p)
        ts = {kk: [] for kk in (K, *ks)}
        order = (K, *ks, *ks[::-1], K) + (K, *ks)
        for kk in order:
            t0 = time.perf_counter()
            idx.search(xq, kk, params=p)
            ts[kk].append(time.perf_counter() - t0)
        n = {kk: order.count(kk) for kk in ks}
        if since(before) != (0, 1 + len(order), n[ks[0]], n[ks[1]], 0):
            raise AssertionError(f"{name} nprobe {nprobe}: the timed "
                                 f"searches launched {since(before)}")
        path[0] += n[ks[0]]
        path[1] += n[ks[1]]
        path[2] += 1 + len(order)
        row = {}
        for k in ks:
            Dv, Iv = res[k]
            kp = F.default_kp(k)
            where = f"{name} k {k} nprobe {nprobe}"
            if not (Dv.shape == Iv.shape == (NQ, k) and np.isfinite(Dv).all()
                    and (Iv >= 0).all() and (Iv < NB).all()
                    and (np.diff(Dv, axis=1) >= 0).all()):
                raise AssertionError(f"{where}: malformed results")
            D0, I0, _ = F.scan_invlists_fused_reference(xq_dev, probes[nprobe],
                                                        view, k)
            D0, I0 = D0.cpu().numpy(), idx._map_ids(I0.cpu().numpy())
            if lossy:
                assert_close_pairs(f"{where} against the plain route",
                                   *(torch.from_numpy(a) for a in
                                     (D0, I0, Dv, Iv)))
            elif not (np.array_equal(Dv, D0) and np.array_equal(Iv, I0)):
                raise AssertionError(f"{where}: (D, I) differ from the plain "
                                     f"route's")
            equal_flat = bool(np.array_equal(Dv, flat[(k, nprobe)][0]) and
                              np.array_equal(Iv, flat[(k, nprobe)][1]))
            if not lossy and not equal_flat:
                raise AssertionError(f"{where}: (D, I) differ from "
                                     f"IVF4096,Flat's")
            rec = T.recall_k_at_k(Iv, gt100, k)
            floor = flat_rec[(k, nprobe)] - WIDE["sq8_max_loss"]
            if lossy and rec < floor:
                raise AssertionError(f"{where}: recall@{k} {rec} < {floor}")
            plan = F.plan_pairs(probes[nprobe], view)
            r = {f"recall_at_{k}": rec, "ivf_flat_recall": flat_rec[
                (k, nprobe)], "equal_to_ivf_flat": equal_flat,
                 "qps": NQ / float(np.median(ts[k])),
                 "qps_k10": NQ / float(np.median(ts[K])),
                 "search_ms": [t * 1e3 for t in ts[k]], "kp": kp,
                 "ms": cuda_ms(lambda: F.scan_pairs(q8, qn8, plan, view, kp,
                                                    False), WIDE["reps"]),
                 "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                     q8, qn8, plan, view, kp, False), 1),
                 **bound(*pair_scan_work(plan, view.ids, view.block_size, D,
                                         kp, 0, view.nblocks, elem_bytes=1))}
            if nprobe == 32 and kp <= F.KP_MAX:
                d1, p1 = F.scan_pairs(q8, qn8, plan, view, kp, False)
                d0, p0 = F.scan_pairs_reference(q8, qn8, plan, view, kp,
                                                False)
                if not lossy:
                    assert_equal(f"K3-SQ8 {where} distances", d0, d1)
                    assert_equal(f"K3-SQ8 {where} positions", p0, p1)
                r["max_abs_err"] = assert_close_pairs(f"K3-SQ8 {where}", d0,
                                                      p0, d1, p1)
                del d0, p0, d1, p1
            row[k] = r
        out[nprobe] = row
    for k in ks:
        recs = [out[n][k][f"recall_at_{k}"] for n in WIDE["nprobes"]]
        if recs != sorted(recs):
            raise AssertionError(f"{name}: recall@{k} falls with nprobe: "
                                 f"{recs}")
    phase("wide_sq8_search", qtype=name, nq=NQ, searches=out,
          path_launches={"wide": path[0], "global": path[1],
                         "all": path[2]})
    return {"searches": out, "launches": tuple(path)}


def sq8_record(name, kp_class, launches, at, err, **extra) -> dict:
    """A kernels-line record of a K3-SQ8 kernel above kp 32, its time at
    ``at`` (a `sq8_wide_searches` record: QT_8BIT at nprobe 32), ``err``
    its largest difference from the plain version."""
    return {
        "name": name,
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_sq8.cu (body in "
                  "tpu_ann_torch/csrc/ivf_scan_core.cuh, " + kp_class + ")",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:217-250",
        "launches": launches,
        "max_abs_err": err,
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,
        **extra,
    }


def wide_phase(quant3, xb, xt, xq, gt100, dev) -> dict:
    """Phase 24: the searches past kp 32 on phase 3's data and quantizer,
    ``gt100`` the exact top 100. (a) IVF4096,Flat (phase 3's lists)
    searched at k 100 (kp 106) at nprobe 16 / 32 / 64: each search exactly
    one K3 launch, of the global-list kernel; recall@100; (D, I) equal to
    the plain route's (`scan_invlists_fused_reference`) bit for bit; QPS
    in turns with k 10's; the kernel's time on each search's plan beside
    its bound; and one search at k 50 (kp 56, the wide lists) a nprobe,
    which (c) compares with. (b) K3 at kp 106 and 262 on the 10k-query
    plan at nprobe 32 and at kp 1030 on 1024 queries: per-pair (D, P)
    equal to the plain version bit for bit, the k-100 scan equal to
    `scan_invlists_fused_reference`, CUDA-event times beside the parent
    route's (`scan_pairs_wide` over the kp-32 launch) and the plain
    version's, bounds. (c) IVF4096,SQ8 with QT_8BIT and QT_8BIT_DIRECT
    searched at k 50 and 100 (`sq8_wide_searches`), then K3-SQ8 at kp 106
    on the nprobe-32 plan as (b). Returns {"global": the kernels-line
    record of the global-list kernels, "sq8_wide" / "sq8_global": K3-SQ8's
    kp 33-64 / kp >= 65 records, "k3_wide": (a)'s kp 33-64 launches}."""
    t_phase = time.perf_counter()
    k = WIDE["k"]
    k50 = WIDE["sq8_ks"][0]
    index = ivf_over(quant3, xb, np.arange(NB), xt, dev=dev)
    il = index.invlists
    xq_dev = torch.from_numpy(xq).to(dev)
    probes = {n: index._coarse_search_device(xq_dev, n)[1]
              for n in WIDE["nprobes"]}

    # (a) the search at k 100, one launch each of the global-list kernel
    reset_counts()
    searches, flat, flat_rec, n_k100, n_all = {}, {}, {}, 0, 0
    for nprobe in WIDE["nprobes"]:
        p = T.SearchParametersIVF(nprobe=nprobe)
        Dv, Iv = index.search(xq, k, params=p)
        flat[(k50, nprobe)] = index.search(xq, k50, params=p)
        flat[(k, nprobe)] = (Dv, Iv)
        index.search(xq, K, params=p)
        ts = {K: [], k: []}
        for kk in (K, k, k, K, K, k):
            t0 = time.perf_counter()
            index.search(xq, kk, params=p)
            ts[kk].append(time.perf_counter() - t0)
        n_k100 += 4
        n_all += 9
        if not (Dv.shape == Iv.shape == (NQ, k) and np.isfinite(Dv).all()
                and (Iv >= 0).all() and (Iv < NB).all()
                and (np.diff(Dv, axis=1) >= 0).all()):
            raise AssertionError(f"k {k} nprobe {nprobe}: malformed results")
        for kk in (k50, k):
            flat_rec[(kk, nprobe)] = T.recall_k_at_k(flat[(kk, nprobe)][1],
                                                     gt100, kk)
        searches[nprobe] = {
            "recall_at_100": flat_rec[(k, nprobe)],
            "recall_at_50": flat_rec[(k50, nprobe)],
            "qps": NQ / float(np.median(ts[k])),
            "qps_k10": NQ / float(np.median(ts[K])),
            "search_ms": [t * 1e3 for t in ts[k]]}
    n_k50 = len(WIDE["nprobes"])
    path = {"ivf_scan_fused": F.LAUNCHES,
            "ivf_scan_global": F.LAUNCHES_GLOBAL,
            "ivf_scan_wide": F.LAUNCHES_WIDE}
    if path != {"ivf_scan_fused": n_all, "ivf_scan_global": n_k100,
                "ivf_scan_wide": n_k50} or F.LAUNCHES_SQ8 or P.LAUNCHES:
        raise AssertionError(f"the k-{k} searches launched {path}, want "
                             f"{n_all} K3 launches, {n_k100} of them the "
                             f"global-list kernel and {n_k50} the wide one")
    c0 = F.LAUNCHES + F.LAUNCHES_SQ8
    q16, qn = F.fold_queries(xq_dev, il, False)
    kp = F.default_kp(k)
    for nprobe in WIDE["nprobes"]:
        plan = F.plan_pairs(probes[nprobe], il)
        searches[nprobe].update(
            kernel_ms=cuda_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp,
                                                   False), WIDE["reps"]),
            **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks)))
        Dv, Iv = flat[(k, nprobe)]
        D0, I0, _ = F.scan_invlists_fused_reference(xq_dev, probes[nprobe],
                                                    il, k)
        if not (np.array_equal(Dv, D0.cpu().numpy()) and np.array_equal(
                Iv, index._map_ids(I0.cpu().numpy()))):
            raise AssertionError(f"k {k} nprobe {nprobe}: (D, I) differ "
                                 f"from the plain route's")
        del D0, I0
    recs = [searches[n]["recall_at_100"] for n in WIDE["nprobes"]]
    if recs != sorted(recs):
        raise AssertionError(f"recall@100 falls with nprobe: {recs}")
    phase("wide_search", k=k, kp=kp, nq=NQ, searches=searches,
          launches=path, equal_to_plain_route=True)

    # (b) K3 at kp 106 / 262 (10k q, nprobe 32) and 1030 (1024 q)
    plan32 = F.plan_pairs(probes[32], il)
    k3 = {}
    for kp in WIDE["kps"]:
        k3[kp] = wide_check("K3", q16, qn, plan32, il, kp, True)
    nb = WIDE["nq_big"]
    plan_big = F.plan_pairs(probes[32][:nb], il)
    k3[WIDE["kp_big"]] = wide_check("K3", q16[:nb], qn[:nb], plan_big, il,
                                    WIDE["kp_big"], True)
    for kp, nq_s in ((106, NQ), (262, NQ), (WIDE["kp_big"], nb)):
        D1, I1, _ = F.scan_invlists_fused(xq_dev[:nq_s], probes[32][:nq_s],
                                          il, k, kp=kp)
        D0, I0, _ = F.scan_invlists_fused_reference(
            xq_dev[:nq_s], probes[32][:nq_s], il, k, kp=kp)
        assert_equal(f"K3 scan at k {k} kp {kp} distances", D0, D1)
        assert_equal(f"K3 scan at k {k} kp {kp} ids", I0, I1)
    del D0, I0, D1, I1, index, il
    torch.cuda.empty_cache()
    c_ab = F.LAUNCHES + F.LAUNCHES_SQ8 - c0

    # (c) IVF4096,SQ8 at k 50 / 100, then K3-SQ8 at kp 106 (10k q, nprobe
    # 32) on both qtypes
    sq8, sq8_path = {}, {}
    c1 = F.LAUNCHES + F.LAUNCHES_SQ8
    for name, qtype in (("QT_8BIT", T.QT_8BIT),
                        ("QT_8BIT_DIRECT", T.QT_8BIT_DIRECT)):
        idx = ivf_over(quant3, xb, np.arange(NB), xt, qtype, dev=dev)
        sq8_path[name] = sq8_wide_searches(idx, name, xq, xq_dev, gt100,
                                           probes, flat, flat_rec)
        view = idx._sq8_view()
        q8, qn8 = F.fold_queries(xq_dev, view, False)
        sq8[name] = wide_check(f"K3-SQ8 {name}", q8, qn8,
                               F.plan_pairs(probes[32], view), view, 106,
                               name == "QT_8BIT_DIRECT")
        del idx, view
        torch.cuda.empty_cache()
    n_wide8, n_global8, n_all8 = (sum(r["launches"][i]
                                      for r in sq8_path.values())
                                  for i in range(3))
    phase("wide_kernels", nq=[NQ, nb], nprobe=32, k3=k3, k3_sq8=sq8,
          comparison_launches=c_ab + F.LAUNCHES + F.LAUNCHES_SQ8 - c1
          - n_all8, seconds=time.perf_counter() - t_phase)
    at = k3[106]

    def sq8_times(kk):
        return {f"{n.lower()}_nprobe{nprobe}_{f}":
                r["searches"][nprobe][kk][f] for n, r in sq8_path.items()
                for nprobe in WIDE["nprobes"]
                for f in ("ms", "plain_ms", "bound_ms")}

    return {"global": {
        "name": "ivf_scan_global",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_core.cuh (update_list, "
                  "sort_list, merge_run; kernels in ivf_scan_fused.cu, "
                  "ivf_scan_sq8.cu, ivf_scan_paged.cu)",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:217-250",
        "launches": path["ivf_scan_global"],
        "launches_ivf_flat": path["ivf_scan_global"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           [*k3.values(), *sq8.values()]),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,
        "parent_ms": at["parent_ms"],
        **{f"kp{kp}_{f}": r[f] for kp, r in k3.items() if kp != 106
           for f in ("ms", "parent_ms", "plain_ms", "bound_ms")},
        **{f"sq8_{n.lower()}_{f}": r[f] for n, r in sq8.items()
           for f in ("ms", "parent_ms", "plain_ms", "bound_ms")},
    }, "sq8_wide": sq8_record(
        "ivf_scan_sq8_wide", "update_chunk2, scan_tile<..., 2, kPTWide>",
        n_wide8, sq8_path["QT_8BIT"]["searches"][32][k50],
        max(r["searches"][32][k50]["max_abs_err"]
            for r in sq8_path.values()),
        launches_ivf_sq8=n_wide8, **sq8_times(k50)),
       "sq8_global": sq8_record(
        "ivf_scan_sq8_global", "update_list, sort_list, merge_run",
        n_global8, sq8_path["QT_8BIT"]["searches"][32][k],
        max(r["max_abs_err"] for r in sq8.values()), **sq8_times(k)),
       "k3_wide": n_k50}


def wide_alone() -> None:
    """--phase24: phase 24 alone: K3 and K3-SQ8 built, phase 3's data,
    ground truth and IVF4096,Flat, the exact top 100, then wide_phase. Its
    phase lines only."""
    dev = require_gpu()
    kernels.load_libraries(("ivf_scan_fused", "ivf_scan_sq8"))
    quant3, xb, xt, xq, _, _ = phase3_setup(dev)
    wide_phase(quant3, xb, xt, xq, exact_ground_truth(xb, xq, WIDE["k"], dev),
               dev)


# -- --wide-ab: the kernels above kp 32 against another tree's ---------------

def other_tree_kernels(root: str) -> dict:
    """K3, K3-SQ8 and K4 built from ``root``/tpu_ann_torch/csrc (one nvcc
    each, all started together, into this tree's build directory), bound
    as this tree's wrappers bind theirs: {"ivf_scan_fused": fn,
    "ivf_scan_sq8": fn, "ivf_scan_paged": library}."""
    import concurrent.futures
    import ctypes

    def build(name):
        so = os.path.join(kernels.BUILD_DIR, f"other_{name}.so")
        src = os.path.join(root, "tpu_ann_torch", "csrc", name + ".cu")
        subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", so,
                        src], check=True, capture_output=True)
        return ctypes.CDLL(so)

    names = ("ivf_scan_fused", "ivf_scan_sq8", "ivf_scan_paged")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    out = {}
    for name in names[:2]:
        fn = getattr(libs[name], name)
        fn.argtypes = [vp] * 10 + [ci] * 5 + [vp] * 3
        fn.restype = ci
        out[name] = fn
    libs["ivf_scan_paged"].ivf_scan_window.argtypes = \
        [vp] * 10 + [ci] * 8 + [vp] * 3
    libs["ivf_scan_paged"].ivf_scan_window.restype = ci
    out["ivf_scan_paged"] = libs["ivf_scan_paged"]
    return out


HOP0_ROWS = 15625     # --wide-ab's hop-0 graph: IVFHNSW15625's centroid count


def wide_ab() -> None:
    """--wide-ab ROOT: the IVF scan kernels above kp 32 of this tree
    against those of the tree at ROOT (its csrc built here, called through
    this tree's wrappers) on the same inputs, in turns (ROOT, this, this,
    ROOT), CUDA events: K3 on phase 3's lists at 10k queries (kp 46 / 58 /
    64 / 106 / 262 at nprobe 32, kp 106 at nprobe 16 and 64, kp 32 as the
    control) and 1024 (kp 1030); K3 at kp 64 on a hop-0 plan (8192 queries
    x 64 tiles of an HNSW16 over 15625 base rows, as phase 17j's over the
    IVFHNSW15625 centroids); K3-SQ8 (QT_8BIT) at kp 46 and 106; K4 on the
    first window (8192 blocks) of 1024 queries at nprobe 32 (kp 33 / 58 /
    100 / 106 / 262 / 1030). Each shape's two outputs must be equal bit for
    bit.
    One JSON line a shape: both trees' times, the bound."""
    dev = require_gpu()
    other = other_tree_kernels(sys.argv[2])
    kernels.load_libraries(("ivf_scan_fused", "ivf_scan_sq8",
                            "ivf_scan_paged"))
    mine = {"ivf_scan_fused": F._lib("ivf_scan_fused"),
            "ivf_scan_sq8": F._lib("ivf_scan_sq8"),
            "ivf_scan_paged": P._lib()}

    def use(libs):
        F._LIBS["ivf_scan_fused"] = libs["ivf_scan_fused"]
        F._LIBS["ivf_scan_sq8"] = libs["ivf_scan_sq8"]
        P._LIB = libs["ivf_scan_paged"]

    def ab(name, fn, work, reps=5, reset=None):
        outs, ts = {}, {"other": [], "this": []}
        copy_ms = cuda_ms(reset, 20) if reset else 0.0
        for who in ("other", "this", "this", "other"):
            use(other if who == "other" else mine)
            outs[who] = [t.clone() for t in fn()]
            ts[who].append(cuda_ms(fn, reps) - copy_ms)
        use(mine)
        for a, b in zip(outs["other"], outs["this"]):
            assert_equal(f"{name}: this tree against the other", a, b)
        print(json.dumps({"ab": name, "other_ms": ts["other"],
                          "this_ms": ts["this"], **bound(*work)}),
              flush=True)

    quant3, xb, xt, xq, _, _ = phase3_setup(dev)
    index = ivf_over(quant3, xb, np.arange(NB), xt, dev=dev)
    il = index.invlists
    xq_dev = torch.from_numpy(xq).to(dev)
    q16, qn = F.fold_queries(xq_dev, il, False)
    for nprobe, kps in ((32, (32, 46, 58, 64, 106, 262)), (16, (106,)),
                        (64, (106,))):
        plan = F.plan_pairs(index._coarse_search_device(xq_dev, nprobe)[1],
                            il)
        for kp in kps:
            ab(f"K3 kp {kp} nprobe {nprobe} 10k q",
               lambda: F.scan_pairs(q16, qn, plan, il, kp, False),
               pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                              il.nblocks))
    nb = WIDE["nq_big"]
    probes_b = index._coarse_search_device(xq_dev[:nb], 32)[1]
    plan = F.plan_pairs(probes_b, il)
    ab("K3 kp 1030 nprobe 32 1024 q",
       lambda: F.scan_pairs(q16[:nb], qn[:nb], plan, il, 1030, False),
       pair_scan_work(plan, il.ids, il.block_size, D, 1030, 0, il.nblocks))
    # K4 on the first window of phase 8's planner, from phase 3's lists
    win = P.Window(il.data_bf16, il.ids, il.norms)
    tbs = plan.tile_bs.long().cpu().numpy()
    tbe = tbs + plan.tile_nb.long().cpu().numpy()
    w0, ta, tb = next(iter(P._plan_windows(tbs, tbe, 8192, 4096)))
    win = win.blocks(w0, min(8192, il.nblocks - w0))
    for kp in (33, 58, 100, 106, 262, 1030):
        run = (torch.full((plan.ntiles * F.PT, kp), float("inf"),
                          device=dev),
               torch.full((plan.ntiles * F.PT, kp), -1, dtype=torch.int32,
                          device=dev))
        cur = tuple(t.clone() for t in run)

        def reset():
            cur[0].copy_(run[0])
            cur[1].copy_(run[1])

        def call():
            reset()
            P.scan_window(q16[:nb], qn[:nb], plan, win, w0, ta, tb, *cur,
                          False)
            return cur

        ab(f"K4 kp {kp} window 0 1024 q", call,
           pair_scan_work(plan, win.ids, win.block_size, D, kp, w0,
                          w0 + win.nblocks, ta, tb, running=True),
           reps=10, reset=reset)
    del index, il, win
    # K3-SQ8 at kp 106
    idx8 = ivf_over(quant3, xb, np.arange(NB), xt, T.QT_8BIT, dev=dev)
    view = idx8._sq8_view()
    q8, qn8 = F.fold_queries(xq_dev, view, False)
    plan8 = F.plan_pairs(idx8._coarse_search_device(xq_dev, 32)[1], view)
    for kp in (46, 106):
        ab(f"K3-SQ8 kp {kp} nprobe 32 10k q QT_8BIT",
           lambda: F.scan_pairs(q8, qn8, plan8, view, kp, False),
           pair_scan_work(plan8, view.ids, view.block_size, D, kp, 0,
                          view.nblocks, elem_bytes=1))
    del idx8, view
    # K3 at kp 64 on a hop-0 plan
    hq = T.IndexHNSWFlat(D, 16, device=dev)
    hq.add(xb[np.linspace(0, NB - 1, HOP0_ROWS).astype(np.int64)])
    ftq = hq._ensure_tiles_fused()
    x8 = xq_dev[:hq.search_chunk]
    _, seeds = TD.knn(x8, ftq.cent, 64, compute_dtype="bfloat16")
    planh = F.plan_pairs(seeds.to(torch.int32), ftq.il)
    qh, qnh = F.fold_queries(x8, ftq.il, False)
    ab("K3 kp 64 hop 0 8192 q x 64 tiles",
       lambda: F.scan_pairs(qh, qnh, planh, ftq.il, 64, False),
       pair_scan_work(planh, ftq.il.ids, ftq.il.block_size, D, 64, 0,
                      ftq.il.nblocks))


if __name__ == "__main__":
    if sys.argv[1:] == ["--k1-batches"]:
        k1_batches()
    elif sys.argv[1:] == ["--k2-batches"]:
        k2_batches()
    elif sys.argv[1:] == ["--phase19"]:
        codecs_alone()
    elif sys.argv[1:] == ["--phase20"]:
        families_alone()
    elif sys.argv[1:] == ["--phase21"]:
        sharded_alone()
    elif sys.argv[1:] == ["--phase22"]:
        tooling_alone()
    elif sys.argv[1:] == ["--phase23"]:
        handles_alone()
    elif sys.argv[1:] == ["--phase24"]:
        wide_alone()
    elif sys.argv[1:2] == ["--wide-ab"] and len(sys.argv) == 3:
        wide_ab()
    elif sys.argv[1:]:
        raise SystemExit("usage: chip_smoke.py [--k1-batches | "
                         "--k2-batches | --phase19 | --phase20 | "
                         "--phase21 | --phase22 | --phase23 | --phase24 | "
                         "--wide-ab ROOT]")
    else:
        main()
