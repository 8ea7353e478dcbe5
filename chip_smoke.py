#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]
        [--phases env,build,kernels,main,serve,ragged,distance,pq,stream,
                  dist,meshserve,observe,fleet,prims,bench,times]

(add ",profile" to the phases for a torch.profiler breakdown of one
request of each kind; it is not in the default run)

Phases, each printing its own lines; any failure ends the run with a
non-zero exit (nothing is caught and passed over):

1. env      the card's name and power limit (nvidia-smi), torch/CUDA
            versions; TF32 is switched off for matmul and cuDNN.
2. build    compiles every CUDA kernel of the port from csrc/ (nvcc,
            sm_90a), one nvcc per source in parallel.
3. kernels  each kernel against its plain PyTorch version on the card:
            fused_knn over six metrics, k in {1, 10, 64}, q in {1, 10,
            500}, a ragged n, float32 and bfloat16; the IVF scan with
            sentinel probe slots, -1 padding, a 1-D filter and IP; the
            IVF scan's work items on a list of 1,300 rows (three row
            chunks) probed by most queries, short, empty and padded
            lists, batch 1, 10 and 500, k in {1, 10, 128}, d 128
            (float32 and bfloat16), 100, 33 and 300; the
            IVF-BQ scan over bits 1, 2, 3 (query bits 4, 4, 8), L2 and
            IP, d = 100 (padded lanes), k in {1, 10, 128}, a 1-D filter,
            sentinel and repeated probes and a query that probes
            nothing, at batch 1, 10 and 500 with the wrapper's cluster
            size and (k = 10) every cluster size it can choose;
            select_k over min and max, k in {1, 10, 33, 64, 128}, n in
            {2048, 16384, 100003}, ties, +-inf and NaN rows, all-equal
            rows, a row finite only in its last chunk, float32, bfloat16
            and float16; the CAGRA beam search on a 30,000 x 128 index
            built on the card (cluster-join, degree 64, its first 32
            columns as the degree-32 graph) over L2, L2Sqrt and IP,
            float32, bfloat16 and int8, k in {1, 10, 64}, itopk in {32,
            64, 128, 256, 512}, search_width in {1, 4}, q in {1, 10,
            500}, seeds with -1 holes, ragged row_iters with a 0, two
            random samplings, BQ traversal off and at bits 1 and 2, and
            every cluster size (1-16) forced at q 1, 10 and 90; that
            index saved as an hnswlib file, loaded back and searched
            through the beam kernel, equal to the original's search bit
            for bit at batch 10 and 500 (the file deleted). Ids
            must be equal on integer-valued data (every product exact);
            on Gaussian data distances agree to |dd| <= 1e-4 (1 + |d|)
            and 99% of ids agree. The IVF-BQ scan and the beam search
            take every sum in their plain versions' order
            (ops/bq_scan.tree_sum): their distances, ids and counts
            (rows reranked per query; live iterations, candidates and
            rows scored per query) must equal the plain versions' bit
            for bit. The tiered scan (hot lists on the card, cold lists
            in pinned host memory) on integer-valued and Gaussian data,
            L2 and IP, k in {1, 10, 128}, q in {1, 10, 500}, sentinel
            and repeated probes, -1 padding, a 1-D filter, and splits of
            all-but-one hot, all-but-one cold and alternating, then
            rings smaller than the probed cold set (several waves), a
            request that probes no cold list and an index with no cold
            tier: it equals its plain version (ids exactly on integer
            data) and the all-device scan kernel on the un-split planes
            bit for bit, and stages each probed cold list once; a
            pageable or device cold plane is refused, by the wrapper and
            by the C entry. The dual-source ivf_pq_scan (a tiered index's
            cold code lists staged into a device ring): hot-only,
            half-cold and all-cold splits x the four LUTs x L2/IP and
            pq_dim 240 (the per-pair instance), with the default ring and
            a ring of two lists (waves), equal to the all-device kernel
            and the plain version bit for bit; a pageable or device cold
            plane refused. stream_read_sum over float32 and bfloat16,
            n in {1, 1000, 2^22}, d in {100, 128}: on integer data equal
            to its plain version and the float64 sum; on Gaussian data
            both within 1e-6 sum|x| of the float64 sum per column (the
            summation orders differ).
4. main     SIFT-1M's shape (1,000,000 x 128 float32, 10,000 queries,
            k=10) on clustered data made from --seed. The IVF-Flat path:
            brute-force ground truth through the fused kernel in
            500-query requests; IVF-Flat build (n_lists=1024, the
            sift-128-euclidean config); two same-seed balanced k-means
            fits of all 1M rows and a second IVF-Flat build, each
            torch.equal to the first; search at n_probes 32 and 128,
            batch 10 and 500 (recall@10, median ms per batch);
            n_probes=1024 equals brute force ties aside; save -> load ->
            search is bit-identical. The tiered path on the same index:
            build_tiered(hot_fraction=0.5) (build s, hot and cold bytes,
            the cold plane pinned and modeled host-resident, device
            memory grown by the hot tier only); searches at n_probes 32
            and 128, batch 10 and 500, each equal to the all-device
            search bit for bit (ids and distances), with recall@10,
            median ms, the cold bytes each request probes and the bytes
            and waves it staged (tier.cold_bytes_staged, each probed
            cold list once); one
            placement epoch (batch-500 traffic at the centers of two
            cold lists, probe_histogram window, plan_epoch(max_swaps=4),
            apply_plan(width=4)): both lists hot, tier.swap_bytes = 2 x
            swaps x block bytes, searches still bit-identical; the dual
            roofline (stream_read_sum over the hot plane: device memory
            GB/s; a timed pinned -> device copy of the cold plane: host
            link GB/s), the ring copy's rate (bytes staged by three
            batch-500 requests over their copies' device time, from
            torch.profiler) against the link roofline, and each
            request's hot and cold GB/s against them. The all-device
            scan must not launch
            during the tiered searches. The IVF-BQ path on the same data:
            ivf_bq.build (n_lists=1024, bits 1, the vector plane kept);
            the same four searches (recall@10, median ms, rows
            reranked as a share of rows probed), the requests then
            held against the plain scan on distances, ids and rows
            reranked (at batch 10 every fourth of 100, at batch 500 every
            tenth of 20, spread over the queries: cuts for the time limit);
            n_probes=1024 recall on 1,000 queries; save -> load -> search bit-identical; and
            matrix.select_k(k=10) over a (64, 1,000,000) slab of squared
            distances equals brute force's ids, ties aside. Tiered IVF-BQ
            on that index: build_tiered_bq(hot_fraction=0.5), the five
            record planes' cold halves pinned; 3 requests at (n_probes
            32, batch 10) and (128, 10) and one at (128, 500) (a cut for
            the time limit: the plain fused engine runs them) each equal
            to the all-device kernel's search on distances, ids and rows
            reranked, the plain engine's ms printed. The CAGRA
            path on the same data: cagra.build with the blobs-1M-128
            config's first raft_cagra entry (graph_degree 32,
            intermediate 64, cluster_join) plus bq_bits=1 (build s, -1
            share of the graph, index bytes; the build must launch the
            wide-row select_k kernel 0 times); two same-seed builds on
            the first 200,000 rows (a cut for the time limit) with
            equal graphs and planes; search at itopk 64 and
            128, search_width 4, batch 10 and 500 (recall@10, median
            ms), BQ traversal off; at itopk 64 with it on (recall, rows
            scored exactly as a share of candidates); save -> load ->
            search bit-identical. It fails below recall@10 0.90 at itopk
            128, batch 500, or when BQ-on recall falls more than 0.02
            under BQ-off. Each path
            runs with every launch counter set to 0 just before it, and
            each of its kernels must have launched.
5. serve    the serving path on main's indexes: a SearchExecutor each
            for IVF-Flat (n_probes 32 and 128), IVF-BQ (n_probes 128),
            CAGRA (itopk 64, search_width 4) and brute force, its plans
            captured as CUDA graphs on the ladder 8..512; 200 requests of
            1-500 rows (drawn from --seed) each equal bit for bit to the
            direct search, and no capture after warmup; the tiered index
            (eager plans) on 50 such requests; TierManager epochs on a
            probe-accounting executor over fresh tiered copies of the
            IVF-Flat index, reactive and then with a TierPrefetcher, from
            the same placement (3 epochs, traffic of 64 queries at the
            centers of each of 8 cold lists, n_probes 1, on a
            ManualClock): each plan equal to plan_epoch on the same
            window and promoting those lists, every served and checked
            result bit-identical after each epoch, the epoch ms, prefetch
            hits > 0 and a lower tier.promote_cold_bytes with the
            prefetcher; a DynamicBatcher over the
            IVF-Flat executor fed by drive_open_loop from four threads,
            every result equal to its direct search (p50/p99 latency and
            batch occupancy printed); then the direct, eager-executor and
            captured median ms of the batch-10 and batch-500 requests,
            the direct request's device-busy share (torch.profiler) and
            the captured request's graph replay time (CUDA events). Its
            launches (replays included) add to the kernels line's.
6. ragged   the ragged plan family on serve's indexes: an executor a path
            with packed tiles of 256 rows (IVF-Flat also 64), IVF-Flat
            n_probes {20, 24, 32}, IVF-BQ {72, 96, 128}, CAGRA itopk 64,
            width 4, max_iterations {0, 48, 64}, tiered (eager) like
            IVF-Flat, k {10, 16}: one params class a path. warmup_ragged
            builds one entry a tile; 200 requests of 1-40 rows (from
            --seed) are packed into tiles by a ragged DynamicBatcher's
            grouping, each equal bit for bit to its solo bucketed search
            (IVF-BQ also held against the solo search at k 16 sliced to
            k); no capture after warmup; the packed dispatches' launches
            equal their replays' record; graph pools against serve's
            ladders, the packed tile's replay against the bucketed
            256-row replay, a full tile of requests packed against one by
            one; then a DynamicBatcher on IVF-Flat, bucketed against
            ragged, under the same mixed load from four threads for 2 s
            at the bucketed executor's one-at-a-time rate (p50/p99, rows
            a dispatch, pad waste, dispatches), every result equal to
            its direct search. Its launches add to the kernels line's.
7. pq       the IVF-PQ path on main's data and truth (alone with
            --phases env,build,pq, which makes them): ivf_pq_scan
            against its plain version bit for bit on 252 small cases
            (L2 and IP, both codebook kinds, pq_bits 4 and 8, float32,
            bfloat16 and both fp8 LUTs, k 10 and 258, three draws of
            pq_dim 6/16/64 with no, a shared or a per-query filter,
            ragged sentinel probe slots; 12 tables past shared
            memory, pq_dim 240 and 196; and 48 cases of the list-major
            work items: a list probed by every query, lists past two
            chunks, a batch of one, all four LUTs, k 10 and 258; the
            dual-source cases are in the kernels phase);
            ivf_pq.build with
            the sift-128-euclidean config's raft_ivf_pq entry (n_lists
            1024, pq_dim 64, 8 bits; build s, index bytes) and a second
            same-seed build, torch.equal; full-size requests at n_probes
            32 and 128, batch 10 and 500, the cuda engine equal to the
            plain engine bit for bit; then, counted, those requests
            (recall@10, with refine_ratio 2.0 too, median ms; it fails
            under the refined floor at (128, 500) that PERF.md states);
            tiered IVF-PQ (build_tiered_pq(hot_fraction=0.5), the cold
            codes pinned) at the same four requests, each equal to its
            all-device answer bit for bit, through the dual-source kernel
            (ivf_pq_scan once a request, the plain engine never), with
            recall@10, median ms beside the all-device ms, the code bytes
            staged and the waves, and the staged copies' GB/s
            (torch.profiler) against the host link's 64 GB/s; the
            TierManager epochs of the serve phase on fresh tiered IVF-PQ
            copies (it runs here, where the IVF-PQ index is built);
            executors with captured plans on the ladder 8..512 at
            n_probes 32 and 128 (60 requests of 1-500 rows each equal to
            its direct search, no capture after warmup, graph pools); a
            ragged class (n_probes {72, 96, 128} x k {10, 16}, 256-row
            tiles, 120 requests of 1-40 rows, every packed row equal to
            its solo bucketed search); CAGRA with the IVF-PQ graph
            source (the sift raft_cagra entry: degree 64, intermediate
            128) on the first 200,000 rows (build s, the PQ kernel's
            launches in it, recall@10 at itopk 64 and 128, batch 500, on
            the beam kernel); the kernel's time and bound.
8. distance the distance family on main's data (alone with --phases
            env,build,distance, which makes main's data and IVF-Flat
            index): brute force over all 20 metrics on 1M rows (the main
            rows; |x| rows normalised to sum 1 for KL, JensenShannon and
            Hellinger; x > 0 as 0/1 for Jaccard, Dice, RusselRao and
            Hamming; 1M (lat, lon) radians for Haversine), k 10, at batch
            10 (10 dataset rows as queries, median of 3; each true
            distance finds the row itself at rank 0) and 500 (one call),
            and 10 queries against the first 50,000 rows equal to a
            float64 numpy brute force up to ties; unbalanced k-means
            (1,024 clusters, k-means++, max_iter 20) on the 1M rows, two
            same-seed fits torch.equal, inertia below its seeds', predict
            equal to fused_l2_nn_argmin on 10,000 rows; the IVF-Flat rank
            engine against the kernel at (32, 10) and (128, 500), ids
            equal up to ties; ball cover on 1M Haversine points
            (knn_query for 1,000 queries equal to brute force up to ties;
            eps_nn_query and eps_neighbors, 100 x 1M, equal to pairwise
            <= eps^2); masked_l2_nn for 1,000 queries with main's 1,024
            lists as groups, each query's 32 nearest enabled, equal to a
            masked pairwise argmin; the four gram matrices at 500 x
            100,000 against float64 on a slice; 8 threads asking for
            the default handle get one. Query counts are cut for the time
            limit, never widths. Its launches add to the kernels line's;
            its numbers go to chiprun_out/distance.json.
9. stream   the streaming builds on main's data (alone with --phases
            env,build,stream,dist, which makes main's data, truth and
            in-memory indexes): the 1M rows written as .fbin (512 MB) to
            a temporary directory by the native writer and read back by
            the native reader, equal (write, read and iter_chunks GB/s
            printed; the page cache is warm: the file was just
            written); build_streaming of IVF-Flat (n_lists 1024),
            IVF-PQ (the sift raft_ivf_pq entry) and IVF-BQ (bits 1), each
            at chunk_rows 2^18 and 100,000 (not a divisor): the two
            builds torch.equal (the train sample keeps its stride's phase
            across chunks), build s printed; searches at n_probes {32,
            128} x batch {10, 500} (1,000 and all 10,000 queries) with
            recall@10 and median ms; over the 10,000 queries each
            recall within 0.01 of the in-memory build of the same family
            (the two train on other samples: at 100 queries one draw
            moved IVF-PQ's by 0.015).
            Its launches add to the kernels line's.
10. dist    the mesh layer on 4 shard slots of the card: brute_force_knn and
            its ring form (100 queries) equal single-device brute force, ties
            aside; distributed.kmeans_fit (1,024 clusters, 20 iterations)
            twice, torch.equal, inertia within 1e-4 of single-device Lloyd
            (kmeans.fit) from the same seeds (k-means++ on a 4,096-row
            subsample) and the centers' median relative move from its centers
            within 1e-5 (the gap to the distance phase's fit, seeded on all
            rows, is printed); IVF-Flat by distributed.ivf.build, its
            global-probe searches at (32, 128) x (10, 500) (1,000 and all
            10,000 queries: 100 and 20 timed requests) equal to main's IVF-Flat
            bit for bit, local probes at 0.9 of the global recall at (128,
            500), the bf16 and int8 probe wires at 0.99 and 0.95 of the f32
            wire's ids (these on the first 1,000 queries), save -> load ->
            search bit-identical; distributed.ivf.build_streaming from stream's
            .fbin (recall within 0.01 of the single-device streamed build,
            dealt); the same checks for IVF-PQ and IVF-BQ, dealt from the pq
            and main phases' indexes (their single-device builds are not
            repeated: a cut for the time limit); a ShardedIndex of 4 CAGRA
            sub-indexes on the first 200,000 rows (recall@10 >= 0.90 at itopk
            64, batch 500). The rank-major engines on the three dealt
            indexes at (32, 10) (200 queries) and (128, 500) (1,000 queries),
            each request equal to the single-device rank search of its family
            bit for bit, the median ms beside the list-major engine's; a
            codes-only 4-slot IVF-BQ index (main's with its rerank plane
            dropped) searched at the merge overfetch depth, equal to the
            single-device codes-only search, recall@10 raw and refined. The
            IVF scan, the BQ scan, ivf_pq_scan and the beam search must launch
            in the phase; its launches add to the kernels line's. Its numbers
            go to chiprun_out/dist.json. It keeps the three dealt indexes for
            the next two phases.
11. meshserve  the executor's mesh plans on dist's indexes (alone with
            --phases env,build,dist,meshserve,observe): an executor a
            family (IVF-Flat, IVF-PQ on the sift raft_ivf_pq entry, IVF-BQ
            bits 1), the ladder 8..512 at n_probes {32, 128} captured
            (capture s, graph-pool bytes); 200 requests of 1-500 rows
            (from --seed) each equal to distributed.search* bit for bit,
            no capture after warmup, kernel #2, ivf_pq_scan and #4
            launched; direct and captured median ms at (32, 10), (128,
            10) and (128, 500) over 20 timed requests a point, beside
            serve's single-device captured ms; a 2 x 2 grid (2 list x 2
            query slots, query_axis) equal to the 1-D plan bit for bit
            (global probes); a ragged DynamicBatcher (n_probes 20/24/32, 256-row
            tiles) fed from 4 threads with 160 requests of 1-40 rows, each
            equal to its solo search (pad waste printed); the probe
            histogram of 8 requests equal to the single-device
            executor's in the dealt order; mesh_trace on a captured plan:
            the phase spans over the merged outputs' readiness and one
            serving.mesh.shard span a slot from the event its graph records
            after that slot's scan (4 distinct readings a dispatch, none past
            the merged readiness), the straggler gauges set, no capture
            after warmup; a rank-engine mesh plan, eager (IVF-Flat) and
            captured (codes-only IVF-BQ), equal to its direct search bit for
            bit. Its launches add to the kernels line's; its numbers go to
            chiprun_out/meshserve.json.
12. observe the observability plane over a served run: a
            MetricsExporter on 127.0.0.1 over a probe-accounting executor
            serving the single-device and the dist IVF-Flat indexes
            (n_probes 32), a TierManager, a memory ledger and an
            IndexGauge (shadow recall through brute force at a 10%
            sample, drift), a batcher fed from 4 threads (800 requests of
            1-40 rows, each equal to its direct search); /profile?seconds=1
            during the traffic, attributed against executable_costs():
            every entry that served in the window gets measured device
            seconds from its timed calls (CUDA events), printed beside
            the kernels the trace saw, and device_achieved_gbps beside
            the modeled bytes; ContinuousCapture's two 0.05 s windows
            under its 1% budget move rolling_*; /metrics, /snapshot.json,
            /trace.json?trace_id=, /memory.json, /tier.json, /index.json;
            the shadow-recall Wilson interval must contain the recall@10
            measured against brute-force truth, and the drift score of
            queries shifted by one list's centre offset must exceed the
            in-distribution one; a FlightRecorder attached while the
            batcher serves from 4 threads, its latency threshold the
            served p50 (below the served p99), fires on a scrape, and its
            incident's capture of that traffic is attributed to every
            entry that served in it (/incident.json answers 200); a
            FleetAggregator over two exporters in this
            process (one replica each) sums the replicas' lifetime
            counters exactly and takes the fleet p99 from the merged
            histogram; /memory_profile before and after an
            ivf_flat.extend of 100,000 rows shows its allocation. Its
            numbers go to chiprun_out/observe.json.
13. fleet   the fleet layer on main's IVF-Flat index (alone with --phases
            env,build,main,fleet): its own build_tiered(hot_fraction=0.5)
            behind a probe-accounting executor (the ladder 8..512 warmed)
            and a DynamicBatcher fed from 4 threads (240 requests of 1-40
            rows, 3 in 4 at the centers of 16 cold lists), while a
            FleetPlanner over a FleetAggregator of two exporters plans 4
            epochs whose placement deltas for the replica go through
            tiered.apply_plan(width=8, executor=): every served request
            equal to the all-device IVF-Flat search bit for bit, 0
            captures after warmup, tier_scan launched (epoch ms, swap
            bytes, served p50/p99 printed); a QueryRouter over a 4-replica
            harness behind an exporter: /route.json 404 before a table and
            200 after a push, a newer push 200, a stale one 409,
            fleet_route_* in /metrics; merge_fanout of device-tensor parts
            equal to the numpy-part merge on the f32 and bf16 wires. Its
            launches add to the kernels line's; its numbers go to
            chiprun_out/fleet.json.
14. prims   the primitives (alone with --phases env,prims; it makes its
            own data from --seed): make_blobs 100,000 x 128 float32 in 16
            blobs (cluster_std 1.0, center_box (-10, 10); the rows a cut
            from 1M for the time limit); single_linkage (k 15,
            L2SqrtExpanded, 16 clusters): its kNN search (fused_knn in
            512-row blocks, k + 1 = 16) held against fused_knn_plain on
            its first, middle and ragged last block (distances within
            1e-4 (1 + |d|), or at a row's match with itself within the
            root of 2^-18 (|q|^2 + |x|^2); ids equal but at float64
            ties), the first forest (knn_graph s, MST s) weighing what
            scipy's minimum_spanning_tree of the same symmetrized graph
            weighs (float64, 1e-5 relative), then the user call counted
            (fused_knn must launch; its launches add to the kernels
            line's #1; connect rounds >= 1, s) with a dendrogram that is
            one binary tree over the points, labels equal to scipy's
            components of its first n - 16 merges (the tree less its 15
            heaviest edges) and its ARI against the blobs;
            spectral.partition (16 clusters) of the unit-weight
            symmetrized 15-NN graph joined with the MST's edges, and
            lanczos_smallest (k 17) on its Laplacian: eigenvalues
            ascending in [-1e-5, 2 + 1e-5], Ritz vectors orthonormal
            within 1e-3, Rayleigh quotients (float64 on the host) within
            1e-4 of their eigenvalues, the residuals, modularity and ARI
            printed; linear_assignment at n 2,048 on integer costs in [0,
            1000), its total equal to scipy's linear_sum_assignment
            exactly (phases, bidding rounds and s printed);
            sparse.neighbors.brute_force_knn on the BigANN'23 sparse
            track's shape (30,109 columns, ~120 nonzeros a document row,
            ~49 a query, synthetic integer values; 100,000 rows and 1,000
            queries, cuts from 8.8M rows), inner product, k 10: 100 of the
            queries' ids equal to a float64 scipy.sparse product's top-10,
            ties by the smaller id; make_blobs at 1,000,000 x 128 with
            stats.cov and stats.meanvar within 1e-4 / 1e-5 of float64
            numpy; and a sweep of every other public function of the
            primitive modules at a small size, each held against the same
            call with device="cpu" (integer data exactly, float32 within
            rtol/atol 1e-5 elementwise and 1e-4 for products and solvers,
            eigen- and singular vectors up to sign, random draws by their
            moments). Its numbers go to chiprun_out/prims.json.
15. bench   the ANN benchmark harness (alone with --phases env,build,bench;
            it makes its own data from --seed) through its CLI's own code
            path (raft_tpu_torch.bench.__main__.main) in a temporary
            directory: get-dataset blobs 100,000 x 128, 1,000 queries,
            k 100, euclidean, on the card (the bundled config
            blobs-100000-128's own shape), its ground truth held for 100
            sampled queries against float64 numpy on base.fbin (ids equal
            but at float64 ties, distances within 1e-4 (1 + |d|)); run
            --config blobs-100000-128 -k 10 at batch 1,000 over
            raft_brute_force, raft_ivf_flat, raft_ivf_pq, raft_ivf_bq,
            raft_cagra, raft_quantized and ivf_flat_cpu, every search entry
            of the config, then at batch 10 (one timed pass) over
            raft_ivf_flat and raft_cagra; a second run with
            --require-cached-index over raft_ivf_flat, raft_ivf_pq and
            raft_cagra (every row build_cached, recall equal to the first
            run's); hnswlib on its own 10,000-row tree with 500 queries
            (a cut: its build and searches are one host thread); data-export, and plot where matplotlib
            imports. The runs' launches are counted (fused_knn, the IVF
            scan, ivf_pq_scan, bq_scan and the beam walk must launch) and
            add to the kernels line's. Then, on the sweep's own indexes
            (the runner's cache files), one search at the sweep's
            parameters against the plain engine: brute force's two
            fused_knn blocks (512 and 488 rows; L2Sqrt, k 10) against
            fused_knn_plain within the kernels phase's tolerance;
            IVF-Flat at n_probes 256 = n_lists against brute force (ids
            equal but at float64 ties); IVF-PQ at n_probes 128 without and
            with refine_ratio 2.0, IVF-BQ bits 2 at n_probes 64 (80
            candidates, refine_ratio 8.0: ids, distances and rows
            reranked) and CAGRA at itopk 256 and at itopk 128 with
            seed_pool 2048 (the first 256-row query tile's walk: ids,
            distances and counts), each bit for bit.
            Then run_prims("small", budget_s=0.5) on the card (its
            launches counted and added too; any record with "error"
            fails), and each prim that launches a kernel (fused_knn f32
            and bf16, ivf_flat_search, select_k_pallas, stream_read_*)
            held once against its plain version at the prim's shape. Its
            numbers go to chiprun_out/bench.json.
16. times   per kernel at the main path's shapes: kernel ms (CUDA
            events, median after warm-up), its plain version's ms, the
            bound (the larger of bytes over 3.35 TB/s, host-link bytes
            over 64 GB/s (PCIe Gen5 x16, one direction), and operations
            over their type's peak: float32 at 67 TFLOP/s, popcount and
            other int32 at 16 and 64 per clock per SM over 132 SMs at
            1.98 GHz; the H100 SXM's published figures) and one PyTorch
            yardstick call's ms. The tiered scan's hot and cold GB/s
            are printed against the two rooflines of the main phase; the
            IVF-BQ scan is timed at every cluster size at batch 10 and
            500; the IVF scan and the beam walk also at batch 10 (the
            walk with its cluster size at both batches), matrix.select_k
            (AUTO) at the CAGRA build's shape and select_k at the main
            path's (64, 1,000,000), k = 10 slab; fused_knn on float32
            (bound: 3xTF32, three TF32 tensor-core products a multiply-add,
            at 494.7 TFLOP/s, the CUDA-core figure beside it) and on the
            same rows in bfloat16 (bf16 products at 989.4 TFLOP/s); the
            redesigned kernels print their earlier design's times beside
            theirs.
17. profile (not in the default run) torch.profiler over five requests
            of each kind, the brute-force request first: device time by
            kernel name, and select_k's split between its memset and its
            kernel at the main path's call and at 64 x 2^20.

The line before the last is a JSON object with one record per kernel
(fused_knn, list_major_scan, bq_scan, select_k, beam_search, tier_scan,
stream_read_sum, and ivf_pq_scan, the port kernel with no TPU
counterpart);
the last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the raft_tpu_torch package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import gc
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

# past this many seconds the run prints every thread's stack and exits
# with status 1: a run that stalls ends inside its 1,200 s limit, saying
# where it stalled
RUN_LIMIT_S = 1170
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# PCIe Gen5 x16, one direction: half of the data sheet's 128 GB/s, which
# counts both
HOST_LINK_BYTES_PER_S = 64e9
# operations per second by type: float32 outside the tensor cores (data
# sheet); __popc and other 32-bit integer ops at 16 and 64 per clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) over the SXM part's 132 SMs at its 1.98 GHz
# boost clock
_SM_CLOCKS_PER_S = 132 * 1.98e9
# and the dense tensor-core rates of the data sheet: TF32 494.7 TFLOP/s,
# bf16 989.4 TFLOP/s; "smem": 4-byte shared-memory loads, 32 banks a clock
# per SM (one word a bank), the LUT lookups' rate
PEAK_OPS_PER_S = {"f32": 67e12, "popc": 16 * _SM_CLOCKS_PER_S,
                  "int32": 64 * _SM_CLOCKS_PER_S, "tf32": 494.7e12,
                  "bf16": 989.4e12, "smem": 32 * _SM_CLOCKS_PER_S}
N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS = 1024
# the kernels' times in their earlier design (one block a query; cold rows
# read in place from pinned memory), at the same requests, as PERF.md
# records them (NVIDIA H100 80GB HBM3 at 700 W): bq_scan at n_probes 128
# by batch (torch.profiler at batch 10, CUDA events at batch 500),
# tier_scan at n_probes 128, batch 500
EARLIER_BQ_MS = {10: 9.5415, 500: 12.6976}
EARLIER_TIER_MS = 28.2238
# the IVF-Flat scan and the beam walk before their redesign, at n_probes
# 128 / itopk 64, batch 500 (PERF.md, the same card)
EARLIER_SCAN_MS = 6.2678
EARLIER_BEAM_MS = 0.3397
# fused_knn (CUDA-core products) at the brute-force request and select_k
# (one warp insertion a value) at its two shapes, k = 64, before their
# redesign (PERF.md, the same card)
EARLIER_KNN_MS = 7.9003
EARLIER_SELECT_MS = {"64x2^20": 0.5834, "2048x2048": 0.2145}
# ivf_pq_scan before its redesign (one block a (query, probe slot)) at
# (n_probes 128, batch 500) and (32, 10), by batch (PERF.md, the same card)
EARLIER_PQ_MS = {500: 17.1268, 10: 0.3131}
# the rows of the second CAGRA build that checks reproducibility: a cut of
# the 1M rows that keeps the run inside its time limit
CAGRA_REPRO_ROWS = 200_000


def cagra_params(cagra):
    """The blobs-1M-128 config's first raft_cagra entry, with bq_bits=1."""
    return cagra.CagraIndexParams(
        graph_degree=32, intermediate_graph_degree=64,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN, bq_bits=1)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call device times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(name, got, want, exact_ids: bool):
    """Kernel (got) vs plain version (want): returns max |dd| over
    finite slots; fails on a mismatch beyond the stated tolerance."""
    import torch

    gd, gi = got
    wd, wi = want
    torch.cuda.synchronize()
    if gd.shape != wd.shape or gi.shape != wi.shape:
        fail(f"{name}: shape {tuple(gd.shape)} vs {tuple(wd.shape)}")
    fin = torch.isfinite(wd)
    if not torch.equal(fin, torch.isfinite(gd)):
        fail(f"{name}: filled slots differ")
    if not torch.equal(gd[~fin], wd[~fin]):
        fail(f"{name}: unfilled slots differ")
    err = (gd[fin] - wd[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    tol = 1e-4 * (1.0 + wd[fin].abs())
    if bool((err > tol).any()):
        fail(f"{name}: distance error {max_err} beyond 1e-4 (1 + |d|)")
    if exact_ids:
        if not torch.equal(gi, wi):
            bad = int((gi != wi).sum())
            fail(f"{name}: {bad} ids differ on integer-valued data")
    elif float((gi == wi).float().mean()) < 0.99:
        fail(f"{name}: fewer than 99% of ids agree")
    return max_err


# ---------------------------------------------------------------------------


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    log(f"[env] allow_tf32 before: matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log("[env] allow_tf32 set: matmul=False cudnn=False")
    return {"card": card}


def phase_build() -> None:
    from raft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        with open(path + ".log") as f:
            usage = [ln.strip() for ln in f if "registers" in ln]
        for ln in usage:
            log(f"[build] {name}: {ln}")
        _build.load(name)


def _int_data(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def phase_kernels(torch, seed: int) -> None:
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.fused_topk import (
        _SUPPORTED_METRICS,
        fused_knn,
        fused_knn_plain,
    )
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n, d = 20_011, 128          # ragged: not a multiple of any tile
    checks = 0
    # integer-valued data: +-1 entries give every row the same norm, so
    # cosine orders exactly by the (exact) inner product, and many exact
    # ties test the smallest-id order; duplicate rows included
    x_int = np.where(rng.random((n, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    x_int[777] = x_int[5]
    x_int[19_000] = x_int[5]
    q_int = np.where(rng.random((500, d)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    q_int[0] = x_int[5]         # distance 0 to three duplicate rows
    x_g = rng.standard_normal((n, d)).astype(np.float32)
    q_g = rng.standard_normal((500, d)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        for data, queries, exact in ((x_int, q_int, True), (x_g, q_g, False)):
            xt = torch.from_numpy(data).to(dev, dtype)
            for metric in _SUPPORTED_METRICS:
                for k in (1, 10, 64):
                    for q in (1, 10, 500):
                        qt = torch.from_numpy(queries[:q]).to(dev)
                        got = fused_knn(qt, xt, k, metric)
                        torch.cuda.synchronize()
                        want = fused_knn_plain(qt, xt, k, metric)
                        compare(f"fused_knn {metric.name} {dtype} k={k} "
                                f"q={q} exact={exact}", got, want, exact)
                        checks += 1
    log(f"[kernels] fused_knn: {checks} cases agree with the plain version")

    # IVF scan on a small packed index: 64 lists with -1 padding
    from raft_tpu_torch.neighbors._packing import pack_padded_lists, padded_extent

    n_lists, ns = 64, 12_000
    labels = torch.from_numpy(rng.integers(0, n_lists, ns)).to(dev)
    sizes = torch.bincount(labels, minlength=n_lists)
    m = padded_extent(sizes)
    cases = 0
    for data, exact in ((_int_data(rng, (ns, d)), True),
                        (rng.standard_normal((ns, d)).astype(np.float32),
                         False)):
        data[100] = data[7]
        ids = torch.arange(ns, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            (packed, indices), _ = pack_padded_lists(
                labels, n_lists, m,
                [(torch.from_numpy(data).to(dev, dtype), 0), (ids, -1)])
            pf = packed.to(torch.float32)
            norms = torch.where(indices >= 0, (pf * pf).sum(dim=2),
                                torch.full_like(indices, float("inf"),
                                                dtype=torch.float32))
            qf = torch.from_numpy(data[:300] + 0.5 if exact else
                                  data[:300] * 0.9).to(dev)
            probes = torch.from_numpy(
                rng.integers(0, n_lists, (300, 12))).to(dev, torch.int32)
            probes[::3, 5:] = n_lists                 # sentinel slots
            probes[1, 1] = probes[1, 0]               # repeated probe
            filt = torch.from_numpy(
                rng.integers(0, 2**31, -(-ns // 32))).to(dev, torch.int32)
            for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
                for fw in (None, filt):
                    for k in (1, 10, 128):
                        args = (qf, packed, norms, indices, probes, fw)
                        got = list_major_scan(*args, k=k, metric=metric,
                                              engine="cuda")
                        torch.cuda.synchronize()
                        want = list_major_scan(*args, k=k, metric=metric,
                                               engine="torch")
                        compare(f"list_major_scan {metric.name} {dtype} "
                                f"k={k} filter={fw is not None} "
                                f"exact={exact}", got, want, exact)
                        cases += 1
    log(f"[kernels] list_major_scan: {cases} cases agree with the plain "
        "version")
    kernels_scan_items(torch, seed)
    kernels_bq(torch, seed)
    kernels_select(torch, seed)
    kernels_beam(torch, seed)
    kernels_tier(torch, seed)
    kernels_pq_tiered(torch, seed)
    kernels_stream(torch, seed)


def kernels_scan_items(torch, seed: int) -> None:
    """The IVF scan's work items across their shapes, on integer data
    (exact ids): a list of 1,300 rows (three 512-row chunks) probed by
    most queries (several query groups), short, empty and padded lists,
    batch 1, 10 and 500 (narrow and wide items), k in {1, 10, 128}, d
    128 (float32 and bfloat16), 100, 33 (element copies) and 300 (queries
    staged a stage at a time), L2 and IP."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)
    sizes = [1300, 7, 0, 515, 64, 0, 200, 33]
    n_lists, m = len(sizes), max(sizes) + 9
    cases = 0
    for d, dtype in ((128, torch.float32), (128, torch.bfloat16),
                     (100, torch.float32), (33, torch.float32),
                     (300, torch.float32)):
        data = np.zeros((n_lists, m, d), np.float32)
        indices = np.full((n_lists, m), -1, np.int32)
        row = 0
        for lid, size in enumerate(sizes):
            data[lid, :size] = rng.integers(-3, 4, (size, d))
            indices[lid, :size] = np.arange(row, row + size)
            row += size
        pt = torch.from_numpy(data).to(dev, dtype)
        it = torch.from_numpy(indices).to(dev)
        pf = pt.to(torch.float32)
        norms = torch.where(it >= 0, (pf * pf).sum(dim=2),
                            torch.full_like(it, float("inf"),
                                            dtype=torch.float32))
        for q in (1, 10, 500):
            qf = torch.from_numpy(rng.integers(-3, 4, (q, d)).astype(
                np.float32)).to(dev)
            probes = rng.integers(0, n_lists, (q, 5)).astype(np.int32)
            probes[: q * 3 // 4, 0] = 0
            probes[::5, 3:] = n_lists
            probes = torch.from_numpy(probes).to(dev)
            for metric in (DistanceType.L2Expanded,
                           DistanceType.InnerProduct):
                for k in (1, 10, 128):
                    args = (qf, pt, norms, it, probes, None)
                    got = list_major_scan(*args, k=k, metric=metric,
                                          engine="cuda")
                    torch.cuda.synchronize()
                    want = list_major_scan(*args, k=k, metric=metric,
                                           engine="torch")
                    compare(f"list_major_scan items d={d} {dtype} q={q} "
                            f"k={k} {metric.name}", got, want, True)
                    cases += 1
    log(f"[kernels] list_major_scan work items: {cases} cases (long, short "
        "and empty lists, narrow and wide items, d 33-300) agree with the "
        "plain version, ids exactly")


def kernels_bq(torch, seed: int) -> None:
    """The IVF-BQ scan kernel against its plain version on a small index
    built on the card: d = 100, so dim_ext = 128 has padded lanes."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.ops.bq_scan import auto_query_bits, bq_list_major_scan

    from raft_tpu_torch.ops.bq_scan import CLUSTER_SIZES, _bq_scan_cuda

    dev = torch.device("cuda")
    res = Resources(device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 1)
    n, d, n_lists, nq = 20_000, 100, 64, 500
    centers = rng.standard_normal((40, d)) * 3
    x = (centers[rng.integers(0, 40, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    qf = torch.from_numpy((centers[rng.integers(0, 40, nq)]
                           + rng.standard_normal((nq, d))).astype(
                               np.float32)).to(dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (nq, 12))).to(
        dev, torch.int32)
    probes[::3, 6:] = n_lists                     # sentinel slots
    probes[1, 1] = probes[1, 0]                   # repeated probe
    probes[4, :] = n_lists                        # a query probing nothing
    filt = torch.from_numpy(rng.integers(0, 2**31, -(-n // 32))).to(
        dev, torch.int32)
    cases = rows = 0
    chosen = {}
    for bits in (1, 2, 3):
        for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
            idx = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(
                n_lists=n_lists, bits=bits, metric=metric), x)
            if idx.dim_ext != 128 or idx.size != n:
                fail(f"ivf_bq.build: dim_ext {idx.dim_ext}, size {idx.size}")
            qrot = qf @ idx.rotation.T
            crot = idx.centers @ idx.rotation.T
            for fw in (None, filt):
                args = (qf, qrot, crot, idx.codes, idx.rnorm, idx.cfac,
                        idx.errw, idx.indices, idx.data, idx.data_norms,
                        probes, fw)
                for k in (1, 10, 128):
                    kw = dict(k=k, metric=metric, epsilon=3.0,
                              query_bits=auto_query_bits(bits))
                    want = bq_list_major_scan(*args, engine="torch", **kw)
                    name = (f"bq_scan bits={bits} {metric.name} k={k} "
                            f"filter={fw is not None}")
                    # the wrapper's own cluster size at batch 1, 10, 500;
                    # at k = 10 every cluster size it can choose too
                    sizes = [None] + (list(CLUSTER_SIZES) if k == 10 else [])
                    for q in (1, 10, nq):
                        sub = [a[:q] if i in (0, 1, 10) else a
                               for i, a in enumerate(args)]
                        want_q = (want if q == nq else bq_list_major_scan(
                            *sub, engine="torch", **kw))
                        for c in sizes:
                            got = (bq_list_major_scan(*sub, engine="cuda",
                                                      **kw) if c is None
                                   else _bq_scan_cuda(*sub, cluster=c, **kw))
                            used = bq_list_major_scan.last_cluster
                            if c is None:
                                chosen[q] = used
                            elif used != c:
                                fail(f"{name} q={q}: cluster {c} asked, "
                                     f"{used} launched")
                            bq_equal(f"{name} q={q} cluster={used}", got,
                                     want_q)
                            if q > 4 and int(got[2][4]) != 0:
                                fail(f"{name}: a query that probes nothing "
                                     "reranked rows")
                            cases += 1
                            rows += int(got[2].sum())
    if chosen[10] <= 1:
        fail(f"bq_scan at batch 10 launched a cluster of {chosen[10]}")
    log(f"[kernels] bq_scan: {cases} cases equal the plain version bit for "
        f"bit ({rows} rows reranked in all, the same count per query); "
        f"every cluster size {list(CLUSTER_SIZES)} at batch 1, 10 and {nq}; "
        f"the wrapper chose clusters of {chosen} CTAs by batch")


def bq_equal(name, got, want) -> float:
    """The IVF-BQ kernel's (distances, ids, rows reranked per query)
    against its plain version's: all three must be equal. Returns the
    measured max |dd| over the filled slots."""
    import torch

    torch.cuda.synchronize()
    for what, g, w in zip(("distances", "ids", "rows reranked"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            fail(f"{name}: {bad} {what} differ from the plain version")
    fin = torch.isfinite(want[0])
    err = (got[0][fin] - want[0][fin]).abs()
    return float(err.max()) if err.numel() else 0.0


def kernels_select(torch, seed: int) -> None:
    """The select_k kernel against its plain version: integer values (many
    exact ties), rows short of finite values, NaN, all-equal rows, a row
    finite only in its last chunk; float32, bfloat16 and float16; narrow
    rows (a warp a row) and wide ones (blocks a row, merged by the last)."""
    from raft_tpu_torch.ops.fused_topk import (
        _select_plan,
        select_k_tiles,
        select_k_tiles_plain,
    )

    rng = np.random.default_rng(seed + 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0
    for n in (2048, 16_384, 100_003):
        base = rng.integers(-1000, 1000, (40, n)).astype(np.float32)
        splits, chunk = _select_plan(40, n, sms)
        for select_min in (True, False):
            v = base.copy()
            far = np.inf if select_min else -np.inf
            v[3, 7:] = far                        # 7 finite values only
            v[4, ::5] = np.nan
            v[5, :] = -far                        # never enters
            v[6, :] = 5.0                         # all equal
            v[7, :(splits - 1) * chunk] = far     # finite in the last chunk
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                vt = torch.from_numpy(v).to("cuda", dtype)
                for k in (1, 10, 33, 64, 128):
                    got = select_k_tiles(vt, k, select_min)
                    torch.cuda.synchronize()
                    want = select_k_tiles_plain(vt, k, select_min)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        fail(f"select_k n={n} k={k} min={select_min} "
                             f"{dtype}: differs from the plain version")
                    cases += 1
    log(f"[kernels] select_k: {cases} cases equal the plain version")


def beam_equal(name, got, want) -> float:
    """The beam kernel's (distances, ids, counts) against its plain
    version's: all three must be equal. Returns the measured max |dd|
    over the filled slots."""
    import torch

    torch.cuda.synchronize()
    for what, g, w in zip(("distances", "ids", "counts"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            fail(f"{name}: {bad} {what} differ from the plain version")
    fin = torch.isfinite(want[0])
    err = (got[0][fin] - want[0][fin]).abs()
    return float(err.max()) if err.numel() else 0.0


def kernels_beam(torch, seed: int) -> None:
    """The CAGRA beam kernel against its plain version on a 30,000 x 128
    clustered index built on the card: every metric, dataset type, k,
    itopk, width, degree and batch size of the contract, covered in
    rotation, with real coarse seeds (-1 holes punched in), ragged
    budgets and the BQ plane at bits 1 and 2."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain
    from raft_tpu_torch.ops.bq_scan import auto_query_bits

    res = Resources(device="cuda", seed=seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)
    n, d = 30_000, 128
    centers = torch.randn(300, d, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 300, (n + 500,), generator=g, device="cuda")
    pts = centers[lab] + torch.randn(n + 500, d, generator=g, device="cuda")
    x, qx = pts[:n].contiguous(), pts[n:].contiguous()
    index = cagra.build(res, cagra.CagraIndexParams(
        graph_degree=64, intermediate_graph_degree=128,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN), x)
    scale = 127.0 / float(x.abs().max())
    datasets = {torch.float32: (x, qx), torch.bfloat16: (x.to(torch.bfloat16),
                                                         qx),
                torch.int8: (torch.round(x * scale).to(torch.int8),
                             qx * scale)}
    planes = {}
    metrics = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.InnerProduct)
    itopks, ks, qs = (32, 64, 128, 256, 512), (1, 10, 64), (1, 10, 500)
    shapes = ((1, 32), (4, 32), (1, 64), (4, 64))
    cases = i = 0
    walked = scored = fresh = 0
    for dtype, (data, queries) in datasets.items():
        for metric in metrics:
            for _ in range(3):
                L, k = itopks[i % 5], min(ks[(i // 2) % 3], itopks[i % 5])
                w, deg = shapes[i % 4]
                q = qs[(i // 3) % 3]
                bits = (0, 1, 2)[(i // 4) % 3]
                samplings = 2 if i % 5 == 1 else 1
                i += 1
                qt = queries[:q]
                c = w * deg
                n_seeds = -(-max(L, c) * samplings // c) * c
                seeds = cagra._make_seeds(
                    data, index.seed_centers, index.seed_members, qt,
                    n_seeds, metric, "coarse", 0)
                seeds[:, 1::5] = -1                   # holes in the seeds
                max_iters = L // w + 24
                kw = dict(deg=deg)
                if q > 1 and i % 2 == 0:              # ragged, one 0 budget
                    ri = torch.randint(0, max_iters, (q,), generator=g,
                                       device="cuda", dtype=torch.int32)
                    ri[0] = 0
                    kw["row_iters"] = ri
                if bits:
                    key = (dtype, bits)
                    if key not in planes:
                        planes[key] = cagra._build_bq_plane(
                            data.to(torch.float32), bits, seed)
                    rot, crot, recs = planes[key]
                    kw.update(bq_records=recs, bq_qrot=qt @ rot.T,
                              bq_crot=crot, bq_bits=bits,
                              bq_query_bits=auto_query_bits(bits))
                args = (qt, data, index.graph, seeds, k, L, w, max_iters,
                        metric)
                got = beam_search(*args, **kw)
                torch.cuda.synchronize()
                want = beam_search_plain(*args, **kw)
                beam_equal(f"beam_search {metric.name} {dtype} k={k} L={L} "
                           f"w={w} deg={deg} q={q} bits={bits} "
                           f"samplings={samplings} "
                           f"ragged={'row_iters' in kw}", got, want)
                cases += 1
                walked += int(want[2][:, 0].sum())
                fresh += int(want[2][:, 1].sum())
                scored += int(want[2][:, 2].sum())
    log(f"[kernels] beam_search: {cases} cases equal the plain version bit "
        f"for bit ({walked} iterations, {fresh} candidates, {scored} rows "
        "scored in all, the same counts per query)")
    # every cluster size the kernel takes, forced, exact and BQ traversal
    from raft_tpu_torch.ops import beam_search as bs

    data, queries = datasets[torch.float32]
    metric = DistanceType.L2Expanded
    sizes = set()
    for bits in (0, 1):
        for q in (1, 10, 90):
            qt = queries[:q]
            seeds = cagra._make_seeds(data, index.seed_centers,
                                      index.seed_members, qt, 256, metric,
                                      "coarse", 0)
            kw = dict(row_iters=None, bq_records=None, bq_qrot=None,
                      bq_crot=None, bq_bits=0, bq_query_bits=4,
                      bq_epsilon=3.0, deg=64)
            if bits:
                rot, crot, recs = planes.get((torch.float32, 1)) or \
                    cagra._build_bq_plane(data, 1, seed)
                kw.update(bq_records=recs, bq_qrot=qt @ rot.T, bq_crot=crot,
                          bq_bits=1, bq_query_bits=auto_query_bits(1))
            args = (qt, data, index.graph, seeds, 10, 128, 4, 56, metric)
            checked = bs._check_args(*args[:7], metric, 64, None,
                                     kw["bq_records"], kw["bq_qrot"],
                                     kw["bq_crot"], kw["bq_bits"])
            want = bs.beam_search_plain(*args, **kw)
            for c in bs.CLUSTER_SIZES:
                got = bs._beam_search_cuda(*args, checked, cluster=c, **kw)
                sizes.add(bs.beam_search.last_cluster)
                beam_equal(f"beam_search cluster={c} q={q} bits={bits}", got,
                           want)
                cases += 1
    log(f"[kernels] beam_search: every cluster size {sorted(sizes)} equals "
        f"the plain version bit for bit ({cases} cases in all)")
    kernels_hnsw(torch, res, index, qx)


def kernels_hnsw(torch, res, index, queries) -> None:
    """The CAGRA index saved as an hnswlib file, loaded back on the card
    and searched through the beam kernel: graph and vectors equal, and
    the search equal to the original index's bit for bit (both seeded
    from the strided pool: a loaded index has no seed plane)."""
    import tempfile

    from raft_tpu_torch.neighbors import cagra, hnsw
    from raft_tpu_torch.ops.beam_search import beam_search

    fd, path = tempfile.mkstemp(suffix=".hnsw")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        hnsw.save_hnswlib(res, index, path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = hnsw.load_hnswlib(res, path, index.dataset.shape[1],
                                   metric=index.metric)
        load_s = time.perf_counter() - t0
    finally:
        os.remove(path)
    if loaded.dataset.device != index.dataset.device or not (
            torch.equal(loaded.graph, index.graph)
            and torch.equal(loaded.dataset, index.dataset)):
        fail("hnsw: the loaded index differs from the saved one")
    sp = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                 seed_mode="pool")
    launches = 0
    for q in (10, 500):
        want = cagra.search(res, sp, index, queries[:q], 10)
        n0 = beam_search.launches
        got = cagra.search(res, sp, loaded, queries[:q], 10)
        torch.cuda.synchronize()
        launches += beam_search.launches - n0
        if beam_search.launches == n0:
            fail("hnsw: the loaded index's search did not launch the beam "
                 "kernel")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            fail(f"hnsw: the loaded index searches unlike the original at "
                 f"batch {q} ({int((got[1] != want[1]).sum())} ids)")
    log(f"[kernels] hnsw: the {index.dataset.shape[0]} x "
        f"{index.dataset.shape[1]} CAGRA index (degree "
        f"{index.graph.shape[1]}) saved as an hnswlib file ({nbytes} bytes, "
        f"{save_s:.2f} s), loaded back ({load_s:.2f} s, the file deleted): "
        "graph and vectors equal, and its search through the beam kernel "
        f"({launches} launches) equals the original's bit for bit at batch "
        "10 and 500")


def _split_tiers(torch, data, hot_lists, cold_lists):
    """A tiered split of a packed (n_lists, m, d) plane on the card: the
    hot lists' blocks stay on the card, the cold lists' go to pinned host
    memory; with the slot maps."""
    from raft_tpu_torch.neighbors.tiered import _slot_maps

    hmap, cmap = _slot_maps(np.asarray(hot_lists), np.asarray(cold_lists),
                            data.shape[0])
    idx = torch.as_tensor(np.asarray(hot_lists), device=data.device)
    cdx = torch.as_tensor(np.asarray(cold_lists), device=data.device)
    return (data[idx].contiguous(), data[cdx].cpu().pin_memory(),
            torch.from_numpy(hmap).to(data.device),
            torch.from_numpy(cmap).to(data.device))


def kernels_tier(torch, seed: int) -> None:
    """The tiered scan kernel against its plain version and against the
    all-device scan kernel on the un-split planes, on a 64-list packed
    index with -1 padding; then a pageable and a device cold plane, which
    the wrapper and the C entry must refuse."""
    from raft_tpu_torch.core.validation import RaftError
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors._packing import pack_padded_lists, padded_extent
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 4)
    n_lists, ns, d = 64, 12_000, 128
    labels = torch.from_numpy(rng.integers(0, n_lists, ns)).to(dev)
    m = padded_extent(torch.bincount(labels, minlength=n_lists))
    ids = torch.arange(ns, dtype=torch.int32, device=dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (500, 12))).to(
        dev, torch.int32)
    probes[::3, 5:] = n_lists                     # sentinel slots
    probes[1, 1] = probes[1, 0]                   # repeated probe
    filt = torch.from_numpy(rng.integers(0, 2**31, -(-ns // 32))).to(
        dev, torch.int32)
    lists = np.arange(n_lists)
    splits = {"alternate": (lists[::2], lists[1::2]),
              "all-but-one hot": (lists[1:], lists[:1]),
              "all-but-one cold": (lists[7:8], np.delete(lists, 7))}
    kq_all = [(k, q) for k in (1, 10, 128) for q in (1, 10, 500)]
    kq_few = [(1, 500), (10, 10), (128, 1)]
    cases = 0
    for exact in (True, False):
        data = (_int_data(rng, (ns, d)) if exact
                else rng.standard_normal((ns, d)).astype(np.float32))
        data[100] = data[7]
        (packed, indices), _ = pack_padded_lists(
            labels, n_lists, m, [(torch.from_numpy(data).to(dev), 0),
                                 (ids, -1)])
        norms = torch.where(indices >= 0, (packed * packed).sum(dim=2),
                            torch.full_like(indices, float("inf"),
                                            dtype=torch.float32))
        qf = torch.from_numpy(data[:500] + 0.5 if exact
                              else data[:500] * 0.9).to(dev)
        for split, (hot_lists, cold_lists) in splits.items():
            hot, cold, hmap, cmap = _split_tiers(torch, packed, hot_lists,
                                                 cold_lists)
            for metric in (DistanceType.L2Expanded,
                           DistanceType.InnerProduct):
                for fw in (None, filt):
                    for k, q in (kq_all if split == "alternate" else kq_few):
                        args = (qf[:q], hot, cold, hmap, cmap, norms,
                                indices, probes[:q], fw)
                        name = (f"tier_scan {split} {metric.name} k={k} "
                                f"q={q} filter={fw is not None} "
                                f"exact={exact}")
                        got = tiered_list_major_scan(*args, k=k,
                                                     metric=metric,
                                                     engine="cuda")
                        whole = list_major_scan(
                            qf[:q], packed, norms, indices, probes[:q], fw,
                            k=k, metric=metric, engine="cuda")
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], whole[0])
                                and torch.equal(got[1], whole[1])):
                            fail(f"{name}: differs from the all-device scan "
                                 "kernel on the un-split planes")
                        want = tiered_list_major_scan(*args, k=k,
                                                      metric=metric,
                                                      engine="torch")
                        compare(name, got, want, exact)
                        cases += 1
    staged = kernels_tier_staging(torch, packed, norms, indices, qf, probes,
                                  filt)
    # a cold plane that is not page-locked host memory is refused
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for what, bad in (("pageable", cold.clone()), ("device", cold.to(dev))):
        try:
            tiered_list_major_scan(qf, hot, bad, hmap, cmap, norms, indices,
                                   probes, k=10,
                                   metric=DistanceType.L2Expanded,
                                   engine="cuda")
        except RaftError:
            pass
        else:
            fail(f"tier_scan took a {what} cold plane")
        err = _build.load("tier_scan")(
            z.data_ptr(), hot.data_ptr(), bad.data_ptr(),
            *[z.data_ptr()] * 16, 1, 1, 1, 1, 1, 0, 0, 0, 0,
            *[z.data_ptr()] * 9, stream, stream, None)
        if err == 0:
            fail(f"the tier_scan C entry took a {what} cold plane")
    log(f"[kernels] tier_scan: {cases} cases and {staged} staging cases "
        "equal the all-device scan kernel bit for bit and agree with the "
        "plain version; pageable and device cold planes refused by the "
        "wrapper and the C entry")


def kernels_tier_staging(torch, packed, norms, indices, qf, probes,
                         filt) -> int:
    """The staging edge cases of the tiered scan on integer-valued data:
    rings smaller than the probed cold set (waves of one list and of
    three), a request that probes no cold list, and an index with no
    cold tier. Each must equal the all-device kernel and the plain
    version bit for bit and stage each probed cold list once, its live
    rows rounded up to the 64-row tile."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.ivf_scan import list_major_scan, live_rows
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    n_lists, m, d = packed.shape
    lists = np.arange(n_lists)
    real = live_rows(indices).cpu().numpy()
    tile_rows = np.minimum(-(-real // 64) * 64, m)
    big = int(tile_rows.max()) * d * 4
    cases = {
        "waves of one list": (lists[::2], lists[1::2], 2 * big, probes),
        "waves of three lists": (lists[::2], lists[1::2], 7 * big, probes),
        "no cold list probed": (lists[::2], lists[1::2], 1 << 31,
                                (probes // 2) * 2),   # even lists only
        "no cold tier": (lists, lists[:0], 1 << 31, probes),
    }
    n = 0
    for name, (hot_lists, cold_lists, ws, pr) in cases.items():
        hot, cold, hmap, cmap = _split_tiers(torch, packed, hot_lists,
                                             cold_lists)
        cold_probed = sorted(set(pr.flatten().tolist()) & set(
            cold_lists.tolist()))
        for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
            for q in (10, 500):
                args = (qf[:q], hot, cold, hmap, cmap, norms, indices,
                        pr[:q], None)
                c0 = tracing.counters("tier.")
                got = tiered_list_major_scan(*args, k=10, metric=metric,
                                             engine="cuda",
                                             workspace_bytes=ws)
                c1 = tracing.counters("tier.")
                delta = {key: c1[key] - c0.get(key, 0.0) for key in c1}
                whole = list_major_scan(qf[:q], packed, norms, indices,
                                        pr[:q], None, k=10, metric=metric,
                                        engine="cuda")
                torch.cuda.synchronize()
                label = f"tier_scan {name} {metric.name} q={q}"
                if not (torch.equal(got[0], whole[0])
                        and torch.equal(got[1], whole[1])):
                    fail(f"{label}: differs from the all-device scan kernel")
                compare(label, got, tiered_list_major_scan(
                    *args, k=10, metric=metric, engine="torch"), True)
                probed = sorted(set(pr[:q].flatten().tolist())
                                & set(cold_probed))
                want_bytes = int(tile_rows[probed].sum()) * d * 4
                if (delta.get("tier.cold_lists_staged", 0) != len(probed)
                        or delta.get("tier.cold_bytes_staged", 0)
                        != want_bytes):
                    fail(f"{label}: staged {delta} for {len(probed)} probed "
                         f"cold lists of {want_bytes} bytes")
                waves = delta.get("tier.stage_waves", 0)
                if name.startswith("waves") and q == 500 and waves < 3:
                    fail(f"{label}: {waves} waves, not several")
                if not probed and waves != 0:
                    fail(f"{label}: {waves} waves without a cold list")
                n += 1
    return n


def kernels_stream(torch, seed: int) -> None:
    """stream_read_sum against its plain version and the float64 sum:
    integer data exactly (every partial sum is an integer below 2^24,
    exact in any order), Gaussian data within 1e-6 sum|x| per column."""
    from raft_tpu_torch.ops.fused_topk import (
        stream_read_sum,
        stream_read_sum_plain,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 5)
    cases = 0
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 1000, 1 << 22):
            for d in (100, 128):
                for exact in (True, False):
                    x = (torch.randint(-3, 4, (n, d), generator=g,
                                       device="cuda").float() if exact
                         else torch.randn(n, d, generator=g, device="cuda"))
                    x = x.to(dtype)
                    got = stream_read_sum(x)
                    want = stream_read_sum_plain(x)
                    ref = x.double().sum(dim=0, keepdim=True)
                    name = f"stream_read_sum {dtype} n={n} d={d}"
                    if exact:
                        if not (torch.equal(got, want)
                                and torch.equal(got.double(), ref)):
                            fail(f"{name}: integer sums differ")
                    else:
                        scale = x.double().abs().sum(dim=0, keepdim=True)
                        for what, v in (("kernel", got), ("plain", want)):
                            e = (v.double() - ref).abs() / scale
                            if bool((e > 1e-6).any()):
                                fail(f"{name}: {what} off the float64 sum "
                                     "by more than 1e-6 sum|x|")
                        worst = max(worst, float(
                            ((got.double() - ref).abs() / scale).max()))
                    if not torch.equal(stream_read_sum(x), got):
                        fail(f"{name}: differs from run to run")
                    cases += 1
    log(f"[kernels] stream_read_sum: {cases} cases; integer data equal to "
        "the plain version and the float64 sum, Gaussian data within "
        f"{worst:.3g} sum|x| of the float64 sum (limit 1e-6); the same "
        "result run to run")


def make_data(torch, seed: int):
    """Clustered float32 data at SIFT-1M's shape, made on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    centers = torch.randn(4096, DIM, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 4096, (N_ROWS + N_QUERIES,), generator=g,
                        device="cuda")
    pts = centers[lab] + torch.randn(N_ROWS + N_QUERIES, DIM, generator=g,
                                     device="cuda")
    return pts[:N_ROWS].contiguous(), pts[N_ROWS:].contiguous()


def recall(ids, truth) -> float:
    hit = (ids[:, :, None] == truth[:, None, :]).any(dim=2)
    return float(hit.float().mean())


def _counted():
    """Every kernel wrapper's launch counter: name -> wrapper."""
    from raft_tpu_torch.ops.beam_search import beam_search
    from raft_tpu_torch.ops.bq_scan import bq_list_major_scan
    from raft_tpu_torch.ops.fused_topk import (
        fused_knn,
        select_k_tiles,
        stream_read_sum,
    )
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    return {"fused_knn": fused_knn, "list_major_scan": list_major_scan,
            "bq_scan": bq_list_major_scan, "select_k": select_k_tiles,
            "beam_search": beam_search, "tier_scan": tiered_list_major_scan,
            "stream_read_sum": stream_read_sum, "ivf_pq_scan": ivf_pq_scan}


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_launches(names, path: str) -> dict:
    """The counts of a path's kernels just after it ran; fails if one of
    them never launched."""
    counts = {name: fn.launches for name, fn in _counted().items()}
    log(f"[main] launches on the {path} path: {counts}")
    for name in names:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the {path} path")
    return {name: counts[name] for name in names}


def bq_scan_run(index, queries, n_probes: int, engine: str):
    """(distances, ids, rows reranked per query) of an IVF-BQ search body
    run with ``engine``."""
    from raft_tpu_torch.neighbors import ivf_bq

    _, arrays, static = ivf_bq.serving_plan(ivf_bq.IvfBqSearchParams(
        n_probes=n_probes, scan_engine=engine), index, K)
    return ivf_bq._search_arrays(queries, *arrays, None, **static)[:3]


def phase_main(torch, seed: int, state: dict) -> None:
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force, ivf_flat

    res = Resources(device="cuda", seed=seed)
    t0 = time.perf_counter()
    x, queries = make_data(torch, seed)
    torch.cuda.synchronize()
    log(f"[main] data {tuple(x.shape)} queries {tuple(queries.shape)} made "
        f"in {time.perf_counter() - t0:.2f} s (seed {seed})")

    reset_launches()
    bf = brute_force.build(res, x)
    t0 = time.perf_counter()
    parts = [brute_force.search(res, bf, queries[s:s + 500], K)
             for s in range(0, N_QUERIES, 500)]
    gt_d = torch.cat([p[0] for p in parts])
    gt_i = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    log(f"[main] brute force ground truth: {N_QUERIES // 500} requests of "
        f"500 in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS),
                           x)
    torch.cuda.synchronize()
    sizes = index.list_sizes.to(torch.float32)
    log(f"[main] ivf_flat.build n_lists={N_LISTS}: "
        f"{time.perf_counter() - t0:.2f} s, max_list_size "
        f"{index.max_list_size}, size {index.size}, list sizes min "
        f"{int(sizes.min())} median {int(sizes.median())} max "
        f"{int(sizes.max())}")
    if index.size != N_ROWS:
        fail(f"ivf_flat.build indexed {index.size} rows")

    for n_probes in (32, 128):
        sp = ivf_flat.IvfFlatSearchParams(n_probes=n_probes)
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(ivf_flat.search(res, sp, index,
                                            queries[s:s + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            log(f"[main] ivf_flat.search n_probes={n_probes} batch={batch}: "
                f"recall@10 {r:.4f} over {n_q} queries, median "
                f"{np.median(times[1:]):.3f} ms per batch")
            state[f"recall_p{n_probes}_b{batch}"] = r
            state[f"ms_p{n_probes}_b{batch}"] = float(np.median(times[1:]))

    # probing every list is exact search: ids equal brute force's, except
    # where two distances tie within float32 rounding
    sp_all = ivf_flat.IvfFlatSearchParams(n_probes=N_LISTS)
    outs = [ivf_flat.search(res, sp_all, index, queries[s:s + 500], K)
            for s in range(0, N_QUERIES, 500)]
    all_d = torch.cat([o[0] for o in outs])
    all_i = torch.cat([o[1] for o in outs])
    diff = all_i != gt_i
    tol = 1e-5 * ((queries * queries).sum(dim=1, keepdim=True)
                  + float(bf.norms.max()))
    if bool(((all_d - gt_d).abs() > tol).any()):
        fail("n_probes=1024 distances differ from brute force")
    log(f"[main] n_probes={N_LISTS}: {int(diff.sum())} of {diff.numel()} "
        "ids differ from brute force, all at distances tied within "
        "1e-5 (|q|^2 + max |x|^2)")
    if float(diff.float().mean()) > 1e-3:
        fail("n_probes=1024 ids differ from brute force beyond ties")

    sp = ivf_flat.IvfFlatSearchParams(n_probes=128)
    before = ivf_flat.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    ivf_flat.save(index, buf)
    buf.seek(0)
    loaded = ivf_flat.load(res, buf)
    after = ivf_flat.search(res, sp, loaded, queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("save -> load -> search is not bit-identical")
    log(f"[main] save -> load ({buf.getbuffer().nbytes} bytes) -> search: "
        "bit-identical")

    state["launches"] = read_launches(("fused_knn", "list_major_scan"),
                                      "IVF-Flat")
    state.update(res=res, x=x, queries=queries, index=index, bf=bf,
                 gt_d=gt_d, gt_i=gt_i, seed=seed)
    builds_reproducible_ivf(torch, state)
    main_tiered(torch, state)
    main_bq(torch, state)


def builds_reproducible_ivf(torch, state: dict) -> None:
    """Two same-seed builds are equal (torch.equal): balanced k-means over
    all 1M rows (n_lists 1024, the IVF-Flat path's parameters) and a
    second IVF-Flat build, against the path's index."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_flat

    x, index = state["x"], state["index"]
    kp = kmeans_balanced.KMeansBalancedParams()
    t0 = time.perf_counter()
    fits = [kmeans_balanced.fit(Resources(device="cuda", seed=0), kp, x,
                                N_LISTS) for _ in range(2)]
    torch.cuda.synchronize()
    fit_s = (time.perf_counter() - t0) / 2
    if not torch.equal(fits[0], fits[1]):
        fail("two same-seed balanced k-means fits differ")
    again = ivf_flat.build(Resources(device="cuda", seed=state["seed"]),
                           ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS), x)
    for name in ("centers", "data", "data_norms", "indices", "list_sizes"):
        if not torch.equal(getattr(again, name), getattr(index, name)):
            fail(f"two same-seed IVF-Flat builds differ in {name}")
    log(f"[main] reproducible builds: two balanced k-means fits of "
        f"{tuple(x.shape)} into {N_LISTS} ({fit_s:.3f} s each) and two "
        "IVF-Flat builds are equal (torch.equal: centers, lists, norms, "
        "ids, sizes)")


def builds_reproducible_cagra(torch, state: dict) -> None:
    """Two same-seed CAGRA builds on the first CAGRA_REPRO_ROWS rows (a cut
    that keeps the run inside its time limit; the full 1M build ran once
    above) give equal graphs and planes."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra

    x = state["x"][:CAGRA_REPRO_ROWS]
    t0 = time.perf_counter()
    a, b = (cagra.build(Resources(device="cuda", seed=state["seed"]),
                        cagra_params(cagra), x) for _ in range(2))
    torch.cuda.synchronize()
    for name in ("graph", "seed_centers", "seed_members", "bq_records"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            fail(f"two same-seed CAGRA builds of {CAGRA_REPRO_ROWS} rows "
                 f"differ in {name}")
    log(f"[main] reproducible builds: two CAGRA builds of "
        f"{CAGRA_REPRO_ROWS} rows (a cut of the 1M; "
        f"{(time.perf_counter() - t0) / 2:.2f} s each) give equal graphs, "
        "seed and BQ planes (torch.equal)")


def _probed_rows(torch, t, probes):
    """Rows of the probed-list union of one request, split by tier: (hot
    rows, cold rows, cold lists), from the tier fetch plan of the union."""
    from raft_tpu_torch.ops.ivf_scan import unique_lists
    from raft_tpu_torch.ops.tier_scan import tier_fetch_plan

    uniq = unique_lists(probes, t.n_lists)
    _, cold_fetch, _ = tier_fetch_plan(uniq, t.hot_slot_map,
                                       t.cold_slot_map, t.n_lists)
    live = uniq < t.n_lists
    sizes = t.list_sizes.to(torch.int64)[uniq.clamp(max=t.n_lists - 1)
                                         .to(torch.int64)]
    cold = live & (cold_fetch >= 0)
    hot = live & (cold_fetch < 0)
    return int(sizes[hot].sum()), int(sizes[cold].sum()), int(cold.sum())


def main_tiered(torch, state: dict) -> None:
    """The tiered path on the IVF-Flat path's index: half the lists' blocks
    in pinned host memory; searches bit-identical to the all-device index,
    one placement epoch, and the dual roofline."""
    from raft_tpu_torch.core import memwatch, tracing
    from raft_tpu_torch.neighbors import ivf_flat, tiered
    from raft_tpu_torch.ops.fused_topk import stream_read_sum
    from raft_tpu_torch.serving.placement import plan_epoch

    res, index, queries, gt_i = (state["res"], state["index"],
                                 state["queries"], state["gt_i"])
    # the all-device answers each tiered request must equal, first (their
    # scan launches are not the tiered path's)
    requests = [(p, b, n_q) for p in (32, 128)
                for b, n_q in ((10, 1000), (500, N_QUERIES))]
    want = {(p, b): [ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(
        n_probes=p), index, queries[s:s + b], K) for s in range(0, n_q, b)]
        for p, b, n_q in requests}
    torch.cuda.synchronize()

    reset_launches()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    t = tiered.build_tiered(index, hot_fraction=0.5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grew = torch.cuda.memory_allocated() - alloc0
    model = memwatch.index_memory_model(t)
    mirrors = t.hot_lists.nbytes + t.cold_lists.nbytes
    log(f"[main] tiered.build_tiered hot_fraction=0.5: {build_s:.3f} s, "
        f"{t.n_hot} hot lists ({t.hot_bytes} bytes on the card), "
        f"{t.n_cold} cold ({t.cold_bytes} bytes), block {t.block_bytes} "
        f"bytes; cold plane pinned: {t.cold_data.is_pinned()}, memory_tier "
        f"{memwatch.memory_tier(t.cold_data)}; modeled host-resident "
        f"{model['host_resident_bytes']} bytes (cold plane + {mirrors} "
        f"bytes of host list mirrors); device memory grew {grew} bytes")
    if not (t.host_resident and t.cold_data.is_pinned()
            and memwatch.memory_tier(t.cold_data) == "host"):
        fail("the cold tier is not in pinned host memory")
    if model["host_resident_bytes"] != t.cold_bytes + mirrors:
        fail("the memory model does not count the cold tier as host bytes")
    if not 0 <= grew - t.hot_bytes < (1 << 20):
        fail(f"device memory grew {grew} bytes over a {t.hot_bytes}-byte "
             "hot tier")

    def run_requests(tag: str, key: str, n_first=None) -> None:
        for p, b, n_q in requests:
            n_q = min(n_q, n_first or n_q)
            sp = tiered.TieredSearchParams(n_probes=p)
            outs, times, hot_b, cold_b, staged = [], [], [], [], []
            for j, s in enumerate(range(0, n_q, b)):
                c0 = tracing.counters("tier.")
                t1 = time.perf_counter()
                out = tiered.search(res, sp, t, queries[s:s + b], K)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                c1 = tracing.counters("tier.")
                staged.append({name: c1[name] - c0.get(name, 0.0)
                               for name in c1})
                ref = want[p, b][j]
                if not (torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])):
                    fail(f"tiered search n_probes={p} batch={b} request {j} "
                         f"{tag} differs from the all-device search")
                outs.append(out)
            for j, s in enumerate(range(0, n_q, b)):
                probes = ivf_flat.coarse_probes(
                    queries[s:s + b], t.centers, t.center_norms, t.metric,
                    p, "exact")
                hot_rows, cold_rows, n_cold = _probed_rows(torch, t, probes)
                hot_b.append(hot_rows * DIM * 4)
                cold_b.append(cold_rows * DIM * 4)
                # each probed cold list staged once, its real rows rounded
                # up to the scan's 64-row tile: never fewer bytes
                got = staged[j]
                if (got.get("tier.cold_lists_staged", 0) != n_cold
                        or got.get("tier.cold_bytes_staged", 0)
                        < cold_rows * DIM * 4):
                    fail(f"tiered search n_probes={p} batch={b} request {j} "
                         f"{tag}: staged {got} for {n_cold} probed cold "
                         f"lists of {cold_rows * DIM * 4} bytes")
            st_b = [x.get("tier.cold_bytes_staged", 0) for x in staged]
            waves = [x.get("tier.stage_waves", 0) for x in staged]
            r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
            ms = float(np.median(times[1:]))
            state[f"tier_recall_p{p}_b{b}{key}"] = r
            state[f"tier_ms_p{p}_b{b}{key}"] = ms
            state[f"tier_hot_bytes_p{p}_b{b}{key}"] = float(np.mean(hot_b))
            state[f"tier_cold_bytes_p{p}_b{b}{key}"] = float(np.mean(cold_b))
            state[f"tier_staged_bytes_p{p}_b{b}{key}"] = float(np.mean(st_b))
            log(f"[main] tiered.search n_probes={p} batch={b} {tag}: "
                f"recall@10 {r:.4f} over {n_q} queries, median {ms:.3f} ms "
                f"per batch (all-device {state[f'ms_p{p}_b{b}']:.3f} ms), "
                f"cold bytes probed per request mean "
                f"{np.mean(cold_b):.0f} (min {min(cold_b)}, max "
                f"{max(cold_b)}), staged over the host link (counted, "
                f"tier.cold_bytes_staged) mean {np.mean(st_b):.0f} (min "
                f"{min(st_b):.0f}, max {max(st_b):.0f}) in {min(waves):.0f}"
                f"-{max(waves):.0f} waves; each probed cold list staged "
                "once; ids and distances equal the all-device search")

    run_requests("before the epoch", "")

    # one placement epoch: batch-500 traffic at the centers of two cold
    # lists. The traffic probes one list a query, so the window holds the
    # two targets alone and the plan must promote exactly them.
    dev = t.centers.device
    targets = [int(t.cold_lists[0]), int(t.cold_lists[t.n_cold // 2])]
    window = torch.zeros(t.n_lists, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for lid in targets:
        traffic = (t.centers[lid][None, :].expand(500, -1)
                   + 0.01 * torch.randn(500, DIM, generator=g, device=dev))
        fn, arrays, static = tiered.serving_plan(
            tiered.TieredSearchParams(n_probes=1), t, K)
        *_, window = fn(traffic, *arrays, None, window, **static)
    plan = plan_epoch(window.cpu().numpy(), t.hot_lists, t.cold_lists,
                      max_swaps=4)
    b0 = tracing.get_counter("tier.swap_bytes")
    t0 = time.perf_counter()
    moved = tiered.apply_plan(t, plan.promotions, plan.demotions, width=4)
    epoch_ms = (time.perf_counter() - t0) * 1e3
    swap_bytes = tracing.get_counter("tier.swap_bytes") - b0
    n_swaps = len(plan.promotions)
    log(f"[main] placement epoch: window {int(window.sum())} probes on "
        f"lists {targets}, hot share {plan.hot_window_fraction:.3f}; plan "
        f"promotes {list(plan.promotions)}, demotes "
        f"{list(plan.demotions)}; apply_plan moved {moved} bytes in "
        f"{epoch_ms:.2f} ms (tier.swap_bytes +{swap_bytes:.0f}), "
        f"generation {t.generation}")
    if sorted(plan.promotions) != sorted(targets):
        fail(f"the epoch promoted {plan.promotions}, not {targets}")
    if not all(int(t.hot_slot_map[lid]) >= 0 for lid in targets):
        fail("a targeted list is not hot after the epoch")
    if not swap_bytes == moved == 2 * n_swaps * t.block_bytes:
        fail(f"swap bytes {swap_bytes} != 2 x {n_swaps} x {t.block_bytes}")
    run_requests("after the epoch", "_after", n_first=1000)
    scans = _counted()["list_major_scan"].launches
    if scans != 0:
        fail(f"the all-device scan launched {scans} times on the tiered path")

    # the dual roofline: a streamed read of the hot plane (device memory)
    # and a pinned -> device copy of the cold plane (host link)
    hot_flat = t.hot_data.reshape(-1, DIM)
    hbm_ms = median_ms(lambda: stream_read_sum(hot_flat), 10)
    dst = torch.empty(t.cold_data.shape, dtype=t.cold_data.dtype,
                      device=dev)
    link_ms = median_ms(lambda: dst.copy_(t.cold_data, non_blocking=True), 5)
    state["hbm_gbps"] = hot_flat.numel() * 4 / hbm_ms / 1e6
    state["link_gbps"] = t.cold_bytes / link_ms / 1e6
    log(f"[main] rooflines: stream_read_sum over the hot plane "
        f"{tuple(hot_flat.shape)} {hbm_ms:.4f} ms = {state['hbm_gbps']:.1f} "
        f"GB/s (device memory); pinned -> device copy of the cold plane "
        f"({t.cold_bytes} bytes) {link_ms:.3f} ms = "
        f"{state['link_gbps']:.2f} GB/s (host link)")
    del dst
    ring_copy(torch, state, t, want[128, 500])
    for p, b, _ in requests:
        ms = state[f"tier_ms_p{p}_b{b}"]
        hot_gbps = state[f"tier_hot_bytes_p{p}_b{b}"] / ms / 1e6
        cold_gbps = state[f"tier_cold_bytes_p{p}_b{b}"] / ms / 1e6
        log(f"[main] tiered n_probes={p} batch={b}: per request, hot rows "
            f"at {hot_gbps:.2f} GB/s ({100 * hot_gbps / state['hbm_gbps']:.3f}"
            f"% of the device memory roofline), cold rows at "
            f"{cold_gbps:.2f} GB/s ({100 * cold_gbps / state['link_gbps']:.1f}"
            "% of the host link roofline)")
    state["launches"].update(read_launches(("tier_scan", "stream_read_sum"),
                                           "tiered"))
    state.update(tiered=t, tier_build_s=build_s, tier_epoch_ms=epoch_ms,
                 tier_grew=grew)



def ring_copy(torch, state: dict, t, want) -> None:
    """The tiered scan's staged copies at the batch-500, n_probes=128
    request, read from the device's own timeline: torch.profiler over
    three such requests (each still equal to the all-device search); the
    bytes staged (``tier.cold_bytes_staged``) over the summed device time
    of their host -> device copies is the ring copy's achieved rate,
    against the pinned -> device roofline."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import tiered

    sp = tiered.TieredSearchParams(n_probes=128)
    c0 = tracing.counters("tier.")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [tiered.search(state["res"], sp, t,
                              state["queries"][s:s + 500], K)
                for s in range(0, 1500, 500)]
        torch.cuda.synchronize()
    c1 = tracing.counters("tier.")
    for j, out in enumerate(outs):
        if not (torch.equal(out[0], want[j][0])
                and torch.equal(out[1], want[j][1])):
            fail(f"profiled tiered request {j} differs from the all-device "
                 "search")
    nbytes, lists = (c1.get(name, 0.0) - c0.get(name, 0.0)
                     for name in ("tier.cold_bytes_staged",
                                  "tier.cold_lists_staged"))
    copies = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key.startswith("Memcpy HtoD")]
    count = sum(e.count for e in copies)
    us = sum(e.self_device_time_total for e in copies)
    kinds = ", ".join(f"{e.key} x{e.count}" for e in copies)
    if not us:
        state["ring_gbps"] = None
        log("[main] the ring copy's rate: not measured (the profiler shows "
            "no host -> device copy on the device)")
        return
    state["ring_gbps"] = nbytes / us / 1e3
    log(f"[main] the ring copy of three batch-500, n_probes=128 tiered "
        f"requests (torch.profiler, device time of the copies): "
        f"{nbytes:.0f} bytes staged in {lists:.0f} lists, {count} host -> "
        f"device copies ({kinds}) busy {us / 1e3:.3f} ms = "
        f"{state['ring_gbps']:.2f} GB/s "
        f"({100 * state['ring_gbps'] / state['link_gbps']:.1f}% of the "
        f"pinned -> device roofline {state['link_gbps']:.2f} GB/s)")


def main_bq(torch, state: dict) -> None:
    """The IVF-BQ path at SIFT-1M's shape, on the IVF-Flat path's data and
    ground truth, then matrix.select_k over a (64, n) distance slab."""
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors import ivf_bq

    res, x, queries = state["res"], state["x"], state["queries"]
    gt_d, gt_i, bf = state["gt_d"], state["gt_i"], state["bf"]
    reset_launches()
    t0 = time.perf_counter()
    index = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS), x)
    torch.cuda.synchronize()
    sizes = index.list_sizes.to(torch.float32)
    log(f"[main] ivf_bq.build n_lists={N_LISTS} bits={index.bits}: "
        f"{time.perf_counter() - t0:.2f} s, max_list_size "
        f"{index.max_list_size}, size {index.size}, list sizes min "
        f"{int(sizes.min())} median {int(sizes.median())} max "
        f"{int(sizes.max())}")
    if index.size != N_ROWS or index.data is None:
        fail(f"ivf_bq.build indexed {index.size} rows")

    list_sizes = index.list_sizes.to(torch.int64)
    for n_probes in (32, 128):
        sp = ivf_bq.IvfBqSearchParams(n_probes=n_probes)
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s0 in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(ivf_bq.search(res, sp, index,
                                          queries[s0:s0 + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            # the requests against the plain scan, after the timing: the
            # search's ids and distances, and the rows each query reranked
            # (the kernel's count, from the same request's scan again) of
            # every BQ_PLAIN_STRIDE[batch]-th request (a cut for the time
            # limit: the plain scan takes seconds a request at batch 500)
            surv = probed = 0
            stride = BQ_PLAIN_STRIDE[batch]
            starts = range(0, n_q, batch)
            checked = [(j, s0) for j, s0 in enumerate(starts)
                       if j % stride == 0]
            t_chk = time.perf_counter()
            for j, s0 in checked:
                qb = queries[s0:s0 + batch]
                name = (f"ivf_bq.search n_probes={n_probes} batch={batch} "
                        f"request {j}")
                want = bq_scan_run(index, qb, n_probes, "torch")
                got = bq_scan_run(index, qb, n_probes, "cuda")
                bq_equal(name, got, want)
                if not (torch.equal(outs[j][0], got[0])
                        and torch.equal(outs[j][1], got[1])):
                    fail(f"{name}: the scan run again differs from the "
                         "search")
                surv += int(got[2].sum())
                probes = ivf_bq.coarse_probes(index, qb, n_probes)[0]
                probed += int(list_sizes[probes.to(torch.int64)].sum())
            t_chk = time.perf_counter() - t_chk
            share = surv / probed
            state[f"bq_survivors_p{n_probes}"] = share
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            ms = float(np.median(times[1:]))
            log(f"[main] ivf_bq.search n_probes={n_probes} batch={batch}: "
                f"recall@10 {r:.4f} over {n_q} queries, median {ms:.3f} ms "
                f"per batch, rows reranked {surv} of {probed} probed "
                f"({100 * share:.3f}%) over the checked requests' queries; "
                f"{len(checked)} requests (every {stride}) equal the plain "
                f"scan on distances, ids and rows reranked ({t_chk:.1f} s)")
            state[f"bq_recall_p{n_probes}_b{batch}"] = r
            state[f"bq_ms_p{n_probes}_b{batch}"] = ms
    if state["bq_recall_p128_b500"] < 0.95:
        fail("ivf_bq recall@10 at n_probes=128, batch 500 is below 0.95")

    # every list probed: the prune is probabilistic, so not exact search
    sp_all = ivf_bq.IvfBqSearchParams(n_probes=N_LISTS)
    ids = torch.cat([ivf_bq.search(res, sp_all, index, queries[s0:s0 + 500],
                                   K)[1] for s0 in range(0, 1000, 500)])
    log(f"[main] ivf_bq n_probes={N_LISTS}: recall@10 "
        f"{recall(ids, gt_i[:1000]):.4f} over 1000 queries")

    sp = ivf_bq.IvfBqSearchParams(n_probes=128)
    before = ivf_bq.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    ivf_bq.save(index, buf)
    buf.seek(0)
    after = ivf_bq.search(res, sp, ivf_bq.load(res, buf), queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("ivf_bq save -> load -> search is not bit-identical")
    log(f"[main] ivf_bq save -> load ({buf.getbuffer().nbytes} bytes) -> "
        "search: bit-identical")

    # select_k over squared distances from a plain matmul
    q64 = queries[:64]
    slab = ((q64 * q64).sum(dim=1, keepdim=True) + bf.norms[None, :]
            - 2.0 * (q64 @ x.T))
    vals, ids = select_k(res, slab, K)
    tol = 1e-5 * ((q64 * q64).sum(dim=1, keepdim=True)
                  + float(bf.norms.max()))
    if bool(((vals - gt_d[:64]).abs() > tol).any()):
        fail("select_k values differ from brute force's distances")
    diff = ids != gt_i[:64]
    log(f"[main] select_k (64, {N_ROWS}) k={K}: {int(diff.sum())} of "
        f"{diff.numel()} ids differ from brute force, all at distances "
        "tied within 1e-5 (|q|^2 + max |x|^2)")
    if float(diff.float().mean()) > 1e-3:
        fail("select_k ids differ from brute force beyond ties")
    state["launches"].update(read_launches(("bq_scan", "select_k"),
                                           "IVF-BQ"))
    # the kernel against its plain version at the path's shape, after the
    # path's counts were read
    state["select_k_err"] = select_equal(torch, f"select_k (64, {N_ROWS}) "
                                         f"k={K}", slab, K)
    state["select_slab"] = slab
    state["bq_index"] = index
    main_tiered_bq(torch, state)
    main_cagra(torch, state)


#: IVF-BQ requests held against the plain scan, by batch: every fourth of
#: the 100 timed at batch 10 (25 over the 1,000 queries), every tenth of
#: the 20 at batch 500 (2 over the 10,000); halved from 50 and 4 for the
#: time limit when the bench phase joined the default run
BQ_PLAIN_STRIDE = {10: 4, 500: 10}
#: tiered IVF-BQ requests (n_probes, batch, requests): the plain fused
#: engine runs them (~4 s at (128, 500)), so three of each small one and
#: one at 500, a cut for the time limit
TIERED_BQ_REQUESTS = ((32, 10, 3), (128, 10, 3), (128, 500, 1))


def main_tiered_bq(torch, state: dict) -> None:
    """Tiered IVF-BQ on the IVF-BQ path's index: build_tiered_bq(hot_fraction
    0.5), the five record planes' cold halves pinned; each request of
    TIERED_BQ_REQUESTS through the plain fused engine (the card's BQ
    kernel has no dual-source variant, so tiered BQ resolves to it before
    any launch) equal to the all-device kernel's search on distances, ids
    and rows reranked, with the plain engine's time printed."""
    from raft_tpu_torch.core import memwatch
    from raft_tpu_torch.neighbors import ivf_bq, tiered

    res, queries, index = state["res"], state["queries"], state["bq_index"]
    t0 = time.perf_counter()
    t = tiered.build_tiered_bq(index, hot_fraction=0.5)
    torch.cuda.synchronize()
    log(f"[main] tiered.build_tiered_bq hot_fraction=0.5: "
        f"{time.perf_counter() - t0:.3f} s, {t.n_hot} hot lists "
        f"({t.hot_bytes} bytes), {t.n_cold} cold ({t.cold_bytes} bytes, "
        f"the five record planes pinned: "
        f"{all(p.is_pinned() for p in t.tier_planes()[1])}), block "
        f"{t.block_bytes} bytes")
    if not (t.host_resident and all(memwatch.memory_tier(p) == "host"
                                    for p in t.tier_planes()[1])):
        fail("the tiered BQ cold planes are not in pinned host memory")
    rows = {}
    for n_probes, batch, n_req in TIERED_BQ_REQUESTS:
        sp = ivf_bq.IvfBqSearchParams(n_probes=n_probes)
        fn, arrays, static = tiered.serving_plan_bq(sp, t, K)
        if static["scan_engine"] != "torch":
            fail("tiered IVF-BQ did not resolve to the plain fused engine")
        times, reranked = [], 0
        for j in range(n_req):
            q = queries[j * batch:(j + 1) * batch]
            want = bq_scan_run(index, q, n_probes, "cuda")
            hots, colds, hmap, cmap, _ = t.tier_planes()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = ivf_bq._search_arrays(
                q, t.centers, t.rotation, *hots[:4], t.indices, hots[4],
                t.data_norms, None, metric=t.metric, n_probes=n_probes, k=K,
                coarse_algo="exact", scan_engine="torch",
                epsilon=sp.epsilon, query_bits=static["query_bits"],
                cold_planes=colds, hot_slot_map=hmap, cold_slot_map=cmap)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            for a, b, what in zip(got[:3], want, ("distances", "ids",
                                                 "rows reranked")):
                if not torch.equal(a, b):
                    fail(f"tiered IVF-BQ n_probes={n_probes} batch={batch} "
                         f"request {j}: {what} differ from the all-device "
                         "search")
            direct = tiered.search_bq(res, sp, t, q, K)
            if not (torch.equal(direct[0], got[0])
                    and torch.equal(direct[1], got[1])):
                fail("tiered.search_bq differs from its serving body")
            reranked += int(got[2].sum())
        rows[n_probes, batch] = float(np.median(times))
        log(f"[main] tiered.search_bq n_probes={n_probes} batch={batch}: "
            f"{n_req} requests equal the all-device kernel's search on "
            f"distances, ids and rows reranked ({reranked} reranked); the "
            f"plain fused engine {rows[n_probes, batch]:.3f} ms median per "
            "request")
    state["tiered_bq_ms"] = rows
    del t


def cagra_walk_args(state, queries, itopk: int, bq: bool):
    """The beam walk ``cagra.search`` runs for one request tile at
    search_width 4: the (args, kwargs) of ``beam_search``."""
    from raft_tpu_torch.neighbors import cagra

    sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=4,
                                 bq_traversal="on" if bq else "off")
    return cagra.beam_search_args(sp, state["cagra_index"], queries, K)


def main_cagra(torch, state: dict) -> None:
    """The CAGRA path at SIFT-1M's shape, on the same data and ground
    truth: the blobs-1M-128 config's first raft_cagra entry."""
    from raft_tpu_torch.neighbors import cagra

    from raft_tpu_torch.ops.fused_topk import select_k_tiles

    res, x, queries, gt_i = (state["res"], state["x"], state["queries"],
                             state["gt_i"])
    reset_launches()
    t0 = time.perf_counter()
    index = cagra.build(res, cagra_params(cagra), x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # cluster-join selects a cluster's rows through matrix.select_k, whose
    # AUTO takes TOPK at a cluster's width, as the reference's lax.top_k
    tiles = select_k_tiles.launches
    log(f"[main] cagra.build launched select_k_tiles {tiles} times")
    if tiles != 0:
        fail(f"cagra.build launched the wide-row select_k kernel {tiles} "
             "times (cluster-join must select through TOPK)")
    empty = float((index.graph < 0).float().mean())
    # device bytes the index holds: dataset, graph, seed and BQ planes
    nbytes = sum(t.numel() * t.element_size() for t in (
        index.dataset, index.graph, index.seed_centers, index.seed_members,
        index.bq_rotation, index.bq_center_rot, index.bq_records))
    log(f"[main] cagra.build graph_degree=32 intermediate=64 cluster_join "
        f"bq_bits=1: {build_s:.2f} s, graph {tuple(index.graph.shape)}, "
        f"-1 entries {100 * empty:.4f}%, seed plane "
        f"{tuple(index.seed_members.shape)}, index {nbytes} bytes")
    state.update(cagra_index=index, cagra_build_s=build_s)
    if index.size != N_ROWS or index.graph_degree != 32:
        fail(f"cagra.build: size {index.size}, degree {index.graph_degree}")

    for itopk, bq in ((64, "off"), (128, "off"), (64, "on")):
        sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=4,
                                     bq_traversal=bq)
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s0 in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(cagra.search(res, sp, index,
                                         queries[s0:s0 + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            # queries that found none of their 10: a walk that never
            # reached the true neighbourhood, whatever its buffer
            hits = (ids[:, :, None] == gt_i[:n_q, None, :]).any(dim=2)
            lost = int((hits.sum(dim=1) == 0).sum())
            ms = float(np.median(times[1:]))
            tag = f"itopk{itopk}_bq{bq}_b{batch}"
            state[f"cagra_recall_{tag}"] = r
            state[f"cagra_ms_{tag}"] = ms
            log(f"[main] cagra.search itopk={itopk} search_width=4 "
                f"bq_traversal={bq} batch={batch}: recall@10 {r:.4f} over "
                f"{n_q} queries ({lost} found none of their 10), median "
                f"{ms:.3f} ms per batch")
    # what the walk read, over the first 1,000 queries
    from raft_tpu_torch.ops.beam_search import beam_search

    for bq in (False, True):
        counts = []
        for s0 in (0, 500):
            args, kw = cagra_walk_args(state, queries[s0:s0 + 500], 64, bq)
            counts.append(beam_search(*args, **kw)[2])
        counts = torch.cat(counts)
        tot = counts.to(torch.int64).sum(dim=0).tolist()
        share = tot[2] / max(tot[1], 1)
        state[f"cagra_scored_share_bq{bq}"] = share
        log(f"[main] cagra itopk=64 bq_traversal={'on' if bq else 'off'}: "
            f"{tot[0] / 1000:.2f} live iterations, {tot[1] / 1000:.1f} "
            f"candidates and {tot[2] / 1000:.1f} rows scored exactly per "
            f"query ({100 * share:.3f}% of candidates)")
    if state["cagra_recall_itopk128_bqoff_b500"] < 0.90:
        fail("cagra recall@10 at itopk 128, batch 500 is below 0.90")
    for batch in (10, 500):
        on = state[f"cagra_recall_itopk64_bqon_b{batch}"]
        off = state[f"cagra_recall_itopk64_bqoff_b{batch}"]
        if on < off - 0.02:
            fail(f"cagra BQ-on recall {on:.4f} is more than 0.02 below "
                 f"BQ-off {off:.4f} at batch {batch}")

    sp = cagra.CagraSearchParams(itopk_size=64, search_width=4)
    before = cagra.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    cagra.save(index, buf)
    buf.seek(0)
    after = cagra.search(res, sp, cagra.load(res, buf), queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("cagra save -> load -> search is not bit-identical")
    log(f"[main] cagra save -> load ({buf.getbuffer().nbytes} bytes) -> "
        "search: bit-identical")
    state["launches"].update(read_launches(("beam_search",), "CAGRA"))
    builds_reproducible_cagra(torch, state)


def select_equal(torch, name: str, v, k: int) -> float:
    """select_k_tiles against select_k_tiles_plain on ``v``: values and
    ids must be equal; returns the measured max |dv| over the values."""
    from raft_tpu_torch.ops.fused_topk import (
        select_k_tiles,
        select_k_tiles_plain,
    )

    got = select_k_tiles(v, k)
    want = select_k_tiles_plain(v, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"{name}: select_k differs from the plain version")
    err = float((got[0] - want[0]).abs().max())
    log(f"[kernels] {name}: select_k equals the plain version")
    return err


SERVE_LADDER = (8, 16, 32, 64, 128, 256, 512)
SERVE_REQUESTS = 200


def _serve_configs(state: dict) -> list:
    """(label, index, params, direct search) of each captured serve path,
    on the main phase's full-size indexes."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat

    res = state["res"]
    fl32 = ivf_flat.IvfFlatSearchParams(n_probes=32)
    fl128 = ivf_flat.IvfFlatSearchParams(n_probes=128)
    bq128 = ivf_bq.IvfBqSearchParams(n_probes=128)
    cg64 = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                   bq_traversal="off")
    index, bq_index, cg_index, bf = (state["index"], state["bq_index"],
                                     state["cagra_index"], state["bf"])
    return [
        ("ivf_flat n_probes=32", index, fl32,
         lambda q: ivf_flat.search(res, fl32, index, q, K)),
        ("ivf_flat n_probes=128", index, fl128,
         lambda q: ivf_flat.search(res, fl128, index, q, K)),
        ("ivf_bq n_probes=128", bq_index, bq128,
         lambda q: ivf_bq.search(res, bq128, bq_index, q, K)),
        ("cagra itopk=64", cg_index, cg64,
         lambda q: cagra.search(res, cg64, cg_index, q, K)),
        ("brute_force", bf, None,
         lambda q: brute_force.search(res, bf, q, K)),
    ]


def _served_equal(torch, label, got, want) -> None:
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        bad = int((got[1] != want[1]).sum())
        fail(f"serve {label}: differs from the direct search ({bad} ids)")


def _request_sizes(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [(int(m), int(rng.integers(0, N_QUERIES - m + 1)))
            for m in rng.integers(1, 501, n)]


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()
            if fn.launches}


def phase_serve(torch, state: dict) -> None:
    """The serving path at full size: a SearchExecutor per index (plans
    captured as CUDA graphs, the ladder 8..512 warmed), 200 requests of
    mixed batch sizes each held bit for bit against the direct search,
    no capture after warmup, and the kernel launches of the requests
    alone (the direct searches run before the counts are zeroed) equal
    to the replays' recorded launches; CAGRA's graph pool at bucket 4096;
    the tiered index the same way with its eager plans; eager and
    captured request times with their device-busy shares; a
    DynamicBatcher over the IVF-Flat executor fed from four threads,
    every result held against its direct search."""
    import collections

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.neighbors import ivf_flat, tiered

    res, queries = state["res"], state["queries"]
    configs = _serve_configs(state)
    sizes = _request_sizes(state["seed"] + 8, SERVE_REQUESTS)
    served = collections.Counter()
    executors = {}
    for label, index, params, direct in configs:
        ex = SearchExecutor(res)
        t0 = time.perf_counter()
        ex.warmup(index, buckets=SERVE_LADDER, k=K, params=params)
        warm_s = time.perf_counter() - t0
        built = ex.stats.compile_count
        costs = list(ex.executable_costs().values())
        if built != len(SERVE_LADDER) or not all(c["captured"]
                                                 for c in costs):
            fail(f"serve {label}: warmup captured {built} plans")
        want = [direct(queries[at:at + m]) for m, at in sizes]
        per_replay = {e.bucket: e.launches for e in ex._cache.values()}
        expected = collections.Counter()
        for m, _ in sizes:
            expected.update(per_replay[ex.bucket_for(m)])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = [ex.search(index, queries[at:at + m], K, params=params)
               for m, at in sizes]
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        counts = _launch_counts()
        if counts != dict(expected) or not counts:
            fail(f"serve {label}: {len(sizes)} requests launched {counts}, "
                 f"their replays record {dict(expected)}")
        served.update(counts)
        for g, w in zip(got, want):
            _served_equal(torch, label, g, w)
        if ex.stats.compile_count != built:
            fail(f"serve {label}: {ex.stats.compile_count - built} captures "
                 "after warmup")
        executors[label] = ex
        state.setdefault("serve_pools", {})[label] = sum(
            c["pool_bytes"] for c in costs)
        log(f"[serve] {label}: warmup captured {built} plans in "
            f"{warm_s:.2f} s (capture {sum(c['capture_seconds'] for c in costs):.2f} s, "
            f"graph pools {sum(c['pool_bytes'] for c in costs)} bytes "
            f"{[c['pool_bytes'] for c in costs]}, "
            f"{costs[-1]['launches']} kernel launches a replay at bucket "
            f"512); {len(sizes)} requests of 1-500 rows served in "
            f"{served_s:.3f} s, each bit-identical to the direct search; "
            f"kernel launches of the requests alone {counts}, as their "
            "replays record; no capture after warmup")

    # the default ladder reaches 4096: CAGRA's pool there, the walk
    # tiled by query_tile inside the graph
    cg_label, cg_index, cg_params, cg_direct = [
        c for c in configs if c[0].startswith("cagra")][0]
    big = SearchExecutor(res)
    big.warmup(cg_index, buckets=(4096,), k=K, params=cg_params)
    (cost,) = big.executable_costs().values()
    _served_equal(torch, "cagra bucket 4096",
                  big.search(cg_index, queries[:4096], K, params=cg_params),
                  cg_direct(queries[:4096]))
    state["cagra_pool_4096"] = cost["pool_bytes"]
    log(f"[serve] {cg_label} bucket 4096 (query_tile "
        f"{cg_params.query_tile}): graph pool {cost['pool_bytes']} bytes; a "
        "4096-row request bit-identical to cagra.search")
    del big
    torch.cuda.empty_cache()

    # tiered: the same executor, eager plans (the staging plan is read on
    # the host), one placement generation a dispatch
    t_sp = tiered.TieredSearchParams(n_probes=32)
    t_ex = SearchExecutor(res)
    t_ex.warmup(state["tiered"], buckets=SERVE_LADDER, k=K, params=t_sp)
    built = t_ex.stats.compile_count
    if any(c["captured"] for c in t_ex.executable_costs().values()):
        fail("serve tiered: a tiered plan was captured")
    want = [tiered.search(res, t_sp, state["tiered"], queries[at:at + m], K)
            for m, at in sizes[:50]]
    torch.cuda.synchronize()
    reset_launches()
    got = [t_ex.search(state["tiered"], queries[at:at + m], K, params=t_sp)
           for m, at in sizes[:50]]
    torch.cuda.synchronize()
    counts = _launch_counts()
    if set(counts) != {"tier_scan"}:
        fail(f"serve tiered: 50 requests launched {counts}")
    served.update(counts)
    for g, w in zip(got, want):
        _served_equal(torch, "tiered", g, w)
    if t_ex.stats.compile_count != built:
        fail("serve tiered: plans built after warmup")
    log("[serve] tiered n_probes=32: 50 requests of 1-500 rows through "
        f"eager plans bit-identical to tiered.search, launching {counts}; "
        "no plan built after warmup")
    state["flat_epochs"] = tier_manager_run(
        torch, state, "tiered IVF-Flat",
        lambda: tiered.build_tiered(state["index"], hot_fraction=0.5),
        lambda q, p: ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(
            n_probes=p), state["index"], q, K),
        lambda t_, q, p: tiered.search(res, tiered.TieredSearchParams(
            n_probes=p), t_, q, K),
        tiered.TieredSearchParams, state["index"])
    counts = _launch_counts()
    if set(counts) != {"tier_scan"}:
        fail(f"serve tiered epochs launched {counts}")
    served.update(counts)

    served.update(serve_batcher(torch, state,
                                executors["ivf_flat n_probes=32"]))
    log(f"[serve] launches of the served requests (replays, tiered eager "
        f"calls, batcher replays): {dict(served)}")
    for name in ("fused_knn", "list_major_scan", "bq_scan", "beam_search",
                 "tier_scan"):
        if not served[name]:
            fail(f"{name} was never launched on the serving path")
        state["launches"][name] = state["launches"].get(name, 0) + \
            served[name]
    serve_times(torch, state, configs, executors)
    state["serve_executors"] = executors


BATCHER_SECONDS = 2.0


def _offer_load(torch, b, draw, submit, rate: float, seed: int) -> dict:
    """Offer BATCHER_SECONDS of open-loop load at ``rate`` requests/s to
    the batcher ``b`` from four threads (thread t draws its requests with
    ``draw(rng)`` from ``seed + t``; ``submit(req)`` returns a handle),
    wait for every result, close the batcher, and return the requests
    ``{(thread, ordinal): (req, result)}``, the raw end-to-end latencies
    (a tap on ``metrics.observe_stage``), the wall seconds, the offered
    rate and the kernel launches of the span."""
    import threading

    from raft_tpu_torch.serving import MonotonicClock, metrics
    from raft_tpu_torch.serving.harness import burst_schedule, drive_open_loop

    n_thread = int(BATCHER_SECONDS * rate / 4)
    period = 4.0 / rate
    e2e: list = []
    submitted: list = []
    handles: dict = {}
    observe = metrics.observe_stage

    def tap(name, seconds):
        if name == metrics.E2E:
            e2e.append(seconds)
        observe(name, seconds)

    clock = MonotonicClock()
    start = clock.now() + 0.01

    def feed(t: int) -> None:
        rng = np.random.default_rng(seed + t)

        def sub(ordinal, now):
            req = draw(rng)
            submitted.append(now)
            h = submit(req)
            handles[(t, ordinal)] = (req, h)
            return h

        drive_open_loop(sub, burst_schedule(
            n_thread, 1, period, start_s=start + t * period / 4), clock)

    metrics.observe_stage = tap
    reset_launches()
    threads = [threading.Thread(target=feed, args=(t,)) for t in range(4)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        out = {key: (req, h.result(timeout=60))
               for key, (req, h) in handles.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        b.close()
    finally:
        metrics.observe_stage = observe
    if len(e2e) != len(out):
        fail(f"batcher: {len(e2e)} latencies for {len(out)} requests")
    return {"out": out, "e2e": e2e, "wall": wall, "counts": counts,
            "offered": (len(submitted) - 1) / (max(submitted)
                                               - min(submitted)),
            "p50_ms": float(np.percentile(e2e, 50)) * 1e3,
            "p99_ms": float(np.percentile(e2e, 99)) * 1e3}


@contextlib.contextmanager
def gc_pauses():
    """The list of Python's collector pauses (seconds) inside the block."""
    pauses: list = []
    started: list = []

    def callback(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append(time.perf_counter() - started.pop())

    gc.callbacks.append(callback)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(callback)


def _serial_rate(torch, search, mix) -> float:
    """Requests/s at which ``search(req)`` serves ``mix`` one at a time,
    each ending in a synchronize (20 warm-up requests first)."""
    for req in mix[:20]:
        search(req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for req in mix:
        search(req)
        torch.cuda.synchronize()
    return len(mix) / (time.perf_counter() - t0)


def serve_batcher(torch, state: dict, ex) -> dict:
    """A DynamicBatcher over the captured IVF-Flat executor under an
    open-loop load from four threads: requests of 1-40 rows at random
    offsets, offered for BATCHER_SECONDS at the rate at which the same
    executor serves such requests one at a time, each ending in a
    synchronize (measured here first, on 200 requests of the same mix).
    Every result equals its direct search; no capture under load; the
    kernel launches of the batcher's span equal its replays' record.
    Prints the offered and served rates, the end-to-end latency
    quantiles of the raw samples (and the log2 histogram's estimates)
    and the batch occupancy. Returns the span's launch counts."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher, metrics

    res, queries, index = state["res"], state["queries"], state["index"]
    sp = ivf_flat.IvfFlatSearchParams(n_probes=32)

    def draw(rng):
        m = int(rng.integers(1, 41))
        return m, int(rng.integers(0, N_QUERIES - m + 1))

    rng = np.random.default_rng(state["seed"] + 99)
    rate = _serial_rate(torch, lambda r: ex.search(
        index, queries[r[1]:r[1] + r[0]], K, params=sp),
        [draw(rng) for _ in range(200)])

    metrics.reset()
    built = ex.stats.compile_count
    calls0 = tracing.get_counter("serving.execute.calls")
    per_replay = {e.launches.get("list_major_scan")
                  for e in ex._cache.values()}
    b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.002,
                                         full_batch_rows=256))
    run = _offer_load(torch, b, draw, lambda r: b.submit(
        index, queries[r[1]:r[1] + r[0]], K, params=sp), rate,
        state["seed"] + 100)
    counts, out, wall = run["counts"], run["out"], run["wall"]
    calls = tracing.get_counter("serving.execute.calls") - calls0
    if len(per_replay) != 1 or counts != {
            "list_major_scan": int(calls) * per_replay.pop()}:
        fail(f"serve batcher: {int(calls)} dispatches launched {counts}")
    for (m, at), got in out.values():
        _served_equal(torch, "batcher", got, ivf_flat.search(
            res, sp, index, queries[at:at + m], K))
    if ex.stats.compile_count != built:
        fail("serve batcher: plans captured under load")
    hist = metrics.snapshot()["histograms"][metrics.E2E]
    occ = metrics.occupancy()
    p50, p99 = run["p50_ms"], run["p99_ms"]
    state["batcher"] = dict(
        serial_rps=rate, offered_rps=run["offered"],
        served_rps=len(out) / wall, requests=len(out), p50_ms=p50,
        p99_ms=p99, hist_p50_ms=hist["p50"] * 1e3,
        hist_p99_ms=hist["p99"] * 1e3, occupancy=occ)
    log(f"[serve] batcher: one request at a time the captured executor "
        f"serves {rate:.1f} requests/s of 1-40 rows; that rate offered "
        f"from 4 threads for {BATCHER_SECONDS} s: {len(out)} requests "
        f"submitted at {run['offered']:.1f}/s, all answered in {wall:.3f} s "
        f"({len(out) / wall:.1f}/s), each equal to its direct search; "
        f"e2e latency p50 {p50:.3f} ms p99 {p99:.3f} ms (raw samples; "
        f"the log2 histogram estimates {hist['p50'] * 1e3:.3f} / "
        f"{hist['p99'] * 1e3:.3f}); {occ['batches']} batches, "
        f"{occ['requests_per_batch']:.2f} requests and "
        f"{occ['rows_per_batch']:.1f} rows a batch; launches {counts} "
        f"= {int(calls)} replays; no capture under load")
    return counts


RAGGED_TILE, RAGGED_TILE_SMALL = 256, 64
RAGGED_KS = (10, 16)


def _ragged_configs(state: dict) -> list:
    """(label, index, the (params, k) mix of one params class, the
    executor's tiles, the serve phase's bucketed executor of the same
    index) of each ragged path, on the main phase's indexes: IVF-Flat
    n_probes {20, 24, 32} (class 32), IVF-BQ {72, 96, 128} (class 128),
    CAGRA itopk 64, width 4, max_iterations {0 (40), 48, 64} (class 64),
    tiered like IVF-Flat; k {10, 16} (class 16) everywhere."""
    from raft_tpu_torch.neighbors import cagra, ivf_bq, ivf_flat, tiered

    def mix(params):
        return [(p, k) for p in params for k in RAGGED_KS]

    big = {"ragged_tile": RAGGED_TILE}
    return [
        ("ivf_flat", state["index"], mix(
            ivf_flat.IvfFlatSearchParams(n_probes=n) for n in (20, 24, 32)),
         dict(big, ragged_tile_small=RAGGED_TILE_SMALL),
         "ivf_flat n_probes=32"),
        ("ivf_bq", state["bq_index"], mix(
            ivf_bq.IvfBqSearchParams(n_probes=n) for n in (72, 96, 128)),
         big, "ivf_bq n_probes=128"),
        ("cagra", state["cagra_index"], mix(
            cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                    bq_traversal="off", max_iterations=m)
            for m in (0, 48, 64)), big, "cagra itopk=64"),
        ("tiered", state["tiered"], mix(
            tiered.TieredSearchParams(n_probes=n) for n in (20, 24, 32)),
         big, None),
    ]


def _ragged_draw(mix):
    """A request of 1-40 rows at a random offset with one (params, k) of
    ``mix``: (rows, offset, mix index)."""
    def draw(rng):
        m = int(rng.integers(1, 41))
        return (m, int(rng.integers(0, N_QUERIES - m + 1)),
                int(rng.integers(0, len(mix))))
    return draw


def phase_ragged(torch, state: dict) -> None:
    """The ragged plan family on the serve phase's indexes: per path, an
    executor with packed tiles of 256 rows (IVF-Flat also 64) warmed with
    warmup_ragged (one capture a tile; the tiered plan eager), then 200
    requests of 1-40 rows with mixed n_probes (CAGRA: max_iterations) and
    k under one params class, packed into tiles by a ragged
    DynamicBatcher's grouping (a manual clock: tile-full dispatches, then
    the timer's), each held bit for bit against its own solo bucketed
    search (an eager bucketed executor); no capture after warmup; the
    launches of the packed dispatches equal their replays' record. Prints
    the graph pools against the serve phase's ladders, the packed tile's
    replay ms against the bucketed 256-row replay, and a full tile of
    requests served packed against the same requests one by one. Then
    the A/B of a DynamicBatcher on IVF-Flat, bucketed against ragged,
    under the same mixed load."""
    import collections

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher
    from raft_tpu_torch.serving.harness import ManualClock

    res, queries = state["res"], state["queries"]
    launched = collections.Counter()
    executors = {}
    for label, index, mix, tiles, serve_label in _ragged_configs(state):
        ex = SearchExecutor(res, **tiles)
        n_tiles = 1 + ("ragged_tile_small" in tiles)
        t0 = time.perf_counter()
        ex.warmup_ragged(index, k=mix[0][1], params=mix[0][0])
        warm_s = time.perf_counter() - t0
        costs = list(ex.executable_costs().values())
        captured = [c["captured"] for c in costs]
        want_captured = serve_label is not None
        if (ex.stats.compile_count != n_tiles
                or ex.ragged_executables() != n_tiles
                or captured != [want_captured] * n_tiles):
            fail(f"ragged {label}: warmup built {ex.stats.compile_count} "
                 f"entries (captured {captured}) for {n_tiles} tiles")
        keys = {ex.ragged_key(index, k, params=p) for p, k in mix}
        if len(keys) != 1 or None in keys:
            fail(f"ragged {label}: the mix spans {len(keys)} packing keys")
        rng = np.random.default_rng(state["seed"] + 9)
        reqs = [_ragged_draw(mix)(rng) for _ in range(SERVE_REQUESTS)]
        solo = SearchExecutor(res, capture=False)
        want = [solo.search(index, queries[at:at + m], mix[j][1],
                            params=mix[j][0]) for m, at, j in reqs]
        at_cap = None
        if label == "ivf_bq":
            # the margin prune runs at the class cap's k: hold the packed
            # rows against the solo search at k_class too (sliced to k)
            at_cap = [solo.search(index, queries[at:at + m], 16,
                                  params=mix[j][0]) for m, at, j in reqs]
        del solo
        torch.cuda.synchronize()
        split0 = tracing.counters("serving.execute.padded_rows.p")
        calls0 = tracing.get_counter("serving.execute.calls")
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(ragged=True, max_wait_s=0.002,
                                             capacity=4 * SERVE_REQUESTS),
                           clock=clock, start=False)
        reset_launches()
        t0 = time.perf_counter()
        handles = [b.submit(index, queries[at:at + m], mix[j][1],
                            params=mix[j][0]) for m, at, j in reqs]
        full = b.pump()
        clock.advance(0.002)
        rest = b.pump()
        got = [h.result(timeout=60) for h in handles]
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        counts = _launch_counts()
        b.close()
        dispatches: dict = {}
        for name, v in tracing.counters("serving.execute.padded_rows.p"
                                        ).items():
            tile = int(name.rsplit(".t", 1)[1])
            n = int((v - split0.get(name, 0.0)) // tile)
            if n:
                dispatches[tile] = dispatches.get(tile, 0) + n
        calls = int(tracing.get_counter("serving.execute.calls") - calls0)
        if sum(dispatches.values()) != calls or calls != full + rest:
            fail(f"ragged {label}: {calls} dispatches, by tile "
                 f"{dispatches}, batcher {full} + {rest}")
        per_tile = {e.bucket: e for e in ex._cache.values()}
        expected = collections.Counter()
        for tile, n in dispatches.items():
            entry = per_tile[tile]
            per_call = (entry.launches if entry.graph is not None
                        else {"tier_scan": 1})
            expected.update({name: n * c for name, c in per_call.items()})
        if counts != dict(expected) or not counts:
            fail(f"ragged {label}: {calls} packed dispatches launched "
                 f"{counts}, their replays record {dict(expected)}")
        launched.update(counts)
        bad = sum(int((g[1] != w[1]).any(dim=1).sum())
                  + int((g[0] != w[0]).any(dim=1).sum())
                  for g, w in zip(got, want))
        rows = sum(m for m, _, _ in reqs)
        if at_cap is not None:
            bad_cap = sum(
                int((g[1] != c[1][:, :g[1].shape[1]]).any(dim=1).sum())
                for g, c in zip(got, at_cap))
            log(f"[ragged] {label}: rows differing from the solo search "
                f"at k: {bad}; from the solo search at k_class 16 sliced "
                f"to k: {bad_cap} (of {rows} rows)")
        if bad:
            fail(f"ragged {label}: {bad} row mismatches between packed "
                 "and solo results")
        if ex.stats.compile_count != n_tiles:
            fail(f"ragged {label}: {ex.stats.compile_count - n_tiles} "
                 "captures after warmup")
        pools = sum(c["pool_bytes"] for c in costs)
        line = (f"[ragged] {label}: warmup_ragged built {n_tiles} "
                f"{'captured' if want_captured else 'eager'} entries "
                f"{sorted(per_tile)} in {warm_s:.2f} s; {SERVE_REQUESTS} "
                f"requests ({rows} rows, mixed budgets and k {RAGGED_KS}) "
                f"packed into {calls} dispatches (by tile {dispatches}; "
                f"{full} tile-full, {rest} by the timer) and served in "
                f"{served_s:.3f} s, each bit-identical to its solo "
                f"bucketed search (0 mismatches); launches {counts} as the "
                "replays record; no capture after warmup")
        if want_captured:
            ladder = state["serve_pools"][serve_label]
            bucketed = state["serve_executors"][serve_label]
            (b256,) = [e for e in bucketed._cache.values()
                       if e.bucket == RAGGED_TILE]
            tile_ms = median_ms(per_tile[RAGGED_TILE].graph.replay, 20)
            bucket_ms = median_ms(b256.graph.replay, 20)
            state.setdefault("ragged", {})[label] = dict(
                pool_bytes=pools, ladder_pool_bytes=ladder,
                tile_replay_ms=tile_ms, bucket256_replay_ms=bucket_ms)
            line += (f"; graph pools {pools} bytes "
                     f"{[c['pool_bytes'] for c in costs]} against the "
                     f"bucketed ladder 8..512's {ladder}; packed {RAGGED_TILE}"
                     f"-row tile replay {tile_ms:.3f} ms (CUDA events, "
                     f"median of 20) against the bucketed {RAGGED_TILE}-row "
                     f"replay {bucket_ms:.3f} ms ({serve_label})")
        log(line)
        executors[label] = (ex, index, mix)
    ragged_tile_times(torch, state, executors)
    launched.update(ragged_ab(torch, state, executors["ivf_flat"]))
    log(f"[ragged] launches of the packed dispatches: {dict(launched)}")
    for name in ("list_major_scan", "bq_scan", "beam_search", "tier_scan"):
        if not launched[name]:
            fail(f"{name} was never launched on the ragged path")
        state["launches"][name] = state["launches"].get(name, 0) + \
            launched[name]


def ragged_tile_times(torch, state: dict, executors) -> None:
    """Per captured path: a full tile of mixed requests (drawn until 256
    rows) served by one packed search_ragged call against the same
    requests served one by one by the serve phase's bucketed executor
    (host clock, ending in a synchronize, median of 10)."""
    queries = state["queries"]
    for label, (ex, index, mix) in executors.items():
        if label == "tiered":
            continue
        serve_label = [c[4] for c in _ragged_configs(state)
                       if c[0] == label][0]
        bucketed = state["serve_executors"][serve_label]
        serve_params = [c[2] for c in _serve_configs(state)
                        if c[0] == serve_label][0]
        rng = np.random.default_rng(state["seed"] + 11)
        draw, reqs, rows = _ragged_draw(mix), [], 0
        while rows < RAGGED_TILE:
            m, at, j = draw(rng)
            m = min(m, RAGGED_TILE - rows)
            reqs.append((queries[at:at + m], mix[j][1], mix[j][0]))
            rows += m
        # the bucketed executor holds the serve phase's ladder only (its
        # params, k 10): each request is served there under those

        def packed():
            ex.search_ragged(index, [q for q, _, _ in reqs],
                             [k for _, k, _ in reqs],
                             params_list=[p for _, _, p in reqs])

        def one_by_one():
            for q, _, _ in reqs:
                bucketed.search(index, q, K, params=serve_params)

        times = {}
        for name, fn in (("packed", packed), ("one_by_one", one_by_one)):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        state["ragged"][label].update(
            tile_requests=len(reqs), packed_ms=times["packed"],
            one_by_one_ms=times["one_by_one"])
        log(f"[ragged] {label}: a full {RAGGED_TILE}-row tile of "
            f"{len(reqs)} mixed requests served packed in "
            f"{times['packed']:.3f} ms (one search_ragged call) against "
            f"{times['one_by_one']:.3f} ms one by one through the serve "
            f"phase's bucketed captured executor ({serve_label}, k 10; "
            "host clock, median of 10)")


def ragged_ab(torch, state: dict, ragged) -> dict:
    """The A/B of a DynamicBatcher on the IVF-Flat index: bucketed (a
    captured executor warmed on the ladder 8..256 for each (n_probes, k)
    of the mix) against ragged=True (the ragged path's executor, tiles
    256 and 64), each fed the same mixed traffic (1-40 rows, n_probes
    {20, 24, 32}, k {10, 16}) from four threads for BATCHER_SECONDS at
    the rate the bucketed captured executor serves it one at a time
    (measured here). Every result equals its direct search; no capture
    under load in either mode. Prints p50/p99, rows a dispatch, the
    pad-waste fraction and the dispatches of each mode. Returns the
    launch counts of both runs."""
    import collections

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher, metrics

    rex, index, mix = ragged
    res, queries = state["res"], state["queries"]
    bex = SearchExecutor(res)
    ladder = tuple(b for b in SERVE_LADDER if b <= RAGGED_TILE)
    for p, k in mix:
        bex.warmup(index, buckets=ladder, k=k, params=p)
    draw = _ragged_draw(mix)
    rng = np.random.default_rng(state["seed"] + 199)
    rate = _serial_rate(torch, lambda r: bex.search(
        index, queries[r[1]:r[1] + r[0]], mix[r[2]][1],
        params=mix[r[2]][0]), [draw(rng) for _ in range(200)])
    runs, launched, direct = {}, {}, {}
    for mode in ("bucketed", "ragged"):
        ex = rex if mode == "ragged" else bex
        built = ex.stats.compile_count
        metrics.reset()
        b = DynamicBatcher(ex, BatcherConfig(
            max_wait_s=0.002, full_batch_rows=RAGGED_TILE,
            ragged=mode == "ragged"))
        # each mode starts from the same collector state: a full
        # collection that falls inside one mode's 2 s stalls its worker
        # for 0.1-0.2 s on this process's heap (scripts/torch_ragged_ab.py)
        gc.collect()
        with gc_pauses() as pauses:
            run = _offer_load(torch, b, draw, lambda r: b.submit(
                index, queries[r[1]:r[1] + r[0]], mix[r[2]][1],
                params=mix[r[2]][0]), rate, state["seed"] + 200)
        derived = metrics.derived()
        calls = tracing.get_counter("serving.execute.calls")
        rows = tracing.get_counter("serving.execute.rows")
        if ex.stats.compile_count != built:
            fail(f"ragged A/B {mode}: plans captured under load")
        for (m, at, j), got in run["out"].values():
            key = (m, at, j)
            if key not in direct:
                direct[key] = ivf_flat.search(
                    res, mix[j][0], index, queries[at:at + m], mix[j][1])
            _served_equal(torch, f"ragged A/B {mode}", got, direct[key])
        runs[mode] = dict(
            requests=len(run["out"]), offered_rps=run["offered"],
            served_rps=len(run["out"]) / run["wall"], p50_ms=run["p50_ms"],
            p99_ms=run["p99_ms"], dispatches=int(calls),
            rows_per_dispatch=rows / calls if calls else 0.0,
            pad_waste=derived["pad_waste_fraction"],
            pad_waste_by_class=derived["pad_waste_by_class"],
            gc_max_ms=max(pauses, default=0.0) * 1e3)
        launched[mode] = run["counts"]
        r = runs[mode]
        log(f"[ragged] A/B {mode}: {r['requests']} requests offered at "
            f"{r['offered_rps']:.1f}/s (the bucketed executor's one-at-a-"
            f"time rate {rate:.1f}/s), served at {r['served_rps']:.1f}/s, "
            f"each equal to its direct search; e2e p50 {r['p50_ms']:.3f} "
            f"ms p99 {r['p99_ms']:.3f} ms (raw samples); {r['dispatches']} "
            f"dispatches, {r['rows_per_dispatch']:.1f} rows a dispatch, "
            f"pad waste {r['pad_waste']:.4f} (by class "
            f"{r['pad_waste_by_class']}); the collector's longest pause "
            f"{r['gc_max_ms']:.3f} ms; launches {run['counts']}; no "
            "capture under load")
    state["ragged_ab"] = dict(serial_rps=rate, **runs)
    pools = sum(c["pool_bytes"] for c in bex.executable_costs().values())
    log(f"[ragged] A/B: the bucketed executor's {bex.stats.compile_count} "
        f"plans ({len(mix)} (n_probes, k) pairs x buckets {ladder}) hold "
        f"{pools} bytes of graph pools; the ragged executor's "
        f"{rex.stats.compile_count} hold "
        f"{sum(c['pool_bytes'] for c in rex.executable_costs().values())}")
    del bex
    torch.cuda.empty_cache()
    total = collections.Counter()
    for counts in launched.values():
        total.update(counts)
    return dict(total)


def serve_times(torch, state: dict, configs, executors) -> None:
    """Median request ms (host clock, each request ending in a
    synchronize) of the direct search, an eager executor and the captured
    executor at batch 10 and 500; the direct request's device-busy share
    and device ops (torch.profiler, five requests); and the captured
    request's graph time (CUDA events around the bucket's graph replay
    alone, median of 20) over its wall time. torch.profiler records only
    part of a replayed graph's kernels, so its reading of a captured
    request is printed but not used."""
    from raft_tpu_torch import SearchExecutor

    res, queries = state["res"], state["queries"]
    profiled(torch, lambda: torch.ones(1, device="cuda").sum())
    rows = []
    for label, index, params, direct in configs:
        eager = SearchExecutor(res, capture=False)
        cap = executors[label]
        for batch in (10, 500):
            q = queries[:batch]
            modes = {"direct": lambda: direct(q),
                     "eager": lambda: eager.search(index, q, K,
                                                   params=params),
                     "captured": lambda: cap.search(index, q, K,
                                                    params=params)}
            row = {"request": f"{label} batch={batch}"}
            for mode, fn in modes.items():
                fn()
                torch.cuda.synchronize()
                times = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                row[f"{mode}_ms"] = float(np.median(times))
                if mode != "eager":
                    wall_us, events = profiled(torch, fn)
                    if not events:
                        wall_us, events = profiled(torch, fn)
                    busy, _, _, ops = device_split(events)
                    row[f"{mode}_busy"] = busy / wall_us
                    row[f"{mode}_ops"] = ops
            (entry,) = [e for e in cap._cache.values()
                        if e.bucket == cap.bucket_for(batch)]
            row["graph_ms"] = median_ms(entry.graph.replay, 20)
            rows.append(row)
            log(f"[serve] {row['request']}: direct {row['direct_ms']:.3f} "
                f"ms (device busy {100 * row['direct_busy']:.1f}%, "
                f"{row['direct_ops']} device ops), eager executor "
                f"{row['eager_ms']:.3f} ms, captured {row['captured_ms']:.3f}"
                f" ms (graph replay {row['graph_ms']:.3f} ms on the device: "
                f"{100 * row['graph_ms'] / row['captured_ms']:.1f}% of the "
                f"request; the profiler saw {row['captured_ops']} device ops "
                f"and {100 * row['captured_busy']:.1f}% busy)")
    state["serve_times"] = rows


def profiled(torch, fn, reps: int = 5):
    """(wall us per request, device events) of ``reps`` requests under
    torch.profiler, each ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    # device-side kernels and copies only: the aten ops and the tracing
    # ranges (raft_tpu.*, which the profiler also shows on the device's
    # timeline) would count their time twice
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0
                     and not e.key.startswith("raft_tpu.")]


def device_split(events, reps: int = 5):
    """(kernel busy us, copy us, copies, device ops) per request of
    :func:`profiled`'s events. Copies (the tiered scan's staging runs on
    a side stream, beside the kernels) are kept apart from the busy
    time."""
    copies = [e for e in events if e.key.startswith("Memcpy")]
    busy = sum(e.self_device_time_total for e in events
               if e not in copies) / reps
    copy = sum(e.self_device_time_total for e in copies) / reps
    return (busy, copy, sum(e.count for e in copies) // reps,
            sum(e.count for e in events) // reps)


def phase_profile(torch, state: dict) -> None:
    """Where one request's time goes: torch.profiler over five requests
    of each kind; device busy time per request against its wall time,
    and the device time by kernel."""
    from raft_tpu_torch.neighbors import (
        brute_force,
        cagra,
        ivf_bq,
        ivf_flat,
        tiered,
    )

    res, index, queries, bf = (state["res"], state["index"],
                               state["queries"], state["bf"])
    tier_sp = tiered.TieredSearchParams(n_probes=128)
    bq_index = state["bq_index"]
    bq_sp = ivf_bq.IvfBqSearchParams(n_probes=128)
    cg_index = state["cagra_index"]
    cg_sp = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                    bq_traversal="off")
    from raft_tpu_torch.ops.fused_topk import select_k_tiles

    # select_k's device time by kernel (the memset of its bound words and
    # the one selection kernel) at the main path's call and, after the
    # times phase, at 64 x 2^20; ahead of the tiered requests, after whose
    # sessions the profiler recorded no device event (PR 7's runs)
    requests = {
        "brute_force batch=500": lambda: brute_force.search(
            res, bf, queries[:500], K),
        f"select_k (64, {N_ROWS}) k={K}": lambda: select_k_tiles(
            state["select_slab"], K),
    }
    if "select_wide" in state:
        requests["select_k 64 x 2^20 k=64"] = lambda: select_k_tiles(
            state["select_wide"], 64)
    requests.update({
        "cagra itopk=64 batch=10": lambda: cagra.search(
            res, cg_sp, cg_index, queries[:10], K),
        "cagra itopk=64 batch=500": lambda: cagra.search(
            res, cg_sp, cg_index, queries[:500], K),
        "ivf_bq n_probes=128 batch=10": lambda: ivf_bq.search(
            res, bq_sp, bq_index, queries[:10], K),
        "ivf_bq n_probes=128 batch=500": lambda: ivf_bq.search(
            res, bq_sp, bq_index, queries[:500], K),
        "ivf_flat n_probes=32 batch=10": lambda: ivf_flat.search(
            res, ivf_flat.IvfFlatSearchParams(n_probes=32), index,
            queries[:10], K),
        "ivf_flat n_probes=128 batch=500": lambda: ivf_flat.search(
            res, ivf_flat.IvfFlatSearchParams(n_probes=128), index,
            queries[:500], K),
        "tiered n_probes=128 batch=10": lambda: tiered.search(
            res, tier_sp, state["tiered"], queries[:10], K),
        "tiered n_probes=128 batch=500": lambda: tiered.search(
            res, tier_sp, state["tiered"], queries[:500], K),
    })

    # a session that records no device event happens (the first of a
    # process, and now and then later): one session first to start the
    # profiler, and a request whose session records none is profiled again
    profiled(torch, lambda: torch.ones(1, device="cuda").sum())
    for label, fn in requests.items():
        fn()
        torch.cuda.synchronize()
        wall_us, events = profiled(torch, fn)
        if not events:
            log(f"[profile] {label}: no device event recorded; again")
            wall_us, events = profiled(torch, fn)
        busy_us, copy_us, n_copies, n_ops = device_split(events)
        log(f"[profile] {label}: wall {wall_us:.1f} us per request, device "
            f"busy (kernels) {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}"
            f"%), copies {copy_us:.1f} us ({n_copies} a request), "
            f"{n_ops} device ops per request")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:6]:
            log(f"[profile]   {e.self_device_time_total / 5:10.1f} us  "
                f"x{e.count // 5:<3d} {e.key[:90]}")


def phase_times(torch, state: dict) -> list:
    from raft_tpu_torch.neighbors._batching import coarse_select
    from raft_tpu_torch.ops.fused_topk import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    x, queries, index, bf = (state["x"], state["queries"], state["index"],
                             state["bf"])
    records = []
    saved = {name: fn.launches for name, fn in _counted().items()}

    # fused_knn at the brute-force request shape: q=500, n=1M, d=128, k=10
    q = queries[:500]
    got = fused_knn(q, x, K, dataset_norms=bf.norms)
    want = fused_knn_plain(q, x, K, dataset_norms=bf.norms)
    err = compare("fused_knn main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: fused_knn(q, x, K, dataset_norms=bf.norms), 20)
    plain_ms = median_ms(
        lambda: fused_knn_plain(q, x, K, dataset_norms=bf.norms), 3, 1)
    xn_row = bf.norms[None, :]
    lib_ms = median_ms(lambda: torch.topk(
        torch.addmm(xn_row, q, x.T, beta=1.0, alpha=-2.0), K, dim=1,
        largest=False), 10)
    n, d = x.shape
    nbytes = 4 * (500 * d + n * d + n) + 8 * 500 * K
    flops = 2.0 * 500 * n * d
    # the route's bound: 3xTF32, three TF32 products a multiply-add; the
    # CUDA-core figure of PRs 1-6 beside it
    bound_f32_ms = flops / PEAK_OPS_PER_S["f32"] * 1e3
    # the bf16 route on the same rows rounded to bf16 (their own norms)
    xb = x.to(torch.bfloat16)
    xbn = (xb.float() * xb.float()).sum(dim=1)
    compare("fused_knn main shape bf16",
            fused_knn(q, xb, K, dataset_norms=xbn),
            fused_knn_plain(q, xb, K, dataset_norms=xbn), exact_ids=False)
    ms_b = median_ms(lambda: fused_knn(q, xb, K, dataset_norms=xbn), 20)
    t_b = max((2 * (500 * d + n * d) + 4 * n + 8 * 500 * K)
              / PEAK_BYTES_PER_S, flops / PEAK_OPS_PER_S["bf16"]) * 1e3
    del xb, xbn
    log(f"[times] fused_knn at q=500 n=1M d=128 k=10: float32 {ms:.4f} ms "
        f"(bound {3 * flops / PEAK_OPS_PER_S['tf32'] * 1e3:.4f} ms by TF32 "
        f"operations, {bound_f32_ms:.4f} ms on the CUDA cores), bfloat16 "
        f"{ms_b:.4f} ms (bound {t_b:.4f} ms); the earlier CUDA-core design "
        f"took {EARLIER_KNN_MS} ms (NVIDIA H100 80GB HBM3, 700 W)")
    records.append(_record(
        "fused_knn", "raft_tpu_torch/csrc/fused_knn.cu",
        "raft_tpu/ops/fused_topk.py:66", state["launches"]["fused_knn"],
        err, ms, plain_ms, nbytes, {"tf32": 3.0 * flops}, lib_ms,
        bound_f32_ms=bound_f32_ms, bf16_ms=ms_b, bf16_bound_ms=t_b))

    # the IVF scan at the main path's batch-500, n_probes=128 request
    qf = queries[:500]
    ip = qf @ index.centers.T
    probes = coarse_select(-(index.center_norms[None, :] - 2.0 * ip), 128,
                           "exact")
    args = (qf, index.data, index.data_norms, index.indices, probes, None)
    kw = dict(k=K, metric=index.metric)
    got = list_major_scan(*args, engine="cuda", **kw)
    want = list_major_scan(*args, engine="torch", **kw)
    err = compare("list_major_scan main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: list_major_scan(*args, engine="cuda", **kw), 20)
    plain_ms = median_ms(
        lambda: list_major_scan(*args, engine="torch", **kw), 3, 1)
    # data-dependent work: rows of the probed lists, once per probe
    sizes = index.list_sizes.to(torch.int64)
    uniq = torch.unique(probes.to(torch.int64))
    probed_rows = int(sizes[probes.to(torch.int64)].sum())
    union_rows = int(sizes[uniq].sum())
    nbytes = (union_rows * (d * index.data.element_size() + 8)
              + 4 * 500 * d + 4 * probes.numel() + 8 * 500 * K)
    flops = 2.0 * probed_rows * d
    records.append(_record(
        "list_major_scan", "raft_tpu_torch/csrc/ivf_scan.cu",
        "raft_tpu/ops/ivf_scan.py:367", state["launches"]["list_major_scan"],
        err, ms, plain_ms, nbytes, {"f32": flops}, None))
    log(f"[times] scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows, {union_rows} rows in the union of {uniq.numel()} lists")
    # batch 10: the time of the longest row chunk, no longer of the
    # longest list (the kernel's design target)
    q10 = queries[:10]
    p10 = coarse_select(-(index.center_norms[None, :]
                          - 2.0 * (q10 @ index.centers.T)), 128, "exact")
    args10 = (q10, index.data, index.data_norms, index.indices, p10, None)
    compare("list_major_scan batch 10",
            list_major_scan(*args10, engine="cuda", **kw),
            list_major_scan(*args10, engine="torch", **kw), exact_ids=False)
    ms10 = median_ms(lambda: list_major_scan(*args10, engine="cuda", **kw),
                     20)
    log(f"[times] list_major_scan at n_probes=128: batch 500 {ms:.4f} ms, "
        f"batch 10 {ms10:.4f} ms (CUDA events around the wrapper, its glue "
        f"included); the earlier one-block-a-list design took "
        f"{EARLIER_SCAN_MS} ms at batch 500 (NVIDIA H100 80GB HBM3, 700 W)")
    state["scan_ms_b10"] = ms10
    records.append(times_bq(torch, state))
    records.append(times_select(torch, state))
    records.append(times_beam(torch, state))
    records.append(times_tier(torch, state))
    records.append(times_stream(torch, state))
    if "pq_record" in state:
        # the pq phase timed the kernel; later phases (stream, dist) add
        # their launches
        records.append(dict(state["pq_record"],
                            launches=state["launches"]["ivf_pq_scan"]))
    for name, fn in _counted().items():
        fn.launches = saved[name]
    return records


def times_bq(torch, state: dict) -> dict:
    """The IVF-BQ scan at the main path's batch-500, n_probes=128 request."""
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.ops.bq_scan import (
        CLUSTER_SIZES,
        _bq_scan_cuda,
        _bq_scan_torch,
        bq_list_major_scan,
    )
    from raft_tpu_torch.ops.ivf_scan import unique_lists

    index, queries = state["bq_index"], state["queries"]
    qf = queries[:500]
    probes = ivf_bq.coarse_probes(index, qf, 128)[0]
    args = (qf, qf @ index.rotation.T, index.centers @ index.rotation.T,
            index.codes, index.rnorm, index.cfac, index.errw, index.indices,
            index.data, index.data_norms, probes, None)
    qbits = 4
    kw = dict(k=K, metric=index.metric, epsilon=3.0, query_bits=qbits)
    got = bq_list_major_scan(*args, engine="cuda", **kw)
    rows_read = torch.zeros(index.indices.shape, dtype=torch.bool,
                            device="cuda")
    want = _bq_scan_torch(*args, rows_read=rows_read, **kw)
    err = bq_equal("bq_scan main shape", got, want)
    ms = median_ms(lambda: bq_list_major_scan(*args, engine="cuda", **kw),
                   20)
    # every cluster size at batch 10 and 500 (the wrapper picks one), each
    # held against the plain version before it is timed
    for q in (10, 500):
        sub = [a[:q] if i in (0, 1, 10) else a for i, a in enumerate(args)]
        want_q = want if q == 500 else _bq_scan_torch(*sub, **kw)
        bq_list_major_scan(*sub, engine="cuda", **kw)
        chosen = bq_list_major_scan.last_cluster
        for c in CLUSTER_SIZES:
            got_c = _bq_scan_cuda(*sub, cluster=c, **kw)
            if bq_list_major_scan.last_cluster != c:
                fail(f"bq_scan q={q}: cluster {c} asked, "
                     f"{bq_list_major_scan.last_cluster} launched")
            err = max(err, bq_equal(f"bq_scan q={q} n_probes=128 cluster={c}",
                                    got_c, want_q))
        by_size = {c: median_ms(lambda c=c: _bq_scan_cuda(
            *sub, cluster=c, **kw), 10) for c in CLUSTER_SIZES}
        state[f"bq_ms_by_cluster_b{q}"] = by_size
        log(f"[times] bq_scan q={q} n_probes=128 by cluster size: "
            + ", ".join(f"{c}: {v:.4f} ms" for c, v in by_size.items())
            + f"; the wrapper chooses {chosen}; every size equals the plain "
            "version on distances, ids and rows reranked (the earlier one-"
            f"block-a-query kernel: {EARLIER_BQ_MS[q]} ms, NVIDIA H100 80GB "
            "HBM3, 700 W)")
    plain_ms = median_ms(
        lambda: bq_list_major_scan(*args, engine="torch", **kw), 3, 1)
    # data-dependent work. Bytes: the union's code and correction rows
    # once, the raw row (and norm) of every row some query reranked once,
    # the queries, the union's rotated centers, the probes and the output.
    # Operations: per (query, probed row) pair, a XOR and a popcount per
    # code word and query bit-plane (plus the adds that sum them), and the
    # estimate's float assembly (6 per level, 16 for est, margin and
    # prune); 2d float32 per reranked pair; a popcount per union code word
    sizes = index.list_sizes.to(torch.int64)
    union = unique_lists(probes, index.n_lists).to(torch.int64)
    union = union[union < index.n_lists]
    union_rows = int(sizes[union].sum())
    probed_rows = int(sizes[probes.to(torch.int64)].sum())
    survivors = int(want[2].sum())
    read_rows = int(rows_read.sum())
    d, de, bits = index.dim, index.dim_ext, index.bits
    words = bits * de // 32
    nbytes = (union_rows * (4 * words + 4 * (bits + 2) + 4)
              + read_rows * (4 * d + 4)
              + 4 * 500 * (d + de) + 4 * de * union.numel()
              + 4 * probes.numel() + 8 * 500 * K)
    ops = {"f32": 2.0 * survivors * d + (6 * bits + 16) * probed_rows,
           "popc": float(probed_rows * words * qbits + union_rows * words),
           "int32": (2.0 * probed_rows * words * qbits
                     + 3.0 * probed_rows * bits * qbits)}
    log(f"[times] bq_scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows, {union_rows} rows in the union of {union.numel()} lists, "
        f"{survivors} (query, row) pairs reranked "
        f"({100 * survivors / probed_rows:.3f}%) over {read_rows} distinct "
        f"rows; distances, ids and rows reranked per query equal the plain "
        f"version's")
    return _record("bq_scan", "raft_tpu_torch/csrc/bq_scan.cu",
                   "raft_tpu/ops/bq_scan.py:506", state["launches"]["bq_scan"],
                   err, ms, plain_ms, nbytes, ops, None)


def times_select(torch, state: dict) -> dict:
    """select_k at the JAX package's full bench size: 64 x 2^20, k = 64;
    its error is the larger of this comparison's and the main path's."""
    from raft_tpu_torch.ops.fused_topk import (
        select_k_tiles,
        select_k_tiles_plain,
    )

    b, n, k = 64, 1 << 20, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    v = torch.randn(b, n, generator=g, device="cuda")
    err = max(select_equal(torch, "select_k 64 x 2^20 k=64", v, k),
              state["select_k_err"])
    ms = median_ms(lambda: select_k_tiles(v, k), 20)
    plain_ms = median_ms(lambda: select_k_tiles_plain(v, k), 5)
    lib_ms = median_ms(lambda: torch.topk(v, k, dim=1, largest=False), 20)
    # the shape of the CAGRA build's launches (cluster-join: one per
    # cluster and pass, a cluster's (m, m) squared distances with an
    # infinite diagonal, k = 64; m ~ 1M / 489 clusters of ~2,048 rows)
    x = state["x"][:2048]
    nr = (x * x).sum(dim=1)
    slab = torch.clamp(nr[:, None] + nr[None, :] - 2.0 * (x @ x.T), min=0.0)
    slab.fill_diagonal_(float("inf"))
    select_equal(torch, "select_k 2048 x 2048 k=64", slab, k)
    c_ms = median_ms(lambda: select_k_tiles(slab, k), 20)
    c_plain = median_ms(lambda: select_k_tiles_plain(slab, k), 5)
    c_lib = median_ms(lambda: torch.topk(slab, k, dim=1, largest=False), 20)
    # what cluster-join now runs at that shape: matrix.select_k (AUTO: TOPK)
    from raft_tpu_torch.matrix.select_k import select_k

    c_auto = median_ms(lambda: select_k(state["res"], slab, k), 20)
    log(f"[times] matrix.select_k AUTO (TOPK) at the CAGRA build's shape: "
        f"{c_auto:.4f} ms")
    c_bound = (4 * slab.numel() + 8 * 2048 * k) / PEAK_BYTES_PER_S * 1e3
    log(f"[times] select_k at the CAGRA build's shape (2048 x 2048, k=64): "
        f"{c_ms:.4f} ms (plain {c_plain:.3f} ms, torch.topk {c_lib:.4f} ms), "
        f"bound {c_bound:.4f} ms by bytes")
    # the main path's call: the IVF-BQ path's (64, 1,000,000) slab, k = 10
    main = state["select_slab"]
    m_ms = median_ms(lambda: select_k_tiles(main, K), 20)
    m_lib = median_ms(lambda: torch.topk(main, K, dim=1, largest=False), 20)
    m_bound = (4 * main.numel() + 8 * 64 * K) / PEAK_BYTES_PER_S * 1e3
    log(f"[times] select_k at 64 x 2^20, k=64: {ms:.4f} ms; 2048 x 2048, "
        f"k=64: {c_ms:.4f} ms (torch.topk {c_lib:.4f} ms); the main path's "
        f"(64, {N_ROWS}), k={K}: {m_ms:.4f} ms (torch.topk {m_lib:.4f} ms, "
        f"bound {m_bound:.4f} ms by bytes); the earlier insertion design "
        f"took {EARLIER_SELECT_MS['64x2^20']} and "
        f"{EARLIER_SELECT_MS['2048x2048']} ms at the first two (NVIDIA H100 "
        "80GB HBM3, 700 W)")
    state["select_wide"] = v
    return _record("select_k", "raft_tpu_torch/csrc/select_k.cu",
                   "raft_tpu/ops/fused_topk.py:290",
                   state["launches"]["select_k"], err, ms, plain_ms,
                   4 * b * n + 8 * b * k, {"f32": float(b * n)}, lib_ms,
                   ms_2048x2048=c_ms, library_ms_2048x2048=c_lib,
                   ms_main_k10=m_ms, library_ms_main_k10=m_lib,
                   bound_ms_main_k10=m_bound)


def times_beam(torch, state: dict) -> dict:
    """The beam kernel at the main path's batch-500, itopk-64 request
    (BQ traversal off), on that request's seeds, walked in one launch
    (the request's query_tile of 256 walks it in two)."""
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain

    index, queries = state["cagra_index"], state["queries"]
    q = queries[:500]
    args, kw = cagra_walk_args(state, q, 64, False)
    got = beam_search(*args, **kw)
    cluster500 = beam_search.last_cluster
    rows_read = torch.zeros((index.size, 2), dtype=torch.bool, device="cuda")
    want = beam_search_plain(*args, rows_read=rows_read, **kw)
    err = beam_equal("beam_search main shape", got, want)
    ms = median_ms(lambda: beam_search(*args, **kw), 20)
    # batch 10: a cluster of CTAs a query
    args10, kw10 = cagra_walk_args(state, queries[:10], 64, False)
    beam_equal("beam_search batch 10", beam_search(*args10, **kw10),
               beam_search_plain(*args10, **kw10))
    cluster10 = beam_search.last_cluster
    ms10 = median_ms(lambda: beam_search(*args10, **kw10), 20)
    log(f"[times] beam_search at itopk 64: batch 500 {ms:.4f} ms on a "
        f"cluster of {cluster500} CTA(s) a query, batch 10 {ms10:.4f} ms on "
        f"a cluster of {cluster10} ({10 * cluster10} CTAs); the earlier "
        f"one-block-a-query design took {EARLIER_BEAM_MS} ms at batch 500 "
        "(NVIDIA H100 80GB HBM3, 700 W)")
    state.update(beam_ms_b10=ms10, beam_cluster_b10=cluster10,
                 beam_cluster_b500=cluster500)
    plain_ms = median_ms(lambda: beam_search_plain(*args, **kw), 3, 1)
    # data-dependent work. Bytes: each distinct row scored once, each
    # distinct parent's adjacency row once, the queries, seeds and output.
    # Operations: 2d float32 per scored (query, row) pair and 2d per
    # distinct scored row for its norm
    d, deg, seeds = index.dim, index.graph_degree, args[3]
    pairs = int(want[2][:, 2].to(torch.int64).sum())
    rows = int(rows_read[:, 0].sum())
    parents = int(rows_read[:, 1].sum())
    nbytes = (rows * d * index.dataset.element_size() + parents * deg * 4
              + 4 * q.numel() + 4 * seeds.numel() + 8 * 500 * K)
    flops = 2.0 * d * (pairs + rows)
    log(f"[times] beam_search work at q=500 itopk=64: {pairs} (query, row) "
        f"pairs scored over {rows} distinct rows, {parents} distinct "
        f"parents, {int(want[2][:, 0].sum())} live iterations; distances, "
        "ids and counts equal the plain version's")
    return _record("beam_search", "raft_tpu_torch/csrc/beam_search.cu",
                   "raft_tpu/ops/beam_search.py:90",
                   state["launches"]["beam_search"], err, ms, plain_ms,
                   nbytes, {"f32": flops}, None)


def times_tier(torch, state: dict) -> dict:
    """The tiered scan at the main path's batch-500, n_probes=128 request,
    after the placement epoch; its hot and cold GB/s against the two
    rooflines, and the all-device scan's ms on the same request."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    t, index, queries = state["tiered"], state["index"], state["queries"]
    qf = queries[:500]
    probes = ivf_flat.coarse_probes(qf, t.centers, t.center_norms, t.metric,
                                    128, "exact")
    hot, cold, hmap, cmap = t.tier_arrays()
    args = (qf, hot, cold, hmap, cmap, t.data_norms, t.indices, probes, None)
    kw = dict(k=K, metric=t.metric)
    got = tiered_list_major_scan(*args, engine="cuda", **kw)
    whole_args = (qf, index.data, index.data_norms, index.indices, probes,
                  None)
    whole = list_major_scan(*whole_args, engine="cuda", **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])):
        fail("tier_scan main shape: differs from the all-device scan")
    want = tiered_list_major_scan(*args, engine="torch", **kw)
    err = compare("tier_scan main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: tiered_list_major_scan(*args, engine="cuda",
                                                  **kw), 20)
    whole_ms = median_ms(lambda: list_major_scan(*whole_args, engine="cuda",
                                                 **kw), 20)
    plain_ms = median_ms(lambda: tiered_list_major_scan(
        *args, engine="torch", **kw), 3, 1)
    # data-dependent work: the union's rows read once per tier (real rows:
    # tiles of padding are skipped), the norm and id planes of the union
    # on the card, the queries, probes and output; 2d float32 operations
    # per (query, probed row) pair
    hot_rows, cold_rows, n_cold = _probed_rows(torch, t, probes)
    probed_rows = int(t.list_sizes.to(torch.int64)[probes.to(torch.int64)]
                      .sum())
    d = t.dim
    hot_bytes = hot_rows * d * 4
    cold_bytes = cold_rows * d * 4
    nbytes = (hot_bytes + (hot_rows + cold_rows) * 8 + 4 * 500 * d
              + 4 * probes.numel() + 8 * 500 * K)
    flops = 2.0 * probed_rows * d
    log(f"[times] tier_scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows; the union holds {hot_rows} hot rows ({hot_bytes} bytes on "
        f"the card) and {cold_rows} cold rows of {n_cold} cold lists "
        f"({cold_bytes} bytes over the host link); the all-device scan "
        f"takes {whole_ms:.4f} ms on this request; the tier scan reads the "
        f"hot rows at {hot_bytes / ms / 1e6:.1f} GB/s (device memory "
        f"roofline {state['hbm_gbps']:.1f} GB/s) and the cold rows at "
        f"{cold_bytes / ms / 1e6:.2f} GB/s (host link roofline "
        f"{state['link_gbps']:.2f} GB/s, the ring copies on the device "
        + ("not measured" if state["ring_gbps"] is None
           else f"{state['ring_gbps']:.2f} GB/s")
        + "); ids and distances equal the all-device scan's")
    state["tier_whole_ms"] = whole_ms
    log(f"[times] tier_scan: {ms:.4f} ms against the earlier in-place "
        f"kernel's {EARLIER_TIER_MS} ms on this request (NVIDIA H100 80GB "
        "HBM3, 700 W), "
        f"the all-device scan {whole_ms:.4f} ms and the cold bytes' link "
        f"time {cold_bytes / HOST_LINK_BYTES_PER_S * 1e3:.4f} ms")
    return _record("tier_scan", "raft_tpu_torch/csrc/tier_scan.cu",
                   "raft_tpu/ops/tier_scan.py:328",
                   state["launches"]["tier_scan"], err, ms, plain_ms, nbytes,
                   {"f32": flops}, None, link_bytes=cold_bytes)


def times_stream(torch, state: dict) -> dict:
    """stream_read_sum over the hot plane, (n_hot * m, 128) float32."""
    from raft_tpu_torch.ops.fused_topk import (
        stream_read_sum,
        stream_read_sum_plain,
    )

    x = state["tiered"].hot_data.reshape(-1, DIM)
    got = stream_read_sum(x)
    want = stream_read_sum_plain(x)
    ref = x.double().sum(dim=0, keepdim=True)
    scale = x.double().abs().sum(dim=0, keepdim=True)
    if bool(((got.double() - ref).abs() > 1e-6 * scale).any()):
        fail("stream_read_sum main shape: off the float64 sum by more than "
             "1e-6 sum|x|")
    err = float((got - want).abs().max())
    ms = median_ms(lambda: stream_read_sum(x), 20)
    plain_ms = median_ms(lambda: stream_read_sum_plain(x), 20)
    lib_ms = median_ms(lambda: torch.sum(x, dim=0), 20)
    n, d = x.shape
    return _record("stream_read_sum", "raft_tpu_torch/csrc/stream_read.cu",
                   "raft_tpu/ops/fused_topk.py:398",
                   state["launches"]["stream_read_sum"], err, ms, plain_ms,
                   4 * n * d + 4 * d, {"f32": float(n * d)}, lib_ms)


# ---------------------------------------------------------------------------
# the IVF-PQ path
# ---------------------------------------------------------------------------

# the sift-128-euclidean config's raft_ivf_pq entry
PQ_BUILD = dict(n_lists=1024, pq_dim=64, pq_bits=8)
PQ_PROBES = (32, 128)
PQ_REFINE_RATIO = 2.0
# the floor on recall@10 with refine_ratio 2.0 at n_probes 128, batch
# 500, written in PERF.md before the first card run of this phase
PQ_REFINED_RECALL_FLOOR = 0.80
PQ_SERVE_REQUESTS = 60
PQ_RAGGED_REQUESTS = 120
PQ_LUTS = ("float32", "bfloat16", "float8_e4m3fn", "float8_e5m2")
# the rows of the CAGRA build with the IVF-PQ graph source: a cut of the
# 1M rows that keeps the run inside its time limit (PERF.md, cells)
CAGRA_PQ_ROWS = 200_000


def pq_scan_case(torch, seed: int, ip_metric: bool, per_cluster: bool,
                 bits: int, k: int, pq_dim: int = 0, L: int = 0,
                 m: int = 300, q: int = 40, hot=None):
    """Random inputs of ivf_pq_scan (the card test's grid): 9 lists of
    ``m`` slots (ids -1 in the last 50 and every 37th), ``q`` queries x 5
    probe slots drawn with repeats (each repeat made the sentinel) and
    ragged sentinel tails (with ``hot``, every first slot probes that
    list), pq_dim 6, 16 or 64 (an odd count of bytes, packed and unpacked
    rows) unless given, subspaces 2 or 3 wide, no, a shared or a
    per-query filter."""
    from raft_tpu_torch.neighbors.ivf_pq import _pack_nibbles
    from raft_tpu_torch.ops.ivf_pq_scan import codebook_norms, dedup_slots

    rng = np.random.default_rng(seed)
    n_lists, p = 9, 5
    pq_dim = pq_dim or (6, 16, 64)[seed % 3]
    L, book = L or 2 + seed % 2, 1 << bits
    cb = torch.from_numpy(rng.standard_normal(
        (n_lists if per_cluster else pq_dim, book, L)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, book, (n_lists, m, pq_dim)
                                          ).astype(np.uint8))
    packed = bits == 4 and pq_dim % 2 == 0
    if packed:
        codes = _pack_nibbles(codes)
    ids = rng.permutation(n_lists * m).reshape(n_lists, m).astype(np.int32)
    ids[:, m - 50:] = -1
    ids[:, ::37] = -1
    probes = rng.integers(0, n_lists, (q, p)).astype(np.int32)
    if hot is not None:
        probes[:, 0] = hot
    probes[::3, 3:] = n_lists
    probes = dedup_slots(torch.from_numpy(probes), n_lists)
    qres = rng.standard_normal((q, pq_dim * L) if ip_metric
                               else (q, p, pq_dim * L)).astype(np.float32)
    n_words = -(-n_lists * m // 32)
    fw = [None, rng.integers(-2**31, 2**31, n_words),
          rng.integers(-2**31, 2**31, (q, n_words))][seed % 3]

    def put(a):
        return None if a is None else torch.as_tensor(a).cuda()

    return dict(
        qres=put(qres),
        base=put(rng.standard_normal((q, p)).astype(np.float32))
        if ip_metric else None,
        codebooks=put(cb), cb_norms=None if ip_metric else put(
            codebook_norms(cb)),
        codes=put(codes), indices=put(ids), probes=put(probes),
        filter_words=None if fw is None else put(fw.astype(np.int32))
    ), packed


def pq_equal(torch, name: str, got, want) -> None:
    """The PQ kernel against its plain version: ids and distances equal
    bit for bit."""
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        bad = int((got[1] != want[1]).sum())
        fail(f"{name}: ivf_pq_scan differs from its plain version ({bad} "
             "ids)")


# tables past shared memory, which the kernel builds in parts: (pq_dim,
# subspace width, k) of gist-960's auto pq_dim 240 and mnist-784's 196
PQ_LARGE_TABLES = ((240, 4, 10), (240, 4, 258), (196, 4, 258))
# the list-major kernel's work items: a list probed by more pairs than an
# item holds, lists longer than two chunks of rows, a batch of one
PQ_ITEM_SHAPES = (dict(q=70, hot=3), dict(m=1300), dict(q=1))


def kernels_pq(torch, seed: int) -> int:
    """ivf_pq_scan against its plain version over metric x codebook kind x
    pq_bits x lut_dtype x k {10, 258}, three input draws each, and the
    large tables (8-bit, float32 and float8_e5m2)."""
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan

    n = 0
    for pq_dim, L, k in PQ_LARGE_TABLES:
        for ip_metric in (False, True):
            for lut in ("float32", "float8_e5m2"):
                args, packed = pq_scan_case(torch, seed + pq_dim + k,
                                            ip_metric, False, 8, k, pq_dim, L)
                kw = dict(k=k, ip_metric=ip_metric, per_cluster=False,
                          lut_dtype=getattr(torch, lut), packed=packed)
                pq_equal(torch, f"pq large table pq_dim={pq_dim} len={L} "
                         f"k={k} ip={ip_metric} {lut}",
                         ivf_pq_scan(**args, **kw, engine="cuda"),
                         ivf_pq_scan(**args, **kw, engine="torch"))
                n += 1
    for ip_metric in (False, True):
        for per_cluster in (False, True):
            for bits in (4, 8):
                for lut in PQ_LUTS:
                    for k in (10, 258):
                        for draw in range(3):
                            args, packed = pq_scan_case(
                                torch, seed + draw + 7 * k, ip_metric,
                                per_cluster, bits, k)
                            kw = dict(k=k, ip_metric=ip_metric,
                                      per_cluster=per_cluster,
                                      lut_dtype=getattr(torch, lut),
                                      packed=packed)
                            pq_equal(torch, f"pq case ip={ip_metric} "
                                     f"per_cluster={per_cluster} bits={bits} "
                                     f"{lut} k={k} draw {draw}",
                                     ivf_pq_scan(**args, **kw, engine="cuda"),
                                     ivf_pq_scan(**args, **kw,
                                                 engine="torch"))
                            n += 1
    for si, shape in enumerate(PQ_ITEM_SHAPES):
        for lut in PQ_LUTS:
            for k in (10, 258):
                for ip_metric in (False, True):
                    # 4-bit per-cluster codes for L2, 8-bit per-subspace
                    # for IP; the seed picks no, a shared or a per-query
                    # filter
                    args, packed = pq_scan_case(
                        torch, seed + 31 * si + k + ip_metric, ip_metric,
                        not ip_metric, 8 if ip_metric else 4, k, **shape)
                    kw = dict(k=k, ip_metric=ip_metric,
                              per_cluster=not ip_metric,
                              lut_dtype=getattr(torch, lut), packed=packed)
                    pq_equal(torch, f"pq item case {shape} ip={ip_metric} "
                             f"{lut} k={k}",
                             ivf_pq_scan(**args, **kw, engine="cuda"),
                             ivf_pq_scan(**args, **kw, engine="torch"))
                    n += 1
    return n


# the dual-source PQ fetch's splits of pq_scan_case's nine lists
PQ_TIER_SPLITS = {"hot-only": (range(9), ()), "half-cold": ((0, 2, 4, 6, 8),
                                                           (1, 3, 5, 7)),
                  "all-cold": ((), range(9))}


def kernels_pq_tiered(torch, seed: int) -> None:
    """The dual-source ivf_pq_scan (a tiered index's cold code lists
    staged from pinned host memory into a device ring) against the
    all-device kernel on the whole plane and its plain version on the
    split planes, bit for bit: hot-only, half-cold and all-cold splits x
    the four LUT types x L2/IP, with the default ring and a ring of two
    lists (waves taking turns in its halves); pq_dim 240 (the per-pair
    instance) likewise; then a pageable cold plane, refused before any
    launch."""
    from raft_tpu_torch.core.validation import RaftError
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    n = waves = 0
    cases = [(split, lut, ip, {}) for split in PQ_TIER_SPLITS
             for lut in PQ_LUTS for ip in (False, True)]
    cases += [(split, lut, ip, dict(pq_dim=240, L=4, m=200))
              for split in ("half-cold", "all-cold")
              for lut in ("float32", "float8_e5m2") for ip in (False, True)]
    for i, (split, lut, ip, shape) in enumerate(cases):
        args, packed = pq_scan_case(torch, seed + 101 + i, ip, i % 2 == 1,
                                    4 if i % 4 == 1 else 8, 10, **shape)
        kw = dict(k=10, ip_metric=ip, per_cluster=i % 2 == 1,
                  lut_dtype=getattr(torch, lut), packed=packed)
        want = ops.ivf_pq_scan(**args, **kw, engine="cuda")
        hot, cold, hmap, cmap = _split_tiers(
            torch, args["codes"], np.asarray(PQ_TIER_SPLITS[split][0],
                                             np.int64),
            np.asarray(PQ_TIER_SPLITS[split][1], np.int64))
        tiers = dict(args, codes=hot, cold_codes=cold, hot_slot_map=hmap,
                     cold_slot_map=cmap)
        name = f"dual-source pq {split} {lut} ip={ip} {shape or ''}"
        pq_equal(torch, name + " plain", ops.ivf_pq_scan(
            **tiers, **kw, engine="torch"), want)
        m, row_bytes = args["codes"].shape[1:]
        for ring in (None, 2 * m * row_bytes):
            pq_equal(torch, f"{name} ring={ring}", ops.ivf_pq_scan(
                **tiers, **kw, engine="cuda", workspace_bytes=ring), want)
            waves = max(waves, ops._launch_tiered.last_plan.n_waves)
            n += 1
    args, packed = pq_scan_case(torch, seed, False, False, 8, 10)
    hot, cold, hmap, cmap = _split_tiers(torch, args["codes"],
                                         np.arange(0, 9, 2),
                                         np.arange(1, 9, 2))
    before = ops.ivf_pq_scan.launches
    for bad in (cold.clone(), cold.cuda()):
        try:
            ops.ivf_pq_scan(**dict(args, codes=hot, cold_codes=bad,
                                   hot_slot_map=hmap, cold_slot_map=cmap),
                            k=10, ip_metric=False, per_cluster=False,
                            lut_dtype=torch.float32, packed=packed,
                            engine="cuda")
        except RaftError:
            continue
        fail("ivf_pq_scan took a cold plane that is not pinned host memory")
    if ops.ivf_pq_scan.launches != before:
        fail("a refused cold plane launched the PQ kernel")
    log(f"[kernels] ivf_pq_scan dual-source: {n} cases (splits "
        f"{list(PQ_TIER_SPLITS)}, the four LUTs, L2/IP, pq_dim 240 in "
        f"parts; default rings and rings of two lists, up to {waves} "
        "waves) equal the all-device kernel and the plain version bit for "
        "bit; pageable and device cold planes refused")


def pq_body(index, queries, n_probes: int, engine: str, k: int = K):
    """One request through the IVF-PQ serving body with ``engine``."""
    from raft_tpu_torch.neighbors import ivf_pq

    fn, arrays, static = ivf_pq.serving_plan(ivf_pq.IvfPqSearchParams(
        n_probes=n_probes, scan_engine=engine), index, k)
    return fn(queries, *arrays, None, **static)


def pq_data(torch, seed: int, state: dict) -> None:
    """Main's data and brute-force truth, for a run of the pq phase
    without main (``--phases env,build,pq``)."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force

    res = Resources(device="cuda", seed=seed)
    x, queries = make_data(torch, seed)
    bf = brute_force.build(res, x)
    gt_i = torch.cat([brute_force.search(res, bf, queries[s:s + 500], K)[1]
                      for s in range(0, N_QUERIES, 500)])
    state.update(res=res, x=x, queries=queries, gt_i=gt_i, seed=seed,
                 launches={})


def phase_pq(torch, state: dict) -> None:
    """The IVF-PQ path on main's data (the module docstring, phase 7)."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq, refine

    res, x, queries, gt_i = (state["res"], state["x"], state["queries"],
                             state["gt_i"])
    t0 = time.perf_counter()
    n_cases = kernels_pq(torch, state["seed"])
    log(f"[pq] ivf_pq_scan equals its plain version bit for bit on "
        f"{n_cases} small cases (metric x codebook kind x pq_bits x "
        f"lut_dtype x k {{10, 258}}, filters, sentinel probe slots; "
        f"tables past shared memory {PQ_LARGE_TABLES}; work items "
        f"{PQ_ITEM_SHAPES}) in {time.perf_counter() - t0:.1f} s")

    params = ivf_pq.IvfPqIndexParams(**PQ_BUILD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fields = ("centers", "rotation", "codebooks", "codes", "indices",
              "list_sizes")
    nbytes = sum(getattr(index, f).numel() * getattr(index, f).element_size()
                 for f in fields)
    again = ivf_pq.build(Resources(device="cuda", seed=state["seed"]),
                         params, x)
    same = all(torch.equal(getattr(index, f), getattr(again, f))
               for f in fields)
    del again
    if not same:
        fail("two same-seed IVF-PQ builds differ")
    sizes = index.list_sizes.to(torch.float32)
    log(f"[pq] ivf_pq.build {PQ_BUILD}: {build_s:.2f} s, index "
        f"{nbytes} bytes (codes {index.codes.numel()}), max_list_size "
        f"{index.max_list_size}, list sizes min {int(sizes.min())} median "
        f"{int(sizes.median())} max {int(sizes.max())}; a second same-seed "
        "build is torch.equal")

    # the kernel against its plain version on full-size requests
    t0 = time.perf_counter()
    for n_probes in PQ_PROBES:
        for batch in (10, 500):
            q = queries[:batch]
            pq_equal(torch, f"pq request n_probes={n_probes} batch={batch}",
                     pq_body(index, q, n_probes, "cuda"),
                     pq_body(index, q, n_probes, "torch"))
    log(f"[pq] full-size requests (n_probes {PQ_PROBES} x batch 10, 500): "
        "the cuda engine equals the plain engine bit for bit "
        f"({time.perf_counter() - t0:.1f} s with the plain runs)")
    for n_probes, batch in ((32, 10), (128, 500)):
        sp = ivf_pq.IvfPqSearchParams(n_probes=n_probes)
        q = queries[:batch]
        ivf_pq.search(res, sp, index, q, K)
        wall_us, events = profiled(
            torch, lambda: ivf_pq.search(res, sp, index, q, K), 3)
        busy, _, _, ops = device_split(events, 3)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
        log(f"[pq] profile n_probes={n_probes} batch={batch}: wall "
            f"{wall_us:.0f} us a request, device busy {busy:.0f} us, {ops} "
            "device ops; top: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / 3:.0f} us"
                for e in top))

    # the requests, counted
    torch.cuda.synchronize()
    reset_launches()
    pq_recall, pq_answers = {}, {}
    for n_probes in PQ_PROBES:
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            sp = ivf_pq.IvfPqSearchParams(n_probes=n_probes)
            outs, refined, times = [], [], []
            for s in range(0, n_q, batch):
                q = queries[s:s + batch]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                outs.append(ivf_pq.search(res, sp, index, q, K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                _, cand = ivf_pq.search(res, sp, index, q,
                                        int(K * PQ_REFINE_RATIO))
                refined.append(refine.refine(res, x, q, cand, K)[1])
            r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
            rr = recall(torch.cat(refined), gt_i[:n_q])
            ms = float(np.median(times[1:]))
            pq_recall[n_probes, batch] = (r, rr, ms)
            pq_answers[n_probes, batch] = outs
            log(f"[pq] ivf_pq.search n_probes={n_probes} batch={batch}: "
                f"recall@10 {r:.4f}, with refine_ratio {PQ_REFINE_RATIO} "
                f"{rr:.4f} over {n_q} queries; median {ms:.3f} ms per "
                "request")
    launches = read_launches(("ivf_pq_scan",), "IVF-PQ")["ivf_pq_scan"]
    floor_r = pq_recall[128, 500][1]
    if floor_r < PQ_REFINED_RECALL_FLOOR:
        fail(f"IVF-PQ refined recall@10 {floor_r:.4f} at n_probes 128, "
             f"batch 500 is under its floor {PQ_REFINED_RECALL_FLOOR}")
    state.update(pq_index=index, pq_recall=pq_recall)
    tiered_launches = pq_tiered(torch, state, index, pq_answers)
    del pq_answers
    served = pq_serve(torch, state, index)
    served += pq_ragged(torch, state, index)
    cagra_launches = pq_cagra(torch, state)
    state["launches"]["ivf_pq_scan"] = (launches + tiered_launches + served
                                        + cagra_launches["ivf_pq_scan"])
    state["launches"]["beam_search"] = (state["launches"].get(
        "beam_search", 0) + cagra_launches["beam_search"])
    log(f"[pq] ivf_pq_scan launches: requests {launches}, tiered requests "
        f"and epochs {tiered_launches}, served and packed {served}, CAGRA "
        f"graph source {cagra_launches['ivf_pq_scan']}")
    state["pq_record"] = times_pq(torch, state)


def pq_tiered(torch, state: dict, index, answers) -> int:
    """Tiered IVF-PQ on the pq phase's index: build_tiered_pq(hot_fraction
    0.5), the cold codes pinned; the four requests, each equal to its
    all-device answer bit for bit with recall@10, median ms beside the
    all-device ms, the cold code bytes staged and the waves; the staged
    copies' rate from torch.profiler against the host link's 64 GB/s; the
    plain PQ engine never runs and ivf_pq_scan launches once a request.
    Then TierManager epochs on a probe-accounting executor. Returns the
    launches."""
    from unittest import mock

    from raft_tpu_torch.core import memwatch, tracing
    from raft_tpu_torch.neighbors import ivf_pq, tiered
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    res, queries, gt_i = state["res"], state["queries"], state["gt_i"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    t = tiered.build_tiered_pq(index, hot_fraction=0.5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[pq] tiered.build_tiered_pq hot_fraction=0.5: {build_s:.3f} s, "
        f"{t.n_hot} hot lists ({t.hot_bytes} code bytes on the card), "
        f"{t.n_cold} cold ({t.cold_bytes} bytes, pinned: "
        f"{t.cold_codes.is_pinned()}), block {t.block_bytes} bytes")
    if not (t.host_resident and t.cold_codes.is_pinned()
            and memwatch.memory_tier(t.cold_codes) == "host"):
        fail("the tiered PQ cold codes are not in pinned host memory")
    plain_runs = []
    rows = {}
    with mock.patch.object(ops, "_scan_torch",
                           side_effect=lambda *a, **k: plain_runs.append(1)):
        for n_probes in PQ_PROBES:
            sp = ivf_pq.IvfPqSearchParams(n_probes=n_probes)
            for batch, n_q in ((10, 1000), (500, N_QUERIES)):
                outs, times, staged, waves = [], [], [], []
                for j, s0 in enumerate(range(0, n_q, batch)):
                    c0 = tracing.counters("tier.")
                    t1 = time.perf_counter()
                    out = tiered.search_pq(res, sp, t,
                                           queries[s0:s0 + batch], K)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                    c1 = tracing.counters("tier.")
                    staged.append(c1.get("tier.cold_bytes_staged", 0)
                                  - c0.get("tier.cold_bytes_staged", 0))
                    waves.append(c1.get("tier.stage_waves", 0)
                                 - c0.get("tier.stage_waves", 0))
                    ref = answers[n_probes, batch][j]
                    if not (torch.equal(out[0], ref[0])
                            and torch.equal(out[1], ref[1])):
                        fail(f"tiered PQ n_probes={n_probes} batch={batch} "
                             f"request {j} differs from the all-device "
                             "search")
                    outs.append(out)
                r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
                ms = float(np.median(times[1:]))
                rows[n_probes, batch] = dict(
                    recall=r, ms=ms, device_ms=state["pq_recall"][
                        n_probes, batch][2],
                    staged_bytes=float(np.mean(staged)),
                    waves=float(np.mean(waves)))
                log(f"[pq] tiered.search_pq n_probes={n_probes} "
                    f"batch={batch}: recall@10 {r:.4f} over {n_q} queries, "
                    f"median {ms:.3f} ms per request (all-device "
                    f"{rows[n_probes, batch]['device_ms']:.3f} ms), cold "
                    f"code bytes staged per request mean "
                    f"{np.mean(staged):.0f} (min {min(staged):.0f}, max "
                    f"{max(staged):.0f}) in {min(waves):.0f}-"
                    f"{max(waves):.0f} waves; ids and distances equal the "
                    "all-device search")
    if plain_runs:
        fail(f"the plain PQ engine ran {len(plain_runs)} times on the "
             "tiered path")
    launches = read_launches(("ivf_pq_scan",), "tiered IVF-PQ")[
        "ivf_pq_scan"]
    n_req = 2 * (1000 // 10 + N_QUERIES // 500)
    if launches != n_req:
        fail(f"ivf_pq_scan launched {launches} times for {n_req} tiered "
             "requests")
    rows["stage_gbps"] = pq_stage_rate(torch, state, t,
                                       answers[128, 500][:3])
    state["pq_tiered"] = rows
    state["pq_tiered_index"] = t
    state["pq_epochs"] = tier_manager_run(
        torch, state, "tiered IVF-PQ", lambda: tiered.build_tiered_pq(
            index, hot_fraction=0.5),
        lambda q, p: ivf_pq.search(res, ivf_pq.IvfPqSearchParams(
            n_probes=p), index, q, K),
        lambda t_, q, p: tiered.search_pq(res, ivf_pq.IvfPqSearchParams(
            n_probes=p), t_, q, K),
        ivf_pq.IvfPqSearchParams, index)
    epochs = read_launches(("ivf_pq_scan",), "tiered IVF-PQ epochs")
    return launches + epochs["ivf_pq_scan"]


def pq_stage_rate(torch, state: dict, t, want):
    """The dual-source PQ kernel's staged copies at (128, 500), from the
    device's own timeline: torch.profiler over three requests (still equal
    to the all-device answers); the bytes staged over the summed device
    time of their host -> device copies, against the link's 64 GB/s."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import ivf_pq, tiered

    sp = ivf_pq.IvfPqSearchParams(n_probes=128)
    c0 = tracing.get_counter("tier.cold_bytes_staged")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [tiered.search_pq(state["res"], sp, t,
                                 state["queries"][s:s + 500], K)
                for s in range(0, 1500, 500)]
        torch.cuda.synchronize()
    nbytes = tracing.get_counter("tier.cold_bytes_staged") - c0
    for j, out in enumerate(outs):
        if not (torch.equal(out[0], want[j][0])
                and torch.equal(out[1], want[j][1])):
            fail(f"profiled tiered PQ request {j} differs from the "
                 "all-device search")
    copies = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key.startswith("Memcpy HtoD")]
    us = sum(e.self_device_time_total for e in copies)
    if not us:
        log("[pq] the staged copies' rate: not measured (the profiler "
            "shows no host -> device copy on the device)")
        return None
    gbps = nbytes / us / 1e3
    log(f"[pq] the staged code copies of three (128, 500) tiered requests "
        f"(torch.profiler): {nbytes:.0f} bytes in "
        f"{sum(e.count for e in copies)} host -> device copies, busy "
        f"{us / 1e3:.3f} ms = {gbps:.2f} GB/s, "
        f"{100 * gbps * 1e9 / HOST_LINK_BYTES_PER_S:.1f}% of the host "
        f"link's {HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s")
    return gbps


#: TierManager runs: epochs, the cold lists each epoch's traffic targets
#: (queries at their centers, one probe each, so the window holds them
#: alone), queries per target, and the swap width
TM_EPOCHS, TM_TARGETS, TM_PER_TARGET = 3, 8, 64


def tier_manager_run(torch, state: dict, label: str, build, direct, search,
                     params_type, index) -> dict:
    """TierManager epochs on a probe-accounting executor over a fresh
    tiered copy (``build()``), twice from the same placement with the
    same traffic: reactive, then with a TierPrefetcher. Each epoch's
    traffic (queries at the centers of TM_TARGETS cold lists, n_probes 1,
    through the executor) equals the all-device answers (``direct``);
    the plan must equal plan_epoch on the same window and promote the
    targets; after each epoch a batch of real queries (n_probes 32,
    ``search``) still equals the all-device answer. Pacing on a
    ManualClock: the prefetch run's lead tick stages the forecast, its
    epoch tick takes the hits. Prints the epoch ms, hits and
    tier.promote_cold_bytes of both runs."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.core.executor import SearchExecutor
    from raft_tpu_torch.serving.harness import ManualClock
    from raft_tpu_torch.serving.placement import (
        PlacementConfig,
        TierManager,
        plan_epoch,
    )

    res, queries = state["res"], state["queries"]
    dev = index.centers.device
    g = torch.Generator(device=dev)
    g.manual_seed(state["seed"] + 17)
    t = build()
    cold0 = np.array(t.cold_lists)
    traffic, answers = [], []
    for e in range(TM_EPOCHS):
        targets = cold0[e * TM_TARGETS:(e + 1) * TM_TARGETS]
        c = index.centers[torch.from_numpy(targets).to(dev)]
        q = (c.repeat_interleave(TM_PER_TARGET, dim=0) + 0.01 * torch.randn(
            len(targets) * TM_PER_TARGET, c.shape[1], generator=g,
            device=dev))
        traffic.append((targets, q))
        answers.append(direct(q, 1))
    check_q = queries[:500]
    check_want = direct(check_q, 32)
    del t
    torch.cuda.synchronize()
    # the all-device answers above are not the tiered path's launches
    reset_launches()
    out = {}
    for run in ("reactive", "prefetch"):
        t = build()
        ex = SearchExecutor(res, probe_accounting=True)
        clock = ManualClock()
        mgr = TierManager(t, ex, config=PlacementConfig(
            epoch_every_s=60.0, max_swaps_per_epoch=TM_TARGETS,
            prefetch_lead_s=10.0), clock=clock)
        pf = mgr.enable_prefetch() if run == "prefetch" else None
        c0 = tracing.counters("tier.")
        mgr.tick()
        epoch_ms = []
        for e, (targets, q) in enumerate(traffic):
            hot, cold = t.hot_lists.copy(), t.cold_lists.copy()
            got = ex.search(t, q, K, params=params_type(n_probes=1))
            if not (torch.equal(got[0], answers[e][0])
                    and torch.equal(got[1], answers[e][1])):
                fail(f"{label} {run} epoch {e}: served traffic differs from "
                     "the all-device search")
            window = np.zeros(t.n_lists, np.int64)
            np.add.at(window, np.repeat(targets, TM_PER_TARGET), 1)
            clock.advance(51.0)
            mgr.tick()                      # the lead tick (prefetch run)
            clock.advance(9.0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plan = mgr.tick()
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t1) * 1e3)
            want = plan_epoch(window, hot, cold, max_swaps=TM_TARGETS)
            if plan is None or plan != want:
                fail(f"{label} {run} epoch {e}: plan {plan} is not "
                     f"plan_epoch's {want} on the same window")
            if sorted(plan.promotions) != sorted(int(x) for x in targets):
                fail(f"{label} {run} epoch {e}: promoted {plan.promotions}, "
                     f"not the traffic's {list(targets)}")
            got = search(t, check_q, 32)
            if not (torch.equal(got[0], check_want[0])
                    and torch.equal(got[1], check_want[1])):
                fail(f"{label} {run} after epoch {e}: the search differs "
                     "from the all-device search")
        c1 = tracing.counters("tier.")
        delta = {n: c1.get(n, 0.0) - c0.get(n, 0.0) for n in (
            "tier.promote_cold_bytes", "tier.swap_bytes",
            "tier.prefetch.hits", "tier.prefetch.misses",
            "tier.prefetch.issued")}
        out[run] = dict(epoch_ms=epoch_ms, **delta)
        log(f"[tier] {label} TierManager {run}: {TM_EPOCHS} epochs of "
            f"{TM_TARGETS} promotions (each plan equals plan_epoch on the "
            f"window and promotes the traffic's cold lists; served traffic "
            f"and a 500-query check bit-identical after every epoch), "
            f"epoch ms {[round(x, 3) for x in epoch_ms]}, "
            f"tier.promote_cold_bytes {delta['tier.promote_cold_bytes']:.0f}"
            f", tier.swap_bytes {delta['tier.swap_bytes']:.0f}, prefetch "
            f"issued {delta['tier.prefetch.issued']:.0f} hits "
            f"{delta['tier.prefetch.hits']:.0f} misses "
            f"{delta['tier.prefetch.misses']:.0f}; generation "
            f"{t.generation}" + (f", staged rows {pf.capacity}"
                                 if pf is not None else ""))
        del t, ex, mgr, pf
    if out["prefetch"]["tier.prefetch.hits"] <= 0:
        fail(f"{label}: the prefetcher had no hit")
    if not (out["prefetch"]["tier.promote_cold_bytes"]
            < out["reactive"]["tier.promote_cold_bytes"]):
        fail(f"{label}: prefetch did not lower tier.promote_cold_bytes")
    return out


def pq_serve(torch, state: dict, index) -> int:
    """Captured IVF-PQ plans on the ladder 8..512 at n_probes 32 and 128:
    each served request equal to its direct search, no capture after
    warmup, launches as the replays record. Returns the launches."""
    import collections

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.neighbors import ivf_pq

    res, queries = state["res"], state["queries"]
    sizes = _request_sizes(state["seed"] + 10, PQ_SERVE_REQUESTS)
    total = 0
    for n_probes in PQ_PROBES:
        sp = ivf_pq.IvfPqSearchParams(n_probes=n_probes)
        label = f"ivf_pq n_probes={n_probes}"
        ex = SearchExecutor(res)
        t0 = time.perf_counter()
        ex.warmup(index, buckets=SERVE_LADDER, k=K, params=sp)
        warm_s = time.perf_counter() - t0
        built = ex.stats.compile_count
        costs = list(ex.executable_costs().values())
        if built != len(SERVE_LADDER) or not all(c["captured"]
                                                 for c in costs):
            fail(f"serve {label}: warmup captured {built} plans")
        want = [ivf_pq.search(res, sp, index, queries[at:at + m], K)
                for m, at in sizes]
        per_replay = {e.bucket: e.launches for e in ex._cache.values()}
        expected = collections.Counter()
        for m, _ in sizes:
            expected.update(per_replay[ex.bucket_for(m)])
        torch.cuda.synchronize()
        reset_launches()
        got = [ex.search(index, queries[at:at + m], K, params=sp)
               for m, at in sizes]
        torch.cuda.synchronize()
        counts = _launch_counts()
        if counts != dict(expected) or "ivf_pq_scan" not in counts:
            fail(f"serve {label}: requests launched {counts}, their "
                 f"replays record {dict(expected)}")
        for g, w in zip(got, want):
            _served_equal(torch, label, g, w)
        if ex.stats.compile_count != built:
            fail(f"serve {label}: captures after warmup")
        total += counts.get("ivf_pq_scan", 0)
        pools = sum(c["pool_bytes"] for c in costs)
        state.setdefault("pq_pools", {})[label] = pools
        (e16,) = [e for e in ex._cache.values() if e.bucket == 16]
        replay_ms = median_ms(e16.graph.replay, 20)
        log(f"[pq] serve {label}: warmup captured {built} plans in "
            f"{warm_s:.2f} s, graph pools {pools} bytes "
            f"{[c['pool_bytes'] for c in costs]}; {len(sizes)} requests of "
            f"1-500 rows each bit-identical to ivf_pq.search, launches "
            f"{counts} as the replays record, no capture after warmup; "
            f"the batch-10 plan's replay {replay_ms:.3f} ms")
        del ex
    torch.cuda.empty_cache()
    return total


def pq_ragged(torch, state: dict, index) -> int:
    """A ragged IVF-PQ params class (n_probes {72, 96, 128}, k {10, 16})
    on 256-row tiles: each packed row equal to its solo bucketed search,
    no capture after warmup. Returns the launches."""
    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.neighbors import ivf_pq

    res, queries = state["res"], state["queries"]
    mix = [(ivf_pq.IvfPqSearchParams(n_probes=n), k)
           for n in (72, 96, 128) for k in RAGGED_KS]
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE)
    ex.warmup_ragged(index, k=mix[0][1], params=mix[0][0])
    if ex.stats.compile_count != 1 or ex.ragged_executables("ivf_pq") != 1:
        fail(f"ragged ivf_pq: warmup built {ex.stats.compile_count} entries")
    keys = {ex.ragged_key(index, k, params=p) for p, k in mix}
    if len(keys) != 1 or None in keys:
        fail(f"ragged ivf_pq: the mix spans {len(keys)} packing keys")
    rng = np.random.default_rng(state["seed"] + 11)
    reqs = [_ragged_draw(mix)(rng) for _ in range(PQ_RAGGED_REQUESTS)]
    solo = SearchExecutor(res, capture=False)
    want = [solo.search(index, queries[at:at + m], mix[j][1],
                        params=mix[j][0]) for m, at, j in reqs]
    del solo
    groups, cur, rows = [], [], 0
    for r in reqs:
        if rows + r[0] > RAGGED_TILE:
            groups.append(cur)
            cur, rows = [], 0
        cur.append(r)
        rows += r[0]
    groups.append(cur)
    (entry,) = [e for e in ex._cache.values()]
    torch.cuda.synchronize()
    reset_launches()
    got = []
    for g in groups:
        got += ex.search_ragged(
            index, [queries[at:at + m] for m, at, _ in g],
            [mix[j][1] for _, _, j in g],
            params_list=[mix[j][0] for _, _, j in g])
    torch.cuda.synchronize()
    counts = _launch_counts()
    expected = {n: c * len(groups) for n, c in entry.launches.items()}
    if counts != expected or "ivf_pq_scan" not in counts:
        fail(f"ragged ivf_pq: {len(groups)} packed calls launched {counts}, "
             f"their replays record {expected}")
    bad = sum(int((g[1] != w[1]).any(dim=1).sum())
              + int((g[0] != w[0]).any(dim=1).sum())
              for g, w in zip(got, want))
    if bad:
        fail(f"ragged ivf_pq: {bad} packed rows differ from their solo "
             "search")
    if ex.stats.compile_count != 1:
        fail("ragged ivf_pq: captures after warmup")
    (cost,) = ex.executable_costs().values()
    tile_ms = median_ms(entry.graph.replay, 20)
    log(f"[pq] ragged ivf_pq (n_probes {{72, 96, 128}} x k {RAGGED_KS}): "
        f"{len(reqs)} requests ({sum(m for m, _, _ in reqs)} rows) packed "
        f"into {len(groups)} {RAGGED_TILE}-row tiles, every packed row "
        f"bit-identical to its solo bucketed search; launches {counts} as "
        f"the replays record; no capture after warmup; graph pool "
        f"{cost['pool_bytes']} bytes; tile replay {tile_ms:.3f} ms")
    state["pq_ragged_pool"] = cost["pool_bytes"]
    return counts.get("ivf_pq_scan", 0)


def pq_cagra(torch, state: dict) -> dict:
    """CAGRA with the IVF-PQ graph source (the sift raft_cagra entry:
    graph_degree 64, intermediate 128) on the first CAGRA_PQ_ROWS rows:
    build s and the PQ kernel's launches during it; recall@10 at itopk 64
    and 128, batch 500, on the beam kernel."""
    from raft_tpu_torch.neighbors import brute_force, cagra

    res, queries = state["res"], state["queries"]
    sub = state["x"][:CAGRA_PQ_ROWS]
    q = queries[:1000]
    bf = brute_force.build(res, sub)
    truth = torch.cat([brute_force.search(res, bf, q[s:s + 500], K)[1]
                       for s in (0, 500)])
    del bf
    params = cagra.CagraIndexParams(graph_degree=64,
                                    intermediate_graph_degree=128)
    if params.build_algo != cagra.BuildAlgo.IVF_PQ:
        fail("CagraIndexParams() does not default to the IVF-PQ source")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    index = cagra.build(res, params, sub)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = _launch_counts()
    if not build_counts.get("ivf_pq_scan"):
        fail(f"the CAGRA IVF-PQ build launched {build_counts}")
    out = {"ivf_pq_scan": build_counts.get("ivf_pq_scan", 0),
           "beam_search": 0}
    rec = {}
    for itopk in (64, 128):
        sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=4)
        reset_launches()
        ids = torch.cat([cagra.search(res, sp, index, q[s:s + 500], K)[1]
                         for s in (0, 500)])
        torch.cuda.synchronize()
        n = _launch_counts().get("beam_search", 0)
        if not n:
            fail("the CAGRA search on the IVF-PQ graph skipped the beam "
                 "kernel")
        out["beam_search"] += n
        rec[itopk] = recall(ids, truth)
    state["pq_cagra"] = dict(build_s=build_s, recall=rec,
                             launches=build_counts)
    log(f"[pq] cagra.build (IVF-PQ graph source, graph_degree 64, "
        f"intermediate 128) on {CAGRA_PQ_ROWS} rows: {build_s:.2f} s, "
        f"launches {build_counts}; recall@10 at batch 500 itopk 64 "
        f"{rec[64]:.4f}, itopk 128 {rec[128]:.4f} (beam kernel)")
    return out


def times_pq(torch, state: dict) -> dict:
    """ivf_pq_scan at the batch-500, n_probes=128 request (and batch 10,
    n_probes 32): CUDA events around the wrapper, the plain version, and
    the bound from this request's probed rows."""
    from raft_tpu_torch.neighbors.ivf_bq import _coarse
    from raft_tpu_torch.ops.ivf_pq_scan import codebook_norms, ivf_pq_scan

    index = state["pq_index"]
    saved = {name: fn.launches for name, fn in _counted().items()}

    def args_for(batch, n_probes):
        qf = state["queries"][:batch]
        probes, _, _ = _coarse(index.centers, index.metric, qf, n_probes,
                               "exact")
        lists = probes.to(torch.int64)
        qres = (qf[:, None, :] - index.centers[lists]) @ index.rotation.T
        args = (qres, None, index.codebooks, codebook_norms(index.codebooks),
                index.codes, index.indices, probes, None)
        kw = dict(k=K, ip_metric=False, per_cluster=False,
                  lut_dtype=torch.float32, packed=index.packed)
        return args, kw, probes

    out = {}
    for batch, n_probes in ((500, 128), (10, 32)):
        args, kw, probes = args_for(batch, n_probes)
        got = ivf_pq_scan(*args, **kw, engine="cuda")
        want = ivf_pq_scan(*args, **kw, engine="torch")
        pq_equal(torch, f"times pq batch={batch}", got, want)
        fin = torch.isfinite(want[0])
        err = float((got[0][fin] - want[0][fin]).abs().max()) if bool(
            fin.any()) else 0.0
        ms = median_ms(lambda: ivf_pq_scan(*args, **kw, engine="cuda"), 20)
        plain_ms = median_ms(lambda: ivf_pq_scan(*args, **kw,
                                                 engine="torch"), 3, 1)
        out[batch] = (ms, plain_ms, err, probes)
    ms, plain_ms, err, probes = out[500]
    q, p = probes.shape
    sizes = index.list_sizes.to(torch.int64)
    pr = probes.to(torch.int64)
    live = pr < index.n_lists
    probed_rows = int(sizes[pr.clamp(max=index.n_lists - 1)][live].sum())
    uniq = torch.unique(pr[live])
    union_rows = int(sizes[uniq].sum())
    pq_dim, book, L = index.pq_dim, index.pq_book_size, index.pq_len
    row_bytes = index.codes.shape[2]
    # inputs read once: the union's code rows and ids, the residuals,
    # codebooks and their norms, the probes; outputs written once
    nbytes = (union_rows * (row_bytes + 4) + 4 * q * p * pq_dim * L
              + 4 * pq_dim * book * (L + 1) + 4 * q * p + 8 * q * K)
    lookups = float(probed_rows * pq_dim)
    lut_flops = float(q * p * pq_dim * book * (2 * L + 2))
    log(f"[times] ivf_pq_scan work at q=500 n_probes=128: {probed_rows} "
        f"probed rows x pq_dim {pq_dim} = {lookups:.4g} LUT lookups, "
        f"{union_rows} rows in the union of {uniq.numel()} lists; batch 10 "
        f"n_probes 32: {out[10][0]:.4f} ms (plain {out[10][1]:.3f} ms)")
    log(f"[times] ivf_pq_scan list-major: {ms:.4f} ms at (128, 500), "
        f"{out[10][0]:.4f} ms at (32, 10); the one-block-a-pair design took "
        f"{EARLIER_PQ_MS[500]} / {EARLIER_PQ_MS[10]} ms (NVIDIA H100 80GB "
        "HBM3, 700 W)")
    rec = _record("ivf_pq_scan", "raft_tpu_torch/csrc/ivf_pq_scan.cu",
                  "none (port kernel; JAX raft_tpu/neighbors/ivf_pq.py:876 "
                  "is XLA)", state["launches"]["ivf_pq_scan"], err, ms,
                  plain_ms, nbytes, {"smem": lookups,
                                     "f32": lookups + lut_flops}, None,
                  ms_b10_p32=out[10][0], plain_ms_b10_p32=out[10][1])
    t = state.get("pq_tiered_index")
    if t is not None:
        # the dual-source fetch at the same request, on the tiered split
        from raft_tpu_torch.ops import ivf_pq_scan as ops

        args, kw, _ = args_for(500, 128)
        hots, colds, hmap, cmap, _ = t.tier_planes()
        targs = args[:4] + (hots[0],) + args[5:] + (colds[0], hmap, cmap)
        pq_equal(torch, "times tiered pq (128, 500)",
                 ivf_pq_scan(*targs, **kw, engine="cuda"),
                 ivf_pq_scan(*args, **kw, engine="cuda"))
        staged = ops._launch_tiered.last_plan.staged_bytes
        t_ms = median_ms(lambda: ivf_pq_scan(*targs, **kw, engine="cuda"),
                         10)
        link_ms = staged / HOST_LINK_BYTES_PER_S * 1e3
        rec.update(tiered_ms=t_ms, tiered_staged_bytes=staged,
                   tiered_bound_ms=max(rec["bound_ms"], link_ms))
        log(f"[times] ivf_pq_scan dual-source at (128, 500), half the "
            f"lists cold: {t_ms:.4f} ms against the all-device {ms:.4f} "
            f"ms; {staged} code bytes staged ({link_ms:.4f} ms at "
            f"{HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s), bound "
            f"{rec['tiered_bound_ms']:.4f} ms")
    for name, fn in _counted().items():
        fn.launches = saved[name]
    return rec


# ---------------------------------------------------------------------------
# distance: the distance family, k-means, the rank engine, ball cover
# ---------------------------------------------------------------------------

#: the real-valued metrics run on the main data; the others on rows made
#: for them (see ``distance_data``)
PROB_METRICS = ("KLDivergence", "JensenShannon", "HellingerExpanded")
BINARY_METRICS = ("JaccardExpanded", "DiceExpanded", "RusselRaoExpanded",
                  "HammingUnexpanded")
#: the metrics that are not a true distance (no self-distance of 0)
NOT_TRUE_DISTANCES = ("InnerProduct", "RusselRaoExpanded")
LP_ARG = 3.0
CHECK_ROWS, CHECK_QUERIES = 50_000, 10
KMEANS_CLUSTERS, KMEANS_ITERS = 1024, 20
BALL_QUERIES, EPS_QUERIES, MASKED_QUERIES = 1000, 100, 1000
GRAM_ROWS, GRAM_COLS = 500, 100_000


def np_distance(metric: str, q, x, p: float = LP_ARG):
    """(q, n) float64 distances of ``metric``: a plain numpy reference of
    the 20 metrics, independent of the port (the reference's
    definitions, with its zero-denominator guards)."""
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    k = q.shape[1]
    ip = q @ x.T
    qn = (q * q).sum(1)[:, None]
    xn = (x * x).sum(1)[None, :]
    if metric in ("L2Expanded", "L2Unexpanded"):
        return np.maximum(qn + xn - 2 * ip, 0)
    if metric in ("L2SqrtExpanded", "L2SqrtUnexpanded"):
        return np.sqrt(np.maximum(qn + xn - 2 * ip, 0))
    if metric == "InnerProduct":
        return ip
    if metric == "CosineExpanded":
        return 1 - ip / np.sqrt(qn * xn)
    if metric == "CorrelationExpanded":
        qc = q - q.mean(1, keepdims=True)
        xc = x - x.mean(1, keepdims=True)
        return 1 - (qc @ xc.T) / np.sqrt(
            (qc * qc).sum(1)[:, None] * (xc * xc).sum(1)[None, :])
    if metric == "HellingerExpanded":
        return np.sqrt(np.maximum(1 - np.sqrt(q) @ np.sqrt(x).T, 0))
    if metric == "RusselRaoExpanded":
        return (k - ip) / k
    if metric == "JaccardExpanded":
        den = qn + xn - ip
        return 1 - np.where(den != 0, ip / np.where(den == 0, 1, den), 0)
    if metric == "DiceExpanded":
        den = qn + xn
        return 1 - np.where(den != 0, 2 * ip / np.where(den == 0, 1, den),
                            0)
    if metric == "Haversine":
        a = (np.sin(0.5 * (q[:, None, 0] - x[None, :, 0])) ** 2
             + np.cos(q[:, None, 0]) * np.cos(x[None, :, 0])
             * np.sin(0.5 * (q[:, None, 1] - x[None, :, 1])) ** 2)
        return 2 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    out = np.empty((q.shape[0], x.shape[0]))
    for i, row in enumerate(q):                       # elementwise family
        a, b = row[None, :], x
        if metric == "L1":
            out[i] = np.abs(a - b).sum(1)
        elif metric == "Linf":
            out[i] = np.abs(a - b).max(1)
        elif metric == "LpUnexpanded":
            out[i] = (np.abs(a - b) ** p).sum(1) ** (1 / p)
        elif metric == "Canberra":
            den = np.abs(a) + np.abs(b)
            out[i] = np.where(den != 0, np.abs(a - b)
                              / np.where(den == 0, 1, den), 0).sum(1)
        elif metric == "BrayCurtis":
            num, den = np.abs(a - b).sum(1), np.abs(a + b).sum(1)
            out[i] = np.where(den != 0, num / np.where(den == 0, 1, den), 0)
        elif metric == "HammingUnexpanded":
            out[i] = (a != b).sum(1) / k
        elif metric in ("KLDivergence", "JensenShannon"):
            with np.errstate(divide="ignore", invalid="ignore"):
                la = np.where(a > 0, np.log(np.where(a > 0, a, 1)), 0)
                lb = np.where(b > 0, np.log(np.where(b > 0, b, 1)), 0)
                if metric == "KLDivergence":
                    out[i] = (np.where(a > 0, a * la, 0) - a * lb).sum(1)
                else:
                    m = 0.5 * (a + b)
                    lm = np.where(m > 0, np.log(np.where(m > 0, m, 1)), 0)
                    out[i] = np.sqrt(0.5 * (np.where(a > 0, a * (la - lm), 0)
                                            + np.where(b > 0, b * (lb - lm),
                                                       0)).sum(1))
        else:
            raise ValueError(metric)
    return out


def distance_data(torch, state: dict) -> dict:
    """The rows each metric runs on, all 1M long: the main data for the
    real-valued metrics, |x| rows normalised to sum 1 for KL,
    JensenShannon and Hellinger, x > 0 as 0/1 for the binary metrics, and
    1M (lat, lon) points in radians (uniform in [-1.4, 1.4] x [-pi, pi))
    for Haversine; with the queries of each kind."""
    x, queries = state["x"], state["queries"]
    g = torch.Generator(device="cuda")
    g.manual_seed(state["seed"] + 7)

    def prob(a):
        a = a.abs()
        return a / a.sum(dim=1, keepdim=True)

    n = N_ROWS + N_QUERIES
    geo = torch.stack([(torch.rand(n, generator=g, device="cuda") * 2 - 1)
                       * 1.4, (torch.rand(n, generator=g, device="cuda")
                               * 2 - 1) * float(np.pi)], 1)
    return {"real": (x, queries), "prob": (prob(x), prob(queries)),
            "binary": ((x > 0).float(), (queries > 0).float()),
            "geo": (geo[:N_ROWS].contiguous(), geo[N_ROWS:].contiguous())}


def _kind(name: str) -> str:
    if name in PROB_METRICS:
        return "prob"
    if name in BINARY_METRICS:
        return "binary"
    return "geo" if name == "Haversine" else "real"


def same_up_to_ties(name: str, got_d, got_i, true_got, true_want, want_i,
                    tol) -> int:
    """Holds a top-k list against the wanted one up to ties: ``true_got``
    and ``true_want`` are the float64 distances of the got and wanted
    ids, position by position. Fails unless every got distance is within
    ``tol`` (per row) of its id's true distance, every position's true
    distances agree within ``tol`` (so a differing id ties the wanted
    one), and no row repeats an id. Returns how many ids differ."""
    import torch

    torch.cuda.synchronize()
    gd, gi = got_d.double().cpu(), got_i.cpu()
    tg, tw = true_got.double().cpu(), true_want.double().cpu()
    wi = want_i.cpu()
    tol = torch.as_tensor(tol).double().cpu().reshape(-1, 1)
    if not torch.equal(gi < 0, wi < 0):
        fail(f"{name}: filled slots differ")
    ok = gi >= 0
    err = (gd - tg).abs()
    if bool((err > tol)[ok].any()):
        fail(f"{name}: a distance is {float(err[ok].max())} off its id's "
             "float64 distance")
    gap = (tg - tw).abs()
    if bool((gap > tol)[ok].any()):
        fail(f"{name}: ids differ away from ties (float64 gap "
             f"{float(gap[ok].max())})")
    srt = torch.sort(torch.where(ok, gi, -1 - torch.arange(
        gi.shape[1]).expand_as(gi)), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail(f"{name}: a row repeats an id")
    return int((gi != wi).sum())


def _rows_f64(fn, q, rows, ids):
    """float64 distances ``fn(q, rows[ids])`` of each query's ids (the
    -1 slots read row 0 and are ignored by :func:`same_up_to_ties`)."""
    return fn(q.double()[:, None, :],
              rows[ids.clamp(min=0).long()].double())


def _l2_f64(a, b):
    return ((a - b) ** 2).sum(-1)


def _haversine_f64(a, b):
    h = ((0.5 * (a[..., 0] - b[..., 0])).sin() ** 2
         + a[..., 0].cos() * b[..., 0].cos()
         * (0.5 * (a[..., 1] - b[..., 1])).sin() ** 2)
    return 2 * h.clamp(0, 1).sqrt().arcsin()


def distance_brute_force(torch, state: dict, data: dict) -> dict:
    """All 20 metrics through brute_force.search over 1M rows: batch 10
    (10 dataset rows as queries, median of 3) and batch 500 (one call);
    each true distance finds the query row at rank 0; 10 queries against
    the first 50,000 rows equal a float64 numpy brute force up to ties."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import brute_force

    res = state["dres"]
    self_rows = (torch.arange(CHECK_QUERIES, device="cuda")
                 * (N_ROWS // CHECK_QUERIES) + 13)
    out = {}
    for metric in DistanceType:
        if metric == DistanceType.Precomputed:
            continue
        name = metric.name
        x, qs = data[_kind(name)]
        index = brute_force.build(res, x, metric, LP_ARG)
        q10 = x[self_rows]
        d10, i10 = brute_force.search(res, index, q10, K)
        ms10 = median_ms(lambda: brute_force.search(res, index, q10, K), 3,
                         warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d500, i500 = brute_force.search(res, index, qs[:500], K)
        torch.cuda.synchronize()
        ms500 = (time.perf_counter() - t0) * 1e3
        if not (torch.isfinite(d500).all() and bool((i500 >= 0).all())):
            fail(f"brute force {name}: non-finite distances or -1 ids")
        if name not in NOT_TRUE_DISTANCES and not torch.equal(
                i10[:, 0], self_rows.to(torch.int32)):
            fail(f"brute force {name}: a dataset row used as a query did "
                 "not find itself at rank 0")
        # against float64 numpy on the first 50,000 rows
        sub = brute_force.build(res, x[:CHECK_ROWS], metric, LP_ARG)
        gd, gi = brute_force.search(res, sub, qs[:CHECK_QUERIES], K)
        want = np_distance(name, qs[:CHECK_QUERIES].cpu().numpy(),
                           x[:CHECK_ROWS].cpu().numpy())
        order = np.argsort(-want if name == "InnerProduct" else want,
                           axis=1, kind="stable")[:, :K]
        wd = np.take_along_axis(want, order, 1)
        tol = 1e-4 * (1.0 + np.abs(wd[:, -1]))
        if name in ("L2Expanded", "InnerProduct", "L2SqrtExpanded"):
            # the product's cancellation: relative to the norms
            norms = ((qs[:CHECK_QUERIES].double() ** 2).sum(1).cpu().numpy()
                     + float((x[:CHECK_ROWS].double() ** 2).sum(1).max()))
            tol = tol + 1e-5 * (np.sqrt(norms) if name == "L2SqrtExpanded"
                                else norms)
        gi_np = gi.cpu().numpy().astype(np.int64)
        ties = same_up_to_ties(
            f"brute force {name} vs float64", gd, gi,
            torch.from_numpy(np.take_along_axis(want, gi_np, 1)),
            torch.from_numpy(wd), torch.from_numpy(order.astype(np.int32)),
            tol)
        out[name] = {"ms_b10": ms10, "ms_b500": ms500, "ties": ties}
        log(f"[distance] brute_force {name}: batch 10 {ms10:.3f} ms, batch "
            f"500 {ms500:.3f} ms; self at rank 0"
            f"{' (n/a)' if name in NOT_TRUE_DISTANCES else ''}; 10 x "
            f"{CHECK_ROWS} equal float64 ({ties} ids at ties)")
    return out


def distance_kmeans(torch, state: dict) -> dict:
    """Unbalanced k-means on the 1M rows: two same-seed fits equal, the
    inertia below its k-means++ seeds', predict equal to fused L2 NN."""
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.distance import fused_l2_nn_argmin

    res, x = state["dres"], state["x"]
    params = kmeans.KMeansParams(n_clusters=KMEANS_CLUSTERS,
                                 max_iter=KMEANS_ITERS, seed=state["seed"])
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append(kmeans.fit(res, params, x))
        torch.cuda.synchronize()
        fits[-1] = fits[-1] + (time.perf_counter() - t0,)
    (c, inertia, n_iter, s1), (c2, inertia2, _, s2) = fits
    if not (torch.equal(c, c2) and torch.equal(inertia, inertia2)):
        fail("two same-seed k-means fits differ")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(state["seed"])
    seeds = kmeans._kmeanspp_init(gen, x, KMEANS_CLUSTERS)
    seed_cost = float(kmeans.cluster_cost(res, seeds, x))
    if not float(inertia) < seed_cost:
        fail(f"k-means inertia {float(inertia)} not below its k-means++ "
             f"seeds' {seed_cost}")
    labels, _ = kmeans.predict(res, params, c, x[:10_000])
    _, want = fused_l2_nn_argmin(x[:10_000], c)
    if not torch.equal(labels, want):
        fail("kmeans.predict differs from fused_l2_nn_argmin")
    log(f"[distance] kmeans.fit k={KMEANS_CLUSTERS} k-means++ "
        f"max_iter={KMEANS_ITERS} on {N_ROWS} rows: {s1:.2f} s and "
        f"{s2:.2f} s, {n_iter} iterations, inertia {float(inertia):.6g} "
        f"(seeds {seed_cost:.6g}); two fits torch.equal; predict equals "
        "fused_l2_nn_argmin on 10,000 rows")
    return {"fit_s": [s1, s2], "n_iter": n_iter,
            "inertia": float(inertia), "seed_cost": seed_cost}


def distance_rank_engine(torch, state: dict) -> dict:
    """The IVF-Flat rank engine on the main index against the cuda
    engine at (32, 10) and (128, 500): ids equal up to ties, times."""
    from raft_tpu_torch.neighbors import ivf_flat

    res, index, queries = state["dres"], state["index"], state["queries"]
    out = {}
    for n_probes, batch in ((32, 10), (128, 500)):
        q = queries[:batch]
        runs = {}
        for engine in ("rank", "cuda"):
            sp = ivf_flat.IvfFlatSearchParams(n_probes=n_probes,
                                              scan_engine=engine)
            runs[engine] = (ivf_flat.search(res, sp, index, q, K),
                            median_ms(lambda: ivf_flat.search(
                                res, sp, index, q, K), 5))
        (rd, ri), rms = runs["rank"]
        (cd, ci), cms = runs["cuda"]
        ties = same_up_to_ties(
            f"rank engine ({n_probes}, {batch})", rd, ri,
            _rows_f64(_l2_f64, q, state["x"], ri),
            _rows_f64(_l2_f64, q, state["x"], ci), ci,
            1e-5 * (1 + cd.abs().amax(dim=1)))
        out[f"{n_probes}x{batch}"] = {"rank_ms": rms, "cuda_ms": cms,
                                      "ties": ties}
        log(f"[distance] ivf_flat rank engine n_probes={n_probes} "
            f"batch={batch}: {rms:.3f} ms, the cuda kernel {cms:.3f} ms; "
            f"ids equal ({ties} at ties)")
    return out


def distance_ball_cover(torch, state: dict, data: dict) -> dict:
    """Ball cover on the 1M Haversine points: knn_query ids equal brute
    force's; eps_nn_query and eps_neighbors equal pairwise <= eps^2."""
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import (
        ball_cover,
        brute_force,
        epsilon_neighborhood,
    )

    res = state["dres"]
    pts, qs = data["geo"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ball_cover.build_index(res, pts, DistanceType.Haversine)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = qs[:BALL_QUERIES]
    bd, bi = ball_cover.knn_query(res, index, q, K)
    knn_ms = median_ms(lambda: ball_cover.knn_query(res, index, q, K), 3,
                       warmup=1)
    wd, wi = brute_force.knn(res, pts, q, K, DistanceType.Haversine)
    ties = same_up_to_ties("ball_cover.knn_query vs brute force", bd, bi,
                           _rows_f64(_haversine_f64, q, pts, bi),
                           _rows_f64(_haversine_f64, q, pts, wi), wi, 1e-6)
    eps = 0.01
    qe = qs[:EPS_QUERIES]
    adj, deg = ball_cover.eps_nn_query(res, index, qe, eps)
    adj2, deg2 = epsilon_neighborhood.eps_neighbors(res, qe, pts, eps)
    want = pairwise_distance(res, qe, pts, DistanceType.L2Expanded) \
        <= torch.tensor(eps, dtype=torch.float32, device="cuda") ** 2
    if not (torch.equal(adj, want) and torch.equal(adj2, want)
            and torch.equal(deg, want.sum(1, dtype=torch.int32))
            and torch.equal(deg2, deg)):
        fail("eps_nn_query / eps_neighbors differ from pairwise <= eps^2")
    eps_ms = median_ms(lambda: ball_cover.eps_nn_query(res, index, qe, eps),
                       3, warmup=1)
    log(f"[distance] ball_cover on {N_ROWS} Haversine points: build "
        f"{build_s:.2f} s ({index.n_landmarks} balls, largest "
        f"{index.members.shape[1]}); knn_query {BALL_QUERIES} queries "
        f"{knn_ms:.3f} ms, ids equal brute force ({ties} at ties); "
        f"eps_nn_query {EPS_QUERIES} x {N_ROWS} {eps_ms:.3f} ms, "
        f"{int(deg.sum())} pairs, equal to pairwise <= eps^2")
    return {"build_s": build_s, "knn_ms": knn_ms, "eps_ms": eps_ms}


def distance_masked_nn(torch, state: dict) -> dict:
    """masked_l2_nn with the main index's lists as groups, each query's
    32 nearest lists enabled, against a masked pairwise argmin."""
    from raft_tpu_torch.distance import masked_l2_nn, pairwise_distance
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_flat

    res, index, queries = state["dres"], state["index"], state["queries"]
    live = index.indices >= 0
    y = index.data[live]
    ends = torch.cumsum(live.sum(dim=1), 0)
    q = queries[:MASKED_QUERIES]
    probes = ivf_flat.coarse_probes(q, index.centers, index.center_norms,
                                    index.metric, 32, "exact")
    adj = torch.zeros(MASKED_QUERIES, N_LISTS, dtype=torch.bool,
                      device="cuda")
    adj.scatter_(1, probes.long(), True)
    d, i = masked_l2_nn(res, q, y, adj, ends)
    ms = median_ms(lambda: masked_l2_nn(res, q, y, adj, ends), 3, warmup=1)
    group = torch.searchsorted(ends, torch.arange(y.shape[0], device="cuda"),
                               right=True)
    wd, wi = [], []
    for s in range(0, MASKED_QUERIES, 100):
        full = pairwise_distance(res, q[s:s + 100], y,
                                 DistanceType.L2Expanded)
        full = torch.where(adj[s:s + 100][:, group], full,
                           torch.full_like(full, float("inf")))
        v, a = torch.min(full, dim=1)
        wd.append(v)
        wi.append(a.to(torch.int32))
    wd, wi = torch.cat(wd), torch.cat(wi)
    tol = 1e-5 * ((q * q).sum(1) + float((y * y).sum(1).max()))
    if not torch.equal(i >= 0, wi >= 0) or bool((i < 0).any()):
        fail("masked_l2_nn: a query found no row in its enabled groups")
    if not bool(adj[torch.arange(MASKED_QUERIES, device="cuda"),
                    group[i.long()]].all()):
        fail("masked_l2_nn: a result lies in a group its query disabled")
    ties = same_up_to_ties("masked_l2_nn", d[:, None], i[:, None],
                           _rows_f64(_l2_f64, q, y, i[:, None]),
                           _rows_f64(_l2_f64, q, y, wi[:, None]),
                           wi[:, None], tol)
    log(f"[distance] masked_l2_nn {MASKED_QUERIES} queries x {y.shape[0]} "
        f"rows in {N_LISTS} groups (32 enabled each): {ms:.3f} ms; equals "
        f"a masked pairwise argmin ({ties} ids at ties)")
    return {"ms": ms}


def distance_gram(torch, state: dict) -> dict:
    """gram_matrix for the four kernels at 500 x 100,000, each against a
    float64 computation on a 50 x 1,000 slice."""
    from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix

    res = state["dres"]
    x, y = state["queries"][:GRAM_ROWS], state["x"][:GRAM_COLS]
    out = {}
    xs, ys = x[:50].double(), y[:1000].double()
    ip = xs @ ys.T
    sq = (xs * xs).sum(1)[:, None] + (ys * ys).sum(1)[None, :] - 2 * ip
    gamma = 1.0 / DIM
    want = {KernelType.LINEAR: ip,
            KernelType.POLYNOMIAL: (gamma * ip + 1.0) ** 3,
            KernelType.RBF: torch.exp(-gamma * sq),
            KernelType.TANH: torch.tanh(gamma * ip + 1.0)}
    for kern in KernelType:
        p = KernelParams(kern, degree=3, gamma=gamma, coef0=1.0)
        g = gram_matrix(res, x, y, p)
        if g.shape != (GRAM_ROWS, GRAM_COLS) or not bool(
                torch.isfinite(g).all()):
            fail(f"gram_matrix {kern.name}: shape or non-finite values")
        w = want[kern]
        err = float((g[:50, :1000].double() - w).abs().max())
        if err > 1e-4 * (1.0 + float(w.abs().max())):
            fail(f"gram_matrix {kern.name}: error {err} against float64")
        ms = median_ms(lambda: gram_matrix(res, x, y, p), 3, warmup=1)
        out[kern.name] = ms
        log(f"[distance] gram_matrix {kern.name} {GRAM_ROWS} x {GRAM_COLS}: "
            f"{ms:.3f} ms (max err {err:.3g} against float64)")
    return out


def distance_manager(torch) -> None:
    """8 threads asking for the default handle at once get one."""
    import threading

    from raft_tpu_torch.core import resources

    got = [None] * 8
    go = threading.Barrier(8)

    def ask(i):
        go.wait()
        got[i] = resources.get_default_resources()

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(h is not got[0] for h in got) or got[0].device.type != "cuda":
        fail("threads got more than one default handle")
    log(f"[distance] resources manager: 8 threads, one handle on "
        f"{got[0].device}")


def distance_alone(torch, seed: int, state: dict) -> None:
    """Main's data and IVF-Flat index, for a run of the distance phase
    without main (``--phases env,build,distance``)."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_flat

    res = Resources(device="cuda", seed=seed)
    x, queries = make_data(torch, seed)
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS),
                           x)
    state.update(res=res, x=x, queries=queries, index=index, seed=seed)


def phase_distance(torch, state: dict) -> None:
    """The distance family on main's data (see the module docstring)."""
    from raft_tpu_torch import Resources

    state["dres"] = Resources(device="cuda", seed=state["seed"],
                              workspace_limit_bytes=1 << 30)
    data = distance_data(torch, state)
    reset_launches()
    out = {"brute_force": distance_brute_force(torch, state, data),
           "kmeans": distance_kmeans(torch, state),
           "rank_engine": distance_rank_engine(torch, state),
           "ball_cover": distance_ball_cover(torch, state, data),
           "masked_l2_nn": distance_masked_nn(torch, state),
           "gram": distance_gram(torch, state)}
    state["kmeans_inertia"] = out["kmeans"]["inertia"]
    counts = read_launches(("fused_knn", "list_major_scan"), "distance")
    launches = state.setdefault("launches", {})
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    distance_manager(torch)
    path = os.path.join("chiprun_out", "distance.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": state.get("card"), **out}, f, indent=1)
    log(f"[distance] {state.get('card')}: results in {path}")


# stream / dist: the streaming builds from a .fbin and the mesh layer on
# R shard slots of the one card
STREAM_CHUNKS = (1 << 18, 100_000)      # the second divides nothing
STREAM_RECALL_GAP = 0.01
DIST_SLOTS = 4
# queries per batch size: 100 requests at batch 10, 20 at 500
STREAM_QUERIES = DIST_QUERIES = {10: 1000, 500: N_QUERIES}
DIST_KNN_QUERIES = 100
# the local probes and the probe wires are read on the first 1,000
DIST_CHECK_QUERIES = 1000
DIST_WIRE_FLOORS = {"bf16": 0.99, "int8": 0.95}
# local probes' recall@10 at n_probes 128, batch 500, as a share of the
# global probes'
DIST_LOCAL_FLOOR = 0.90
# the distributed fit is held to single-device Lloyd from its own seeds
# (k-means++ on a 4,096-row strided subsample, the JAX package's and the
# reference MNMG k-means' design): the all-reduces only reorder float
# sums, and a sound run reads an inertia gap of ~1e-5 of the limit's
# 1e-4. The distance phase's fit seeds on all 1M rows; the gap to it is
# printed (+1.24% at 20 iterations, PERF.md). A few near-tie rows flip
# label between the two sum orders and move some centers (max ~5e-2
# relative), so the centers are held by their median relative move
# (sound: ~3e-7); an EM that lost a slot's sums moves every center
DIST_KMEANS_GAP = 1e-4
DIST_KMEANS_CENTER_MEDIAN = 1e-5
DIST_CAGRA_ROWS = 200_000


def _stream_params(ivf_flat, ivf_pq, ivf_bq):
    """The three families' build params: the sift config's n_lists, its
    raft_ivf_pq entry, IVF-BQ at bits 1."""
    return {"flat": (ivf_flat, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS),
                     ivf_flat.IvfFlatSearchParams),
            "pq": (ivf_pq, ivf_pq.IvfPqIndexParams(**PQ_BUILD),
                   ivf_pq.IvfPqSearchParams),
            "bq": (ivf_bq, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS, bits=1),
                   ivf_bq.IvfBqSearchParams)}


def _searched(torch, search, queries, batch: int, n_q: int):
    """(ids, median ms per request) of ``search`` over ``n_q`` queries in
    requests of ``batch``; the first request is left out of the median."""
    outs, times = [], []
    for s in range(0, n_q, batch):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs.append(search(queries[s:s + batch]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    return outs, float(np.median(times[1:] or times))


def stream_alone(torch, seed: int, state: dict) -> None:
    """Main's data and truth, and the in-memory IVF-Flat, IVF-PQ and
    IVF-BQ indexes, for a run of stream/dist without the earlier phases
    (``--phases env,build,stream,dist``)."""
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

    if "gt_i" not in state:
        pq_data(torch, seed, state)
    res, x = state["res"], state["x"]
    fams = _stream_params(ivf_flat, ivf_pq, ivf_bq)
    for key, fam in (("index", "flat"), ("pq_index", "pq"),
                     ("bq_index", "bq")):
        if key not in state:
            mod, params, _ = fams[fam]
            state[key] = mod.build(res, params, x)


def phase_stream(torch, state: dict) -> None:
    """The streaming builds from a .fbin (the module docstring)."""
    import tempfile

    from raft_tpu_torch.io import BinDataset, read_bin, write_bin
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

    res, x, queries, gt_i = (state["res"], state["x"], state["queries"],
                             state["gt_i"])
    tmp = tempfile.mkdtemp(prefix="raft_stream_")
    path = os.path.join(tmp, "sift_shape.fbin")
    host = x.cpu().numpy()
    t0 = time.perf_counter()
    if not write_bin(path, host, use_native=True):
        fail("write_bin did not take the native writer")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_bin(path, use_native=True)
    read_s = time.perf_counter() - t0
    if not np.array_equal(back, host):
        fail("read_bin does not return the rows write_bin wrote")
    del back
    nbytes = os.path.getsize(path)
    with BinDataset(path, use_native=True) as ds:
        t0 = time.perf_counter()
        n = sum(c.shape[0] for _, c in ds.iter_chunks(STREAM_CHUNKS[0],
                                                      copy=False))
        chunk_s = time.perf_counter() - t0
    if n != N_ROWS:
        fail(f"iter_chunks gave {n} rows")
    log(f"[stream] native write_bin {nbytes} bytes in {write_s:.3f} s "
        f"({nbytes / write_s / 1e9:.3f} GB/s), read_bin {read_s:.3f} s "
        f"({nbytes / read_s / 1e9:.3f} GB/s), rows equal; iter_chunks of "
        f"{STREAM_CHUNKS[0]} rows {chunk_s:.3f} s "
        f"({nbytes / chunk_s / 1e9:.3f} GB/s; page cache warm: the file "
        "was just written)")
    state.update(stream_dir=tmp, stream_path=path)
    in_memory = {"flat": state["index"], "pq": state["pq_index"],
                 "bq": state["bq_index"]}
    reset_launches()
    out = {"write_gbps": nbytes / write_s / 1e9,
           "read_gbps": nbytes / read_s / 1e9,
           "chunk_gbps": nbytes / chunk_s / 1e9}
    for fam, (mod, params, SP) in _stream_params(ivf_flat, ivf_pq,
                                                 ivf_bq).items():
        builds = []
        for chunk in STREAM_CHUNKS:
            with BinDataset(path, use_native=True) as ds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                builds.append(mod.build_streaming(res, params, ds,
                                                  chunk_rows=chunk))
                torch.cuda.synchronize()
                log(f"[stream] {fam} build_streaming chunk_rows={chunk}: "
                    f"{time.perf_counter() - t0:.2f} s, size "
                    f"{builds[-1].size}")
        a, b = builds
        for f in dataclasses.fields(a):
            u, v = getattr(a, f.name), getattr(b, f.name)
            same = (torch.equal(u, v) if isinstance(u, torch.Tensor)
                    else u == v)
            if not same:
                fail(f"{fam} build_streaming differs between chunk_rows "
                     f"{STREAM_CHUNKS}: {f.name}")
        if a.size != N_ROWS:
            fail(f"{fam} build_streaming indexed {a.size} rows")
        rows = {}
        for n_probes in (32, 128):
            sp = SP(n_probes=n_probes)
            for batch, n_q in STREAM_QUERIES.items():
                outs, ms = _searched(
                    torch, lambda q: mod.search(res, sp, a, q, K), queries,
                    batch, n_q)
                mem, _ = _searched(
                    torch, lambda q: mod.search(res, sp, in_memory[fam], q,
                                                K), queries, batch, n_q)
                r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
                rm = recall(torch.cat([o[1] for o in mem]), gt_i[:n_q])
                log(f"[stream] {fam} n_probes={n_probes} batch={batch}: "
                    f"recall@10 {r:.4f} (in-memory build {rm:.4f}) over "
                    f"{n_q} queries, median {ms:.3f} ms")
                # the builds train on other samples, so their recall is
                # held on all the queries, where a draw moves it least
                if n_q == N_QUERIES and abs(r - rm) > STREAM_RECALL_GAP:
                    fail(f"streamed {fam} recall {r:.4f} is more than "
                         f"{STREAM_RECALL_GAP} from the in-memory {rm:.4f}")
                rows[f"{n_probes}x{batch}"] = dict(recall=r, in_memory=rm,
                                                   ms=ms)
        out[fam] = rows
        del builds, a, b
    counts = read_launches(("list_major_scan", "bq_scan", "ivf_pq_scan"),
                           "stream")
    launches = state.setdefault("launches", {})
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    state["stream"] = out
    torch.cuda.empty_cache()


def _same(torch, name, got, want) -> None:
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[1] != want[1]).sum())
        fail(f"{name}: distributed search differs from the single-device "
             f"one ({bad} ids)")


def _agree(got, ref) -> float:
    return float((got[:, :, None] == ref[:, None, :]).any(dim=2)
                 .float().mean())


def dist_family(torch, state, fam, di, single, SP, search, single_search):
    """One list-sharded family at the four requests: global bit-identical
    to the single-device search, local at its floor, the probe wires at
    theirs; save -> load -> search bit-identical."""
    from raft_tpu_torch.distributed import checkpoint

    res, queries, gt_i = state["res"], state["queries"], state["gt_i"]
    out = {}
    for n_probes in (32, 128):
        sp = SP(n_probes=n_probes)
        for batch, n_q in DIST_QUERIES.items():
            outs, ms = _searched(
                torch, lambda q: search(res, sp, di, q, K), queries, batch,
                n_q)
            want, ms1 = _searched(
                torch, lambda q: single_search(res, sp, single, q, K),
                queries, batch, n_q)
            for i, (g, w) in enumerate(zip(outs, want)):
                _same(torch, f"{fam} ({n_probes}, {batch}) request {i}", g, w)
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            row = dict(recall=r, ms=ms, single_ms=ms1)
            if batch == 500:
                nc = DIST_CHECK_QUERIES
                q = queries[:nc]
                _, loc = search(res, sp, di, q, K, probe_mode="local")
                row["local_recall"] = recall(loc, gt_i[:nc])
                row["global_recall"] = recall(ids[:nc], gt_i[:nc])
                for wire, floor in DIST_WIRE_FLOORS.items():
                    _, w = search(res, sp, di, q, K, probe_wire_dtype=wire)
                    row[f"{wire}_agree"] = _agree(w, ids[:nc])
                    if row[f"{wire}_agree"] < floor:
                        fail(f"{fam} {wire} probe wire agrees "
                             f"{row[f'{wire}_agree']:.4f} < {floor}")
                rg = row["global_recall"]
                if (n_probes == 128
                        and row["local_recall"] < DIST_LOCAL_FLOOR * rg):
                    fail(f"{fam} local-probe recall {row['local_recall']:.4f}"
                         f" < {DIST_LOCAL_FLOOR} x the global {rg:.4f}")
            log(f"[dist] {fam} n_probes={n_probes} batch={batch}: global "
                f"equals single-device bit for bit over {n_q} queries; "
                f"recall@10 {r:.4f}, median {ms:.3f} ms (single-device "
                f"{ms1:.3f} ms), {len(outs)} requests" + "".join(
                    f", {k} {v:.4f}" for k, v in row.items()
                    if k.endswith(("agree", "local_recall"))))
            out[f"{n_probes}x{batch}"] = row
    save, load = {"flat": (checkpoint.save_flat, checkpoint.load_flat),
                  "pq": (checkpoint.save_pq, checkpoint.load_pq),
                  "bq": (checkpoint.save_bq, checkpoint.load_bq)}[fam]
    buf = io.BytesIO()
    t0 = time.perf_counter()
    save(di, buf)
    buf.seek(0)
    back = load(res, di.comms, buf)
    s = time.perf_counter() - t0
    sp = SP(n_probes=128)
    _same(torch, f"{fam} save -> load -> search",
          search(res, sp, back, queries[:500], K),
          search(res, sp, di, queries[:500], K))
    log(f"[dist] {fam} checkpoint ({buf.getbuffer().nbytes} bytes) save -> "
        f"load {s:.2f} s -> search: bit-identical")
    out["checkpoint_bytes"] = buf.getbuffer().nbytes
    return out


# the rank-major mesh searches: (n_probes, batch) -> queries searched (a
# cut for the time limit: the rank scans gather every probed list per
# query)
DIST_RANK_QUERIES = {(32, 10): 200, (128, 500): 1000}
# IVF-BQ's rank estimate takes |q - c|^2 from the coarse products q.c,
# a (q, n_lists / R) product on a slot and (q, n_lists) on one device:
# the two GEMMs round differently, so its distances are held to this
# share of |q|^2 + max |c|^2 (ids stay exact); IVF-Flat's and IVF-PQ's
# rank distances use no coarse product and must be bit-identical
DIST_RANK_BQ_RTOL = 1e-6


def dist_rank(torch, state: dict, out: dict) -> None:
    """The rank-major engines in the shard bodies on the three dealt
    indexes: each request equal to the single-device rank search of the
    same family (ids and distances), the median ms beside the list-major
    engine's; then a codes-only 4-slot IVF-BQ index (the main phase's
    index with its rerank plane dropped: what store_vectors=False builds)
    searched at the overfetch depth, its recall@10 raw and refined."""
    from raft_tpu_torch.distributed import bq as dbq
    from raft_tpu_torch.distributed import ivf as divf
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq, refine

    res, queries, gt_i = state["res"], state["queries"], state["gt_i"]
    fams = (("flat", state["dist_flat"], state["index"],
             ivf_flat.IvfFlatSearchParams, divf.search, ivf_flat.search),
            ("pq", state["dist_pq"], state["pq_index"],
             ivf_pq.IvfPqSearchParams, divf.search_pq, ivf_pq.search),
            ("bq", state["dist_bq"], state["bq_index"],
             ivf_bq.IvfBqSearchParams, dbq.search_bq, ivf_bq.search))
    cmax = float(torch.square(state["index"].centers).sum(dim=1).max())
    for fam, di, single, SP, search, single_search in fams:
        for (n_probes, batch), n_q in DIST_RANK_QUERIES.items():
            sp = SP(n_probes=n_probes, scan_engine="rank")
            outs, ms = _searched(
                torch, lambda q: search(res, sp, di, q, K), queries, batch,
                n_q)
            want, ms1 = _searched(
                torch, lambda q: single_search(res, sp, single, q, K),
                queries, batch, n_q)
            same_d, worst = 0, 0.0
            for i, (g, w) in enumerate(zip(outs, want)):
                if not torch.equal(g[1], w[1]):
                    fail(f"{fam} rank ({n_probes}, {batch}) request {i}: "
                         f"{int((g[1] != w[1]).sum())} ids differ from the "
                         "single-device rank search")
                same_d += int(torch.equal(g[0], w[0]))
                q = queries[i * batch:(i + 1) * batch]
                scale = torch.square(q).sum(dim=1, keepdim=True) + cmax
                ok = torch.isfinite(w[0])
                worst = max(worst, float(((g[0] - w[0]).abs() / scale)[ok]
                                         .max()))
            if fam == "bq":
                if worst > DIST_RANK_BQ_RTOL:
                    fail(f"bq rank ({n_probes}, {batch}): distances differ "
                         f"from the single-device rank search's by {worst:.3g}"
                         f" of |q|^2 + max |c|^2 (> {DIST_RANK_BQ_RTOL})")
            elif same_d != len(outs):
                fail(f"{fam} rank ({n_probes}, {batch}): the distances of "
                     f"{len(outs) - same_d} requests differ from the "
                     "single-device rank search's")
            r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
            lm = out[fam][f"{n_probes}x{batch}"]["ms"]
            log(f"[dist] {fam} rank engine n_probes={n_probes} "
                f"batch={batch}: {len(outs)} requests, ids equal the "
                f"single-device rank search's, distances bit-identical in "
                f"{same_d} (largest difference {worst:.3g} of |q|^2 + max "
                f"|c|^2); recall@10 {r:.4f}; median {ms:.3f} ms "
                f"(single-device rank {ms1:.3f} ms; the list-major mesh "
                f"engine {lm:.3f} ms)")
            out[fam][f"rank_{n_probes}x{batch}"] = dict(
                recall=r, ms=ms, single_ms=ms1, list_major_ms=lm,
                requests=len(outs), bit_identical=same_d, worst_rel=worst)
    # a codes-only index: the rank-major estimate scan at the overfetch
    # depth, the candidates refined against the vectors
    codes_only = dataclasses.replace(state["dist_bq"], data=None,
                                     data_norms=None)
    depth = dbq.merge_overfetch(codes_only, K)
    sp = ivf_bq.IvfBqSearchParams(n_probes=128)
    n_q = DIST_RANK_QUERIES[(128, 500)]
    outs, ms = _searched(
        torch, lambda q: dbq.search_bq(res, sp, codes_only, q, depth),
        queries, 500, n_q)
    cand = torch.cat([o[1] for o in outs])
    raw = recall(cand[:, :K], gt_i[:n_q])
    _, ref_i = refine.refine(res, state["x"], queries[:n_q], cand, K)
    refined = recall(ref_i, gt_i[:n_q])
    single = dataclasses.replace(state["bq_index"], data=None,
                                 data_norms=None)
    want = ivf_bq.search(res, sp, single, queries[:500], depth)
    if not torch.equal(outs[0][1], want[1]):
        fail("the codes-only 4-slot IVF-BQ search differs from the "
             "single-device codes-only search")
    log(f"[dist] codes-only IVF-BQ over {DIST_SLOTS} slots (rank-major "
        f"estimate scan) at n_probes=128, batch 500, depth {depth} (the "
        f"merge overfetch of k={K}): recall@10 {raw:.4f} raw, {refined:.4f} "
        f"refined; median {ms:.3f} ms; ids equal the single-device "
        "codes-only search")
    out["bq_codes_only"] = dict(depth=depth, recall_raw=raw,
                                recall_refined=refined, ms=ms)


def phase_dist(torch, state: dict) -> None:
    """The mesh layer on DIST_SLOTS shard slots of the card (the module
    docstring)."""
    import shutil

    from raft_tpu_torch.comms import local_comms
    from raft_tpu_torch.distributed import (
        brute_force_knn,
        brute_force_knn_ring,
        build_sharded,
        kmeans_fit,
    )
    from raft_tpu_torch.distributed import bq as dbq
    from raft_tpu_torch.distributed import ivf as divf
    from raft_tpu_torch.io import BinDataset
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat
    from raft_tpu_torch.neighbors import ivf_pq

    res, x, queries, gt_i = (state["res"], state["x"], state["queries"],
                             state["gt_i"])
    comms = local_comms(shape=(DIST_SLOTS,), device="cuda")
    out = {}
    reset_launches()

    # exact kNN: ids equal single-device brute force, ties aside
    nq = DIST_KNN_QUERIES
    t0 = time.perf_counter()
    bd, bi = brute_force_knn(comms, x, queries[:nq], K)
    rd, ri = brute_force_knn_ring(comms, x, queries[:nq], K)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    bf = brute_force.build(res, x)
    td, ti = brute_force.search(res, bf, queries[:nq], K)
    tol = 1e-5 * ((queries[:nq] ** 2).sum(dim=1, keepdim=True)
                  + float(bf.norms.max()))
    for name, (d, i) in (("brute_force_knn", (bd, bi)),
                         ("brute_force_knn_ring", (rd, ri))):
        if bool(((d - td).abs() > tol).any()) or float(
                (i != ti).float().mean()) > 1e-3:
            fail(f"{name} differs from single-device brute force beyond "
                 "ties")
    log(f"[dist] brute_force_knn and its ring form over {DIST_SLOTS} slots, "
        f"{nq} queries: {s:.2f} s, {int((bi != ti).sum())} and "
        f"{int((ri != ti).sum())} ids differ from brute force, at distances "
        "tied within 1e-5 (|q|^2 + max |x|^2)")

    # k-means: two fits torch.equal, on single-device Lloyd's path
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.distributed import kmeans as dist_kmeans

    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append(kmeans_fit(comms, x, KMEANS_CLUSTERS,
                               n_iters=KMEANS_ITERS, seed=state["seed"]))
        torch.cuda.synchronize()
        fits[-1] = fits[-1] + (time.perf_counter() - t0,)
    (c1, in1, s1), (c2, in2, s2) = fits
    if not (torch.equal(c1, c2) and torch.equal(in1, in2)):
        fail("two same-seed distributed k-means fits differ")
    seeds = dist_kmeans.initial_centers(x, KMEANS_CLUSTERS, state["seed"])
    same_c, same, n_it = kmeans.fit(res, kmeans.KMeansParams(
        n_clusters=KMEANS_CLUSTERS, init=kmeans.InitMethod.Array,
        max_iter=KMEANS_ITERS, tol=0.0), x, init_centroids=seeds)
    gap = float(in1) / float(same) - 1.0
    moved = (c1 - same_c).norm(dim=1) / same_c.norm(dim=1).clamp(min=1e-30)
    single = state.get("kmeans_inertia")
    log(f"[dist] kmeans_fit k={KMEANS_CLUSTERS} {KMEANS_ITERS} iterations "
        f"over {DIST_SLOTS} slots: {s1:.2f} s and {s2:.2f} s, torch.equal; "
        f"inertia {float(in1):.6g}, {gap:+.4%} of the single-device fit "
        f"from the same seeds ({float(same):.6g}, {n_it} iterations); "
        f"centers moved from its by |dc|/|c| median "
        f"{float(moved.median()):.3g}, max {float(moved.max()):.3g}, "
        f"{int((moved > 1e-4).sum())} of {KMEANS_CLUSTERS} above 1e-4" + (
            "" if single is None else
            f"; {float(in1) / single - 1.0:+.4%} of the distance phase's "
            f"fit seeded on all rows ({single:.6g})"))
    if abs(gap) > DIST_KMEANS_GAP:
        fail(f"distributed k-means inertia is {gap:+.4%} from the "
             "single-device fit's")
    if float(moved.median()) > DIST_KMEANS_CENTER_MEDIAN:
        fail(f"distributed k-means centers moved a median "
             f"{float(moved.median()):.3g} from single-device Lloyd's")
    out["kmeans"] = dict(fit_s=[s1, s2], inertia=float(in1),
                         same_seeds=float(same), gap=gap,
                         center_moved_median=float(moved.median()),
                         center_moved_max=float(moved.max()),
                         all_rows_seeded=single)
    del fits, c1, c2, same_c

    # IVF-Flat: the dealt build and the streamed build
    params = ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)
    t0 = time.perf_counter()
    flat = divf.build(res, comms, params, x)
    torch.cuda.synchronize()
    log(f"[dist] ivf_flat build + deal: {time.perf_counter() - t0:.2f} s")
    out["flat"] = dist_family(torch, state, "flat", flat, state["index"],
                              ivf_flat.IvfFlatSearchParams, divf.search,
                              ivf_flat.search)
    # the meshserve and observe phases serve these dealt indexes
    state["dist_flat"] = flat
    with BinDataset(state["stream_path"], use_native=True) as ds:
        t0 = time.perf_counter()
        streamed = divf.build_streaming(res, comms, params, ds,
                                        chunk_rows=STREAM_CHUNKS[0])
        torch.cuda.synchronize()
        sb = time.perf_counter() - t0
    with BinDataset(state["stream_path"], use_native=True) as ds:
        single_streamed = divf.from_index(comms, ivf_flat.build_streaming(
            res, params, ds, chunk_rows=STREAM_CHUNKS[0]))
    sp = ivf_flat.IvfFlatSearchParams(n_probes=128)
    got = divf.search(res, sp, streamed, queries[:1000], K)
    r = recall(got[1], gt_i[:1000])
    rs = recall(divf.search(res, sp, single_streamed, queries[:1000], K)[1],
                gt_i[:1000])
    log(f"[dist] ivf_flat build_streaming over {DIST_SLOTS} slots: {sb:.2f} "
        f"s, size {streamed.size}; recall@10 at (128, 500) {r:.4f} (the "
        f"single-device streamed build dealt: {rs:.4f})")
    if streamed.size != N_ROWS or abs(r - rs) > STREAM_RECALL_GAP:
        fail("the distributed streamed build lost rows or recall")
    out["flat_streaming"] = dict(build_s=sb, recall=r, single=rs)
    del streamed, single_streamed
    shutil.rmtree(state.pop("stream_dir"), ignore_errors=True)

    # IVF-PQ and IVF-BQ on the pq and main phases' indexes, dealt
    t0 = time.perf_counter()
    pq = divf.from_pq_index(comms, state["pq_index"])
    bq = dbq.from_bq_index(comms, state["bq_index"])
    torch.cuda.synchronize()
    log(f"[dist] ivf_pq and ivf_bq deals: {time.perf_counter() - t0:.2f} s")
    out["pq"] = dist_family(torch, state, "pq", pq, state["pq_index"],
                            ivf_pq.IvfPqSearchParams, divf.search_pq,
                            ivf_pq.search)
    out["bq"] = dist_family(torch, state, "bq", bq, state["bq_index"],
                            ivf_bq.IvfBqSearchParams, dbq.search_bq,
                            ivf_bq.search)
    state["dist_pq"], state["dist_bq"] = pq, bq
    dist_rank(torch, state, out)

    # index-per-shard CAGRA on the first DIST_CAGRA_ROWS rows
    part = x[:DIST_CAGRA_ROWS]
    t0 = time.perf_counter()
    sharded = build_sharded(
        res, lambda r_, p: cagra.build(r_, cagra_params(cagra), p),
        lambda r_, ix, q, k: cagra.search(
            r_, cagra.CagraSearchParams(itopk_size=64, search_width=4), ix,
            q, k), part, n_shards=DIST_SLOTS)
    torch.cuda.synchronize()
    cs = time.perf_counter() - t0
    truth = brute_force.search(res, brute_force.build(res, part),
                               queries[:500], K)[1]
    _, ci = sharded.search(res, queries[:500], K)
    rc = recall(ci, truth)
    log(f"[dist] sharded ANN: {DIST_SLOTS} CAGRA sub-indexes on the first "
        f"{DIST_CAGRA_ROWS} rows, build {cs:.2f} s, recall@10 {rc:.4f} at "
        "itopk 64, batch 500")
    if rc < 0.90:
        fail(f"sharded CAGRA recall {rc:.4f} < 0.90")
    out["sharded_cagra"] = dict(build_s=cs, recall=rc)
    del sharded
    counts = read_launches(("list_major_scan", "bq_scan", "ivf_pq_scan",
                            "beam_search"), "dist")
    launches = state.setdefault("launches", {})
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    path = os.path.join("chiprun_out", "dist.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": state.get("card"), "stream": state.get("stream"),
                   **out}, f, indent=1)
    log(f"[dist] {state.get('card')}: results in {path}")
    torch.cuda.empty_cache()


# meshserve / observe: the executor's mesh plans and the observability
# plane, on the dist phase's 4-slot indexes


MESH_POINTS = ((32, 10), (128, 10), (128, 500))
MESH_TIMED = 20
MESH_RAGGED_REQUESTS = 160
MESH_ACCOUNTED_REQUESTS = 8
OBSERVE_REQUESTS = 800
OBSERVE_THREADS = 4
#: served requests in the flight recorder's threshold window and in its
#: trigger window
FLIGHT_WINDOW = 64
DRIFT_ROUNDS = 3


def _mesh_families(state: dict) -> list:
    """(family, dealt index, params type, direct search, kernel) of the
    three list-sharded families the dist phase kept."""
    from raft_tpu_torch.distributed import bq as dbq
    from raft_tpu_torch.distributed import ivf as divf
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

    return [("dist_ivf_flat", state["dist_flat"],
             ivf_flat.IvfFlatSearchParams, divf.search, "list_major_scan"),
            ("dist_ivf_pq", state["dist_pq"], ivf_pq.IvfPqSearchParams,
             divf.search_pq, "ivf_pq_scan"),
            ("dist_ivf_bq", state["dist_bq"], ivf_bq.IvfBqSearchParams,
             dbq.search_bq, "bq_scan")]


def _host_ms(torch, fn, reps: int) -> float:
    """Median request ms on the host clock, each request synchronized."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_meshserve(torch, state: dict) -> None:
    """The executor's mesh plans on the dist phase's indexes (the module
    docstring)."""
    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.comms import local_comms
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.distributed import ivf as divf
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher, metrics

    res, queries = state["res"], state["queries"]
    sizes = _request_sizes(state["seed"] + 15, SERVE_REQUESTS)
    out = {"families": {}}
    launches = state.setdefault("launches", {})
    executors = {}
    for family, index, SP, direct, kernel in _mesh_families(state):
        ex = SearchExecutor(res)
        t0 = time.perf_counter()
        for n_probes in (32, 128):
            ex.warmup(index, buckets=SERVE_LADDER, k=K,
                      params=SP(n_probes=n_probes))
        cap_s = time.perf_counter() - t0
        costs = ex.executable_costs().values()
        if not all(c["captured"] for c in costs):
            fail(f"meshserve {family}: a plan was not captured")
        pool = sum(c["pool_bytes"] for c in costs)
        reqs = [(m, s, SP(n_probes=(32, 128)[j % 2]))
                for j, (m, s) in enumerate(sizes)]
        want = [direct(res, sp, index, queries[s:s + m], K)
                for m, s, sp in reqs]
        torch.cuda.synchronize()
        c0 = ex.stats.compile_count
        reset_launches()
        got = [ex.search(index, queries[s:s + m], K, params=sp)
               for m, s, sp in reqs]
        torch.cuda.synchronize()
        counts = read_launches((kernel,), f"meshserve {family}")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        for j, (g, w) in enumerate(zip(got, want)):
            _served_equal(torch, f"mesh {family} request {j}", g, w)
        if ex.stats.compile_count != c0:
            fail(f"meshserve {family}: {ex.stats.compile_count - c0} "
                 "captures after warmup")
        log(f"[meshserve] {family}: {len(costs)} plans captured (ladder "
            f"{SERVE_LADDER[0]}..{SERVE_LADDER[-1]} x n_probes 32, 128) in "
            f"{cap_s:.2f} s, graph pools {pool / 2**20:.1f} MiB; "
            f"{len(reqs)} requests of 1-500 rows equal the direct search "
            f"bit for bit, 0 captures after warmup, {kernel} launched "
            f"{counts[kernel]} times")
        row = {"plans": len(costs), "capture_s": cap_s, "pool_bytes": pool,
               "launches": counts[kernel]}
        serve_rows = {r["request"]: r for r in state.get("serve_times", ())}
        for n_probes, batch in MESH_POINTS:
            sp = SP(n_probes=n_probes)
            q = queries[:batch]
            d_ms = _host_ms(torch, lambda: direct(res, sp, index, q, K),
                            MESH_TIMED)
            c_ms = _host_ms(torch, lambda: ex.search(index, q, K, params=sp),
                            MESH_TIMED)
            single = serve_rows.get(
                f"ivf_flat n_probes={n_probes} batch={batch}", {}).get(
                    "captured_ms") if family == "dist_ivf_flat" else None
            row[f"{n_probes}x{batch}"] = dict(direct_ms=d_ms, captured_ms=c_ms,
                                              single_captured_ms=single)
            log(f"[meshserve] {family} ({n_probes}, {batch}): direct "
                f"{d_ms:.3f} ms, captured {c_ms:.3f} ms (median of "
                f"{MESH_TIMED} requests, host clock, each synchronized)"
                + ("" if single is None else
                   f"; single-device captured (serve phase) {single:.3f} ms"))
        out["families"][family] = row
        executors[family] = ex

    flat = state["dist_flat"]
    flat_ex = executors["dist_ivf_flat"]
    # the 2-D grid: the same lists over 4 list slots x 2 query slots
    comms2 = local_comms(("lists", "queries"), shape=(2, 2),
                         device=res.device)
    flat2 = divf.from_index(comms2, state["index"])
    ex2 = SearchExecutor(res)
    for n_probes, batch in MESH_POINTS:
        sp = ivf_flat.IvfFlatSearchParams(n_probes=n_probes)
        q = queries[:batch + 3]
        _served_equal(torch, f"2-D grid ({n_probes}, {batch + 3})",
                      ex2.search(flat2, q, K, params=sp, query_axis="queries"),
                      flat_ex.search(flat, q, K, params=sp))
    log("[meshserve] 2 x 2 grid (2 list x 2 query slots, query_axis): "
        f"equal to the 1-D {DIST_SLOTS}-slot plan bit for bit at "
        + ", ".join(f"({p}, {b + 3})" for p, b in MESH_POINTS)
        + f" ({ex2.stats.compile_count} plans captured)")
    del flat2, ex2

    # the batcher over the mesh ragged family, four threads
    ragged = SearchExecutor(res, ragged_tile=256)
    classes = [ivf_flat.IvfFlatSearchParams(n_probes=p) for p in (20, 24, 32)]
    ragged.warmup_ragged(flat, k=K, params=classes[-1])
    rng = np.random.default_rng(state["seed"] + 16)
    reqs = [(int(m), int(rng.integers(0, N_QUERIES - 40)),
             classes[int(rng.integers(0, 3))])
            for m in rng.integers(1, 41, MESH_RAGGED_REQUESTS)]
    solo = [divf.search(res, sp, flat, queries[s:s + m], K)
            for m, s, sp in reqs]
    torch.cuda.synchronize()
    c0 = ragged.stats.compile_count
    metrics.reset()
    results = [None] * len(reqs)
    with DynamicBatcher(ragged, BatcherConfig(max_wait_s=0.002,
                                              ragged=True)) as b:
        def worker(t):
            hs = [(j, b.submit(flat, queries[s:s + m], K, params=sp))
                  for j, (m, s, sp) in enumerate(reqs)
                  if j % OBSERVE_THREADS == t]
            for j, h in hs:
                results[j] = h.result(timeout=120)

        import threading

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(OBSERVE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    for j, (g, w) in enumerate(zip(results, solo)):
        if g is None:
            fail(f"meshserve ragged request {j} got no result")
        _served_equal(torch, f"mesh ragged request {j}", g, w)
    waste = metrics.derived()["pad_waste_fraction"]
    calls = tracing.get_counter("serving.execute.calls")
    if ragged.stats.compile_count != c0 or ragged.ragged_executables() != 1:
        fail("meshserve ragged: a capture after warmup")
    log(f"[meshserve] ragged dist_ivf_flat (n_probes 20/24/32, 256-row "
        f"tiles) behind a DynamicBatcher from {OBSERVE_THREADS} threads: "
        f"{len(reqs)} requests of 1-40 rows in {int(calls)} packed "
        f"dispatches, each row equal to its solo search; pad waste "
        f"{100 * waste:.1f}%, 0 captures after warmup")
    out["ragged"] = dict(requests=len(reqs), dispatches=calls,
                         pad_waste=waste)
    del ragged

    # probe accounting: the mesh plane in the dealt order against the
    # single-device executor's, on the same requests
    from raft_tpu_torch.distributed.ivf import deal_order

    sp = ivf_flat.IvfFlatSearchParams(n_probes=32)
    mesh_acc = SearchExecutor(res, probe_accounting=True)
    single_acc = SearchExecutor(res, probe_accounting=True)
    mesh_acc.warmup(flat, buckets=(512,), k=K, params=sp)
    single_acc.warmup(state["index"], buckets=(512,), k=K, params=sp)
    for j in range(MESH_ACCOUNTED_REQUESTS):
        q = queries[500 * j:500 * j + 500 - 7 * j]
        mesh_acc.search(flat, q, K, params=sp)
        single_acc.search(state["index"], q, K, params=sp)
    (hm,) = mesh_acc.probe_frequencies().values()
    (hs,) = single_acc.probe_frequencies().values()
    perm = deal_order(state["index"].list_sizes.cpu().numpy(), DIST_SLOTS)
    if not np.array_equal(hm, hs[perm]):
        fail("meshserve: the mesh probe histogram differs from the "
             "single-device one")
    log(f"[meshserve] probe accounting over {MESH_ACCOUNTED_REQUESTS} "
        f"requests ({int(hm.sum())} probes): the mesh plane equals the "
        "single-device plane in the dealt order, list for list")
    del mesh_acc, single_acc

    # mesh_trace: spans and gauges from a captured plan whose graph
    # records an event after each slot's scan, no new capture
    traced = SearchExecutor(res, mesh_trace=True)
    traced.warmup(flat, buckets=(16,), k=K, params=sp)
    c0 = traced.stats.compile_count
    tracing.reset_spans()
    tracing.reset_gauges("serving.mesh.")
    d0 = tracing.get_counter("serving.mesh.dispatches")
    tid = tracing.new_trace_id()
    for j in range(5):
        traced.search(flat, queries[16 * j:16 * j + 16], K, params=sp,
                      trace_ids=(tid,))
    rec = tracing.span_recorder()
    phases = {p: rec.spans(trace_id=tid, name=f"serving.mesh.{p}")
              for p in ("coarse_select", "scan", "merge")}
    ready = [s.duration for s in phases["merge"]]
    shards = rec.spans(trace_id=tid, name="serving.mesh.shard")
    slot_ms = []
    for m in phases["merge"]:
        offs = [s.duration for s in shards if s.start == m.start]
        if (len(offs) != DIST_SLOTS or len(set(offs)) != DIST_SLOTS
                or max(offs) > m.duration):
            fail(f"meshserve: mesh_trace slot readings {offs} against the "
                 f"merged readiness {m.duration}")
        slot_ms.append([round(o * 1e3, 4) for o in offs])
    gauges = tracing.gauges("serving.mesh.")
    if (any(len(v) != 5 for v in phases.values()) or min(ready) <= 0
            or tracing.MESH_SLOWEST_SHARD not in gauges
            or tracing.MESH_SHARD_SKEW not in gauges
            or tracing.get_counter("serving.mesh.dispatches") != d0 + 5
            or traced.stats.compile_count != c0):
        fail("meshserve: mesh_trace spans or straggler gauges missing, or "
             "a capture")
    log(f"[meshserve] mesh_trace: 5 dispatches recorded "
        f"{ {p: len(v) for p, v in phases.items()} } phase spans over the "
        f"merged outputs' readiness ({min(ready) * 1e3:.3f}-"
        f"{max(ready) * 1e3:.3f} ms after dispatch) and {len(shards)} "
        f"serving.mesh.shard spans from the events inside the graph (slot "
        f"readiness ms per dispatch {slot_ms}); straggler gauges: slowest "
        f"slot {gauges[tracing.MESH_SLOWEST_SHARD]:.0f}, skew "
        f"{gauges[tracing.MESH_SHARD_SKEW] * 1e3:.4f} ms; 0 captures")
    out["mesh_trace"] = dict(ready_ms=[r * 1e3 for r in ready],
                             slot_ms=slot_ms,
                             gauges={k: v for k, v in gauges.items()})
    del traced

    # rank-engine mesh plans: IVF-Flat eager, codes-only IVF-BQ captured,
    # as the single-device rank plans are
    from raft_tpu_torch.distributed import bq as dbq
    from raft_tpu_torch.neighbors import ivf_bq

    codes_only = dataclasses.replace(state["dist_bq"], data=None,
                                     data_norms=None)
    rank_plans = (("dist_ivf_flat", flat, ivf_flat.IvfFlatSearchParams(
        n_probes=32, scan_engine="rank"), divf.search, False),
                  ("dist_ivf_bq codes-only", codes_only,
                   ivf_bq.IvfBqSearchParams(n_probes=32), dbq.search_bq,
                   True))
    for name, index, rsp, direct, captured in rank_plans:
        rex = SearchExecutor(res)
        rex.warmup(index, buckets=(16,), k=K, params=rsp)
        (info,) = rex.executable_costs().values()
        c0 = rex.stats.compile_count
        for j in range(3):
            q = queries[16 * j:16 * j + 16 - 3 * j]
            _served_equal(torch, f"rank mesh plan {name} request {j}",
                          rex.search(index, q, K, params=rsp),
                          direct(res, rsp, index, q, K))
        if info["captured"] != captured or rex.stats.compile_count != c0:
            fail(f"meshserve: the rank mesh plan {name} was captured="
                 f"{info['captured']} (want {captured}) or recaptured")
        log(f"[meshserve] rank-engine mesh plan {name} "
            f"({'captured' if captured else 'eager'}): 3 requests equal "
            "the direct search bit for bit, 0 captures after warmup")
        del rex
    state["mesh_executors"] = executors
    out["card"] = state.get("card")
    path = os.path.join("chiprun_out", "meshserve.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"[meshserve] {state.get('card')}: results in {path}")


def _get_url(url: str, data=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_observe(torch, state: dict) -> None:
    """The observability plane over a served run (the module
    docstring)."""
    import tempfile
    import threading

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.core import memwatch, profiling, tracing
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, tiered
    from raft_tpu_torch.serving import (
        BatcherConfig,
        ContinuousCapture,
        ContinuousConfig,
        DriftDetector,
        DynamicBatcher,
        FleetAggregator,
        FlightConfig,
        FlightRecorder,
        IndexGauge,
        LatencyAnomaly,
        MetricsExporter,
        PlacementConfig,
        ShadowConfig,
        ShadowSampler,
        TierManager,
        metrics,
    )
    from raft_tpu_torch.serving.federation import merge_histograms
    from raft_tpu_torch.serving.flight import window_quantile
    from raft_tpu_torch.serving.harness import ManualClock

    res, queries, gt_i = state["res"], state["queries"], state["gt_i"]
    index, flat = state["index"], state["dist_flat"]
    sp = ivf_flat.IvfFlatSearchParams(n_probes=32)
    out = {}
    metrics.reset()
    ex = SearchExecutor(res, probe_accounting=True)
    t0 = time.perf_counter()
    # every plan the batcher can dispatch (its micro-batches hold at most
    # full_batch_rows = 256 rows) captured before the traffic: a miss
    # during a profiler session would wait for the session to end
    ladder = tuple(bk for bk in SERVE_LADDER if bk <= 256)
    for idx in (index, flat):
        ex.warmup(idx, buckets=ladder, k=K, params=sp)
    tmgr = TierManager(tiered.build_tiered(index, hot_fraction=0.5), ex,
                       config=PlacementConfig(), clock=ManualClock())
    ledger = memwatch.MemoryLedger(executor=ex)
    ledger.watch("ivf_flat", index)
    exact = brute_force.build(res, state["x"])
    ex.warmup(exact, buckets=ladder, k=K)
    prof_dir = tempfile.mkdtemp(prefix="observe_")
    b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.002))
    sampler = ShadowSampler(b, exact, ShadowConfig(
        fraction=0.1, seed=state["seed"], timeout_s=None, window_s=1e9))
    det = DriftDetector.from_index(index)
    gauge = IndexGauge(executor=ex, indexes={"ivf_flat": index},
                       sampler=sampler, drift={"ivf_flat": det})
    cont_clock = ManualClock()
    cont = ContinuousCapture(executor=ex, config=ContinuousConfig(
        period_s=5.0, capture_seconds=0.05, duty_cycle_budget=0.01),
        clock=cont_clock, profile_dir=prof_dir)
    exp = MetricsExporter(executor=ex, batcher=b, profile_dir=prof_dir,
                          index_gauge=gauge, memory=ledger, tier=tmgr)
    exp.start()
    log(f"[observe] exporter on {exp.url('/')}: a probe-accounting executor "
        f"(ivf_flat and dist_ivf_flat, n_probes 32, {ex.stats.compile_count}"
        f" plans), TierManager, memory ledger, index gauge; set-up "
        f"{time.perf_counter() - t0:.2f} s")

    # traffic: 4 threads, alternating single-device and mesh requests
    # of 1-40 rows, every one checked against its direct search
    rng = np.random.default_rng(state["seed"] + 17)
    reqs = [(int(m), int(rng.integers(0, N_QUERIES - 40)))
            for m in rng.integers(1, 41, OBSERVE_REQUESTS)]
    from raft_tpu_torch.distributed import ivf as divf

    want = [(divf.search(res, sp, flat, queries[s:s + m], K) if j % 2
             else ivf_flat.search(res, sp, index, queries[s:s + m], K))
            for j, (m, s) in enumerate(reqs)]
    results = [None] * len(reqs)

    def serve(sel):
        def worker(t):
            hs = []
            for j in sel:
                if j % OBSERVE_THREADS != t:
                    continue
                m, s = reqs[j]
                q = queries[s:s + m]
                if j % 2:
                    hs.append((j, b.submit(flat, q, K, params=sp)))
                else:
                    hs.append((j, sampler.submit(index, q, K, params=sp)))
            for j, h in hs:
                results[j] = h.result(timeout=120)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(OBSERVE_THREADS)]
        for th in threads:
            th.start()
        return threads

    # /profile?seconds=1 while the first half of the traffic runs
    half = range(len(reqs) // 2)
    threads = serve(half)
    code, body = _get_url(exp.url("/profile?seconds=1"))
    for th in threads:
        th.join()
    if code != 200:
        fail(f"/profile answered {code}: {body[:200]!r}")
    trace_file = json.loads(body)["trace_file"]
    if trace_file is None or not os.path.exists(trace_file):
        fail("/profile wrote no trace")
    data = profiling.load_trace(trace_file)
    calls = profiling.parse_calls(data)
    ops = profiling.parse_chrome_trace(data)
    attr = profiling.attribute(trace_file, ex.executable_costs())
    served = {c["module"] for c in calls}
    if not served or set(attr.modules) != {
            d for d, info in ex.executable_costs().items()
            if info["hlo_module"] in served}:
        fail("the /profile capture's attribution misses an entry that "
             "served in the window")
    if not any(m.family == "dist_ivf_flat" for m in attr.modules.values()) \
            or not any(m.family == "ivf_flat" for m in attr.modules.values()):
        fail("the /profile window saw no mesh or no single-device entry")
    cats = {}
    for ev in data.get("traceEvents", ()):
        cats[ev.get("cat")] = cats.get(ev.get("cat"), 0) + 1
    annot = {e.get("name") for e in data.get("traceEvents", ())
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("rt_")}
    log(f"[observe] /profile?seconds=1: {os.path.getsize(trace_file)} bytes,"
        f" {len(ops)} device ops, event categories {cats}; {len(calls)} "
        f"timed calls over {len(served)} entries; rt_ annotations from the "
        f"batcher thread seen in the trace: {len(annot)}")
    for digest, m in sorted(attr.modules.items()):
        if m.device_seconds <= 0:
            fail(f"entry {digest} served without measured device time")
        log(f"[observe]   {m.family} {digest}: {m.invocations} calls, "
            f"device {m.device_seconds * 1e3:.3f} ms (CUDA events), the "
            f"trace's kernels {m.trace_seconds * 1e3:.3f} ms "
            f"({len(m.kernel_seconds)} kernel names: "
            f"{sorted(m.kernel_seconds)[:4]}), measured "
            f"{m.measured_gbps():.2f} GB/s over modeled "
            f"{m.modeled_bytes_per_call / 1e6:.2f} MB a call")
    profiling.publish(attr)
    d = metrics.derived()
    log(f"[observe] derived: device_achieved_gbps "
        f"{d['device_achieved_gbps']:.2f} over modeled bytes "
        f"{d['modeled_bytes_total'] / 1e9:.3f} GB total; wall-clock "
        f"achieved_gbps {d['achieved_gbps']:.2f}")
    out["profile"] = dict(device_ops=len(ops), calls=len(calls),
                          categories=cats, annotations=len(annot),
                          modules={dg: m.to_dict()
                                   for dg, m in attr.modules.items()},
                          device_achieved_gbps=d["device_achieved_gbps"])

    # continuous capture: two windows under the 1% budget, each over
    # traffic that runs until both are taken (unchecked: its requests
    # repeat checked ones)
    stop = threading.Event()

    def pump(t):
        j = t
        while not stop.is_set():
            m, s = reqs[j % len(reqs)]
            idx = flat if j % 2 else index
            b.submit(idx, queries[s:s + m], K, params=sp).result(timeout=120)
            j += OBSERVE_THREADS

    pumps = [threading.Thread(target=pump, args=(t,))
             for t in range(OBSERVE_THREADS)]
    for th in pumps:
        th.start()
    time.sleep(0.2)
    snaps = [cont.tick()]
    cont_clock.advance(5.0)
    snaps.append(cont.tick())
    stop.set()
    for th in pumps:
        th.join()
    threads = serve(range(len(reqs) // 2, 3 * len(reqs) // 4))
    for th in threads:
        th.join()
    d = metrics.derived()
    if (any(s is None for s in snaps) or snaps[-1]["windows"] != 2
            or d["rolling_windows"] != 2 or d["rolling_gbps"] <= 0):
        fail("ContinuousCapture did not fold two windows into the rolling "
             "gauges")
    # the second capture was admitted at 1% exactly; a period later the
    # two captures amortize to it again
    duty = cont.duty_cycle(cont_clock.now() + 5.0)
    if duty > 0.01 + 1e-12:
        fail(f"continuous duty cycle {duty:.4f} over its 1% budget")
    log(f"[observe] ContinuousCapture: 2 windows of 0.05 s a 5 s period, "
        f"duty cycle {100 * duty:.2f}% (budget 1%), rolling_gbps "
        f"{d['rolling_gbps']:.2f}, rolling_windows {d['rolling_windows']:.0f}")
    out["continuous"] = dict(duty=duty, rolling_gbps=d["rolling_gbps"])

    # the rest of the traffic, then the scrapes
    threads = serve(range(3 * len(reqs) // 4, len(reqs)))
    for th in threads:
        th.join()
    for j, (g, w) in enumerate(zip(results, want)):
        if g is None:
            fail(f"observe request {j} got no result")
        _served_equal(torch, f"observe request {j}", g, w)
    code, text = _get_url(exp.url("/metrics"))
    text = text.decode()
    need = ("serving_batcher_e2e_seconds_bucket", "index_health_rows",
            "serving_executable_bytes_accessed", "memory_index_resident_bytes")
    if code != 200 or not all(n in text for n in need):
        fail("/metrics misses a family")
    code, body = _get_url(exp.url("/snapshot.json"))
    snap = json.loads(body)
    tid = tracing.span_recorder().spans(name="serving.admission")[-1] \
        .trace_ids[0]
    code2, body2 = _get_url(exp.url(f"/trace.json?trace_id={tid}"))
    spans = [e for e in json.loads(body2)["traceEvents"] if e.get("ph") == "X"]
    if code != 200 or code2 != 200 or not spans:
        fail("/snapshot.json or /trace.json failed")
    for path in ("/memory.json", "/tier.json", "/index.json"):
        if _get_url(exp.url(path))[0] != 200:
            fail(f"{path} did not answer")
    log(f"[observe] {len(reqs)} requests served from {OBSERVE_THREADS} "
        f"threads, each equal to its direct search; /metrics {len(text)} "
        f"bytes, /snapshot.json {len(snap['executables'])} entries, "
        f"/trace.json?trace_id={tid}: {len(spans)} spans; /memory.json, "
        "/tier.json, /index.json 200")

    # shadow recall against brute-force truth
    sampler.pump()
    est = sampler.window.estimate(0.0)
    single_ids = torch.cat([results[j][1] for j in range(0, len(reqs), 2)])
    single_truth = torch.cat([gt_i[s:s + m] for j, (m, s) in enumerate(reqs)
                              if j % 2 == 0])
    measured = recall(single_ids, single_truth)
    log(f"[observe] shadow recall at a 10% sample: {est['estimate']:.4f} "
        f"[{est['ci_low']:.4f}, {est['ci_high']:.4f}] over "
        f"{int(est['trials'])} trials; recall@10 against brute-force truth "
        f"{measured:.4f}")
    if not est["ci_low"] <= measured <= est["ci_high"]:
        fail("the shadow-recall Wilson interval misses the measured recall")
    out["recall"] = dict(est, measured=measured)

    # drift: in-distribution traffic, then queries shifted by one list's
    # centre offset
    gauge.publish()
    base = det.score
    shift = (index.centers[1] - index.centers[0])[None, :]
    scores = {}
    for name, off in (("in_dist", 0.0), ("shifted", shift)):
        for r in range(DRIFT_ROUNDS):
            for j in range(10):
                s0 = 500 * r + 50 * j
                ex.search(index, queries[s0:s0 + 50] + off, K, params=sp)
            gauge.publish()
        scores[name] = det.score
    in_dist, shifted = scores["in_dist"], scores["shifted"]
    log(f"[observe] drift score: {base:.4f} after the served traffic, "
        f"{in_dist:.4f} after in-distribution queries, {shifted:.4f} after "
        "queries shifted by one list's centre offset")
    if not shifted > in_dist:
        fail("the shifted drift score is not higher than the in-distribution"
             " one")
    out["drift"] = dict(in_dist=in_dist, shifted=shifted)

    # the flight recorder, attached while the batcher serves: its latency
    # threshold is the p50 of the served requests just before the attach,
    # below their p99, so the window of the same traffic since the attach
    # fires it on the next scrape, and its capture runs over that traffic
    bounds = tracing.get_histogram(metrics.E2E).snapshot()["bucket_bounds"]

    def e2e_window(n: int) -> list:
        """The E2E histogram's cumulative counts over the next ``n``
        served requests."""
        c0 = tracing.get_histogram(metrics.E2E).snapshot()["bucket_counts"]
        t_end = time.perf_counter() + 60
        while True:
            c1 = tracing.get_histogram(metrics.E2E).snapshot()["bucket_counts"]
            win = [b1 - b0 for b1, b0 in zip(c1, c0)]
            if win[-1] >= n:
                return win
            if time.perf_counter() > t_end:
                fail(f"observe: {win[-1]} of {n} requests served in 60 s")
            time.sleep(0.01)

    stop = threading.Event()
    pumps = [threading.Thread(target=pump, args=(t,))
             for t in range(OBSERVE_THREADS)]
    for th in pumps:
        th.start()
    base = e2e_window(FLIGHT_WINDOW)
    served_p50 = window_quantile(bounds, base, 0.50)
    served_p99 = window_quantile(bounds, base, 0.99)
    if not 0 < served_p50 < served_p99:
        fail(f"observe: served p50 {served_p50} is not below p99 {served_p99}")
    flight = FlightRecorder(executor=ex, batcher=b, config=FlightConfig(
        cooldown_s=1e9, capture_seconds=0.2,
        latency=LatencyAnomaly(p99_threshold_s=served_p50, min_count=8)),
        profile_dir=prof_dir)
    flight.profile_lock = exp._profile_lock
    exp.flight = flight
    e2e_window(FLIGHT_WINDOW)
    _get_url(exp.url("/metrics"))
    stop.set()
    for th in pumps:
        th.join()
    code, body = _get_url(exp.url("/incident.json"))
    if code != 200:
        fail(f"/incident.json answered {code} after a latency anomaly")
    bundle = json.loads(body)
    if bundle["triggers"] != ["latency_anomaly"]:
        fail("the incident was not the latency anomaly")
    if bundle.get("trace_file") is None or bundle.get("attribution") is None:
        fail(f"the incident has no attributed capture: "
             f"{bundle.get('capture_error')}")
    inc_calls = profiling.parse_calls(
        profiling.load_trace(bundle["trace_file"]))
    inc_served = {c["module"] for c in inc_calls}
    inc_modules = bundle["attribution"]["modules"]
    want_modules = {d for d, info in ex.executable_costs().items()
                    if info["hlo_module"] in inc_served}
    if not inc_served or set(inc_modules) != want_modules:
        fail("the incident's attribution does not name the entries that "
             "served during its capture")
    calls_by = sorted((m["family"], m["invocations"])
                      for m in inc_modules.values())
    log(f"[observe] FlightRecorder attached while serving (threshold "
        f"{served_p50 * 1e3:.3f} ms = served p50; served p99 "
        f"{served_p99 * 1e3:.3f} ms): incident {bundle['incident']} "
        f"({bundle['triggers']}) on a scrape, its 0.2 s capture "
        f"attributed to {len(inc_modules)} entries from {len(inc_calls)} "
        f"timed calls {calls_by}")
    out["flight"] = dict(threshold_s=served_p50, served_p99_s=served_p99,
                         calls=len(inc_calls), modules=len(inc_modules))

    # the fleet: two exporters in this process, one replica each
    b.close()
    exp2 = MetricsExporter(executor=ex)
    exp2.start()
    agg = FleetAggregator({"a": exp.url("/snapshot.json"),
                           "b": exp2.url("/snapshot.json")})
    fleet = agg.fleet_snapshot()
    snap_a = json.loads(_get_url(exp.url("/snapshot.json"))[1])
    snap_b = json.loads(_get_url(exp2.url("/snapshot.json"))[1])
    name = "serving.execute.calls"
    total = (snap_a["counters_lifetime"][name]
             + snap_b["counters_lifetime"][name])
    hname = metrics.E2E
    merged = merge_histograms([snap_a["histograms"][hname],
                               snap_b["histograms"][hname]])
    fleet_p99 = fleet["histograms"][hname]["p99"]
    log(f"[observe] FleetAggregator over two exporters: {fleet['healthy']} "
        f"healthy; fleet {name} {fleet['counters'][name]:.0f} = "
        f"{snap_a['counters_lifetime'][name]:.0f} + "
        f"{snap_b['counters_lifetime'][name]:.0f}; fleet e2e p99 "
        f"{fleet_p99 * 1e3:.3f} ms (the merged histogram's "
        f"{merged['p99'] * 1e3:.3f} ms)")
    if fleet["counters"][name] != total or fleet_p99 != merged["p99"]:
        fail("the fleet counters or p99 differ from the replicas'")
    exp2.close()

    # the memory profile around an extend
    code, body = _get_url(exp.url("/memory_profile"))
    if code != 200:
        fail(f"/memory_profile answered {code}")
    seq = json.loads(body)["seq"]
    grown = ivf_flat.extend(res, index, state["x"][:100_000],
                            torch.arange(N_ROWS, N_ROWS + 100_000,
                                         dtype=torch.int32,
                                         device=res.device))
    torch.cuda.synchronize()
    code, body = _get_url(exp.url(f"/memory_profile?diff={seq}"))
    diff = json.loads(body)["diff"]
    top = diff["deltas"][:3]
    log(f"[observe] memory profile around ivf_flat.extend(100,000 rows): "
        f"{diff['total_delta_bytes'] / 2**20:.1f} MiB more allocated; top "
        f"groups {[(t['label'], t['delta_bytes']) for t in top]}")
    if not any("ivf_flat.py" in t["label"] and t["delta_bytes"] > 0
               for t in diff["deltas"]):
        fail("the memory-profile diff does not show the extend's allocation")
    del grown
    exp.close()
    import shutil

    shutil.rmtree(prof_dir, ignore_errors=True)
    out["card"] = state.get("card")
    path = os.path.join("chiprun_out", "observe.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    log(f"[observe] {state.get('card')}: results in {path}")


# fleet: planner deltas on a live tiered replica, the router surfaces
FLEET_REQUESTS = 240
FLEET_EPOCHS = 4
FLEET_SWAP_WIDTH = 8
FLEET_N_PROBES = 32


def phase_fleet(torch, state: dict) -> None:
    """The fleet layer on the card (the module docstring): a tiered
    replica rebalanced by the planner's deltas while it serves, then the
    router's HTTP surfaces and merge_fanout on device tensors."""
    import threading

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.fleet import (
        FleetPlanConfig,
        FleetPlanner,
        QueryRouter,
        RoutingTable,
        make_fleet,
        merge_fanout,
        plan_fleet,
    )
    from raft_tpu_torch.neighbors import ivf_flat, tiered
    from raft_tpu_torch.serving import (
        BatcherConfig,
        DynamicBatcher,
        FleetAggregator,
        IndexGauge,
        MetricsExporter,
    )

    res, queries, index = state["res"], state["queries"], state["index"]
    out = {}
    t0 = time.perf_counter()
    t = tiered.build_tiered(index, hot_fraction=0.5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp = tiered.TieredSearchParams(n_probes=FLEET_N_PROBES)
    direct_sp = ivf_flat.IvfFlatSearchParams(n_probes=FLEET_N_PROBES)
    # replica "a" serves the live tiered index; replica "b" is a second
    # executor over it, so the federation merges two probe planes of one
    # label
    ex = SearchExecutor(res, probe_accounting=True)
    ex_b = SearchExecutor(res, probe_accounting=True)
    t0 = time.perf_counter()
    ex.warmup(t, buckets=SERVE_LADDER, k=K, params=sp)
    ex_b.warmup(t, buckets=(64,), k=K, params=sp)
    warm_s = time.perf_counter() - t0
    exp_a = MetricsExporter(executor=ex, index_gauge=IndexGauge(ex))
    exp_b = MetricsExporter(executor=ex_b, index_gauge=IndexGauge(ex_b))
    exp_a.start()
    exp_b.start()
    agg = FleetAggregator({"a": exp_a.url("/snapshot.json"),
                           "b": exp_b.url("/snapshot.json")})
    planner = FleetPlanner(agg, label=ex.probe_label(t),
                           config=FleetPlanConfig(
                               fallback_slots=int(t.hot_lists.size),
                               max_swaps=FLEET_SWAP_WIDTH))
    rng = np.random.default_rng(state["seed"] + 31)
    g = torch.Generator(device=res.device)
    g.manual_seed(state["seed"] + 31)
    # skewed traffic: most requests near the centers of a few cold lists
    hot_pool = t.cold_lists[:16]
    centers = index.centers[torch.as_tensor(hot_pool, device=res.device,
                                            dtype=torch.int64)]
    reqs = []
    for j in range(FLEET_REQUESTS):
        m = int(rng.integers(1, 41))
        if j % 4:
            c = centers[torch.as_tensor(rng.integers(0, len(hot_pool), m),
                                        device=res.device)]
            reqs.append(c + 0.05 * torch.randn(c.shape, device=res.device,
                                               generator=g))
        else:
            s0 = int(rng.integers(0, N_QUERIES - m))
            reqs.append(queries[s0:s0 + m])
    want = [ivf_flat.search(res, direct_sp, index, q, K) for q in reqs]
    ex_b.search(t, torch.cat(reqs[:16])[:64], K, params=sp)
    torch.cuda.synchronize()
    c0 = ex.stats.compile_count
    swaps0 = tracing.get_counter("tier.swap_bytes")
    reset_launches()
    results = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    epochs = []
    moved = 0
    with DynamicBatcher(ex, BatcherConfig(max_wait_s=0.002)) as b:
        def worker(w):
            for j in range(w, len(reqs), OBSERVE_THREADS):
                t1 = time.perf_counter()
                results[j] = b.submit(t, reqs[j], K, params=sp).result(
                    timeout=120)
                lat[j] = time.perf_counter() - t1

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(OBSERVE_THREADS)]
        for th in threads:
            th.start()
        for e in range(FLEET_EPOCHS):
            time.sleep(0.05)
            agg.scrape()
            table = planner.plan()
            delta = planner.deltas({"a": t.hot_lists.tolist()})["a"]
            t1 = time.perf_counter()
            nbytes = tiered.apply_plan(t, list(delta.promotions),
                                       list(delta.demotions),
                                       FLEET_SWAP_WIDTH, executor=ex)
            epochs.append(dict(version=table.version,
                               swaps=len(delta.promotions), bytes=nbytes,
                               ms=(time.perf_counter() - t1) * 1e3))
            moved += len(delta.promotions)
        for th in threads:
            th.join()
    torch.cuda.synchronize()
    counts = read_launches(("tier_scan",), "fleet")
    launches = state.setdefault("launches", {})
    launches["tier_scan"] = launches.get("tier_scan", 0) + counts["tier_scan"]
    for j, (g, w) in enumerate(zip(results, want)):
        if g is None:
            fail(f"fleet request {j} got no result")
        _served_equal(torch, f"fleet request {j}", g, w)
    if ex.stats.compile_count != c0:
        fail(f"fleet: {ex.stats.compile_count - c0} captures after warmup")
    if moved == 0:
        fail("fleet: the planner's deltas moved no list")
    swap_bytes = tracing.get_counter("tier.swap_bytes") - swaps0
    p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
    log(f"[fleet] tiered replica (hot_fraction 0.5, build {build_s:.2f} s, "
        f"ladder {SERVE_LADDER[0]}..{SERVE_LADDER[-1]} of eager plans "
        f"warmed in {warm_s:.3f} s) behind a DynamicBatcher from {OBSERVE_THREADS} "
        f"threads: {len(reqs)} requests of 1-40 rows (n_probes "
        f"{FLEET_N_PROBES}, 3 in 4 at 16 cold lists' centers) each equal "
        f"to the all-device IVF-Flat search bit for bit through "
        f"{FLEET_EPOCHS} planner epochs over a FleetAggregator of two "
        f"exporters: {moved} lists moved, epoch ms "
        f"{[round(e['ms'], 3) for e in epochs]}, swap bytes {swap_bytes:.0f}"
        f"; 0 captures after warmup; tier_scan launched "
        f"{counts['tier_scan']} times; served p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms (host clock)")
    out["rebalance"] = dict(build_s=build_s, warm_s=warm_s,
                            requests=len(reqs), epochs=epochs, moved=moved,
                            swap_bytes=swap_bytes,
                            tier_scan_launches=counts["tier_scan"],
                            p50_ms=p50, p99_ms=p99)
    exp_a.close()
    exp_b.close()
    del t, ex, ex_b

    # the router: a 4-replica harness behind an exporter
    h = make_fleet(4)
    router = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                         clock=h.clock)
    exp = MetricsExporter(route=router)
    exp.start()
    codes = {"before": _get_url(exp.url("/route.json"))[0]}
    plan_table = plan_fleet(np.ones(h.executor.n_lists, np.int64),
                            {n: None for n in h.replicas}, label="fleet",
                            version=1)
    codes["push_v1"] = _get_url(exp.url("/push?route=1"),
                                plan_table.to_bytes())[0]
    code, body = _get_url(exp.url("/route.json"))
    codes["route_json"] = code
    table = RoutingTable.from_json(json.loads(body))
    newer = dataclasses.replace(plan_table, version=2)
    codes["push_v2"] = _get_url(exp.url("/push?route=1"),
                                newer.to_bytes())[0]
    codes["push_stale"] = _get_url(exp.url("/push?route=1"),
                                   plan_table.to_bytes())[0]
    for start in (0, 40):
        router.route(h.make_queries(8, start), K)
    metrics_text = _get_url(exp.url("/metrics"))[1].decode()
    exp.close()
    if (codes != {"before": 404, "push_v1": 200, "route_json": 200,
                  "push_v2": 200, "push_stale": 409}
            or table != plan_table or "fleet_route_" not in metrics_text):
        fail(f"fleet: the router's HTTP surfaces answered {codes}")
    # merge_fanout: CUDA-tensor parts merge as the numpy parts do
    q = h.make_queries(64, 5)
    lids = h.resolve_probes(q)
    parts = [h.executor.scan_lists(q, lids[j::3], K) for j in range(3)]
    cuda_parts = [(torch.as_tensor(d, device=res.device),
                   torch.as_tensor(i, device=res.device)) for d, i in parts]
    for wire in ("f32", "bf16"):
        gd, gi = merge_fanout(cuda_parts, K, wire_dtype=wire)
        wd, wi = merge_fanout(parts, K, wire_dtype=wire)
        if gd.device != cuda_parts[0][0].device or not (
                torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi)):
            fail(f"fleet: merge_fanout of CUDA parts differs on the {wire} "
                 "wire")
    log(f"[fleet] QueryRouter over a 4-replica harness behind an exporter: "
        f"/route.json {codes['before']} before a table, then push "
        f"{codes['push_v1']}, /route.json {codes['route_json']}, a newer "
        f"push {codes['push_v2']}, a stale push {codes['push_stale']}; "
        "fleet_route_* in /metrics; merge_fanout of CUDA-tensor parts "
        "equals the numpy-part merge on the f32 and bf16 wires")
    out["router"] = codes
    out["card"] = state.get("card")
    path = os.path.join("chiprun_out", "fleet.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"[fleet] {state.get('card')}: results in {path}")


# prims: the primitives on the card — single-linkage on a 100,000-row
# kNN graph built by fused_knn, spectral partitioning of that graph,
# linear assignment, SPLADE-shaped sparse kNN, and a sweep of every other
# public function of the primitive modules against its CPU run
PRIMS_ROWS = 100_000      # make_blobs rows: a cut from 1M for the time limit
PRIMS_DIM = 128           # SIFT's width
PRIMS_BLOBS = 16
PRIMS_K = 15
LAP_N = 2048
SPLADE = dict(cols=30109, rows=100_000, queries=1000, doc_nnz=120,
              query_nnz=49, check=100)
BLOBS_1M = 1_000_000


def _components(n, src, dst):
    """scipy's connected components of the graph of the edges (src, dst)."""
    import scipy.sparse
    import scipy.sparse.csgraph

    a = scipy.sparse.coo_matrix((np.ones(len(src)), (src, dst)),
                                shape=(n, n))
    return scipy.sparse.csgraph.connected_components(a, directed=False)


def _same_partition(a, b) -> bool:
    """Two labelings name the same classes (a bijection between them)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    pairs = np.unique(a * (int(b.max()) + 1) + b)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def _host_edges(result):
    """(src, dst, weights) of an MSTResult's emitted edges, ordered as
    single_linkage orders them (stable, by weight)."""
    src = result.src.cpu().numpy()
    keep = src >= 0
    src = src[keep]
    dst = result.dst.cpu().numpy()[keep]
    w = result.weights.cpu().numpy()[keep]
    order = np.argsort(w, kind="stable")
    return src[order], dst[order], w[order]


def prims_knn_check(torch, res, x, k: int, metric) -> dict:
    """single_linkage's kNN search held against fused_knn_plain at the
    path's own call: knn_graph's ``brute_force.knn(x, x, k + 1)``, which
    the search runs in FUSED_MAX_QUERIES-row blocks (the last one ragged),
    checked on its first, middle and last block. A slot's tolerance is
    the kernels phase's 1e-4 (1 + |d|), or where larger the change in the
    root that an error of 2^-18 (|q|^2 + |x|^2) in the expanded square
    makes: that is larger only where the distance is small against the
    norms, at a row's match with itself. Each returned distance is within
    its tolerance of the plain version's and of the float64 distance of
    its own id; where the ids differ, the two ids' float64 distances are
    a tie within that tolerance."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.fused_topk import fused_knn_plain

    if metric.name != "L2SqrtExpanded":
        fail(f"prims: the kNN check takes L2SqrtExpanded, not {metric.name}")
    n = x.shape[0]
    bs = brute_force.FUSED_MAX_QUERIES
    t0 = time.perf_counter()
    index = brute_force.build(res, x, metric)
    gd, gi = brute_force.search(res, index, x, k + 1)
    torch.cuda.synchronize()
    starts = sorted({0, n // bs // 2 * bs, (n - 1) // bs * bs})
    x64 = x.double()
    err = self_err = 0.0
    ties = 0
    for s in starts:
        rows = torch.arange(s, min(s + bs, n), device=x.device)
        wd, wi = fused_knn_plain(x[rows], x, k + 1, metric,
                                 dataset_norms=index.norms)
        d, i = gd[rows], gi[rows]
        if d.shape != wd.shape or bool((i < 0).any()):
            fail(f"prims: knn block at row {s}: shape {tuple(d.shape)}, "
                 f"{int((i < 0).sum())} unfilled slots")
        q2 = index.norms[rows][:, None]

        def room(dist, ids):
            e = 2.0 ** -18 * (q2 + index.norms[ids.long()])
            return torch.minimum(e.sqrt(), e / (dist + wd).clamp_min(1e-30))

        tol = torch.maximum(1e-4 * (1.0 + wd.abs()), room(d, i))
        diff = (d - wd).abs()
        exact64 = (x64[i.long()] - x64[rows][:, None]).norm(dim=2)
        if bool((diff > tol).any()) or bool(
                ((d.double() - exact64).abs() > tol).any()):
            fail(f"prims: knn block at row {s}: distances off the plain "
                 f"version by {float(diff.max()):.3g} or off float64 by "
                 f"{float((d.double() - exact64).abs().max()):.3g}, beyond "
                 "the slot's tolerance")
        other = i != wi
        want64 = (x64[wi.long()] - x64[rows][:, None]).norm(dim=2)
        if bool(((exact64 - want64).abs() > tol)[other].any()):
            fail(f"prims: knn block at row {s}: "
                 f"{int(other.sum())} ids differ from the plain version "
                 "beyond ties")
        ties += int(other.sum())
        own = wi == rows[:, None]
        err = max(err, float(diff[~own].max()))
        self_err = max(self_err, float(diff[own].max()) if bool(own.any())
                       else 0.0)
    check_s = time.perf_counter() - t0
    log(f"[prims] knn_graph's search (brute_force.knn, {n} x {n}, k+1 = "
        f"{k + 1}, {metric.name}, {-(-n // bs)} blocks of {bs}) held against "
        f"fused_knn_plain on the blocks at rows {starts}: max |dd| {err:.3g} "
        f"(tolerance 1e-4 (1 + |d|)), {self_err:.3g} at the rows' matches "
        f"with themselves (tolerance the root of 2^-18 (|q|^2 + |x|^2)), "
        f"{ties} ids differ at ties; {check_s:.3f} s")
    return dict(blocks=starts, max_abs_err=err, self_max_abs_err=self_err,
                ties=ties, seconds=check_s)


def prims_single_linkage(torch, res, x, y, n_clusters: int, k: int,
                         state: dict) -> dict:
    """single_linkage on (x, y): its kNN search against the plain
    version; the first MST forest (knn_graph, coo_symmetrize, mst once,
    timed) against scipy's MST of the same graph; the tree that spectral
    partitioning joins to the graph (the module's own connect loop); then
    the counted user call: its dendrogram one binary tree over the n
    points, its labels scipy's components of the dendrogram's first
    n - n_clusters merges (the tree less its n_clusters - 1 heaviest
    edges), and its ARI against y."""
    import importlib

    import scipy.sparse
    import scipy.sparse.csgraph

    from raft_tpu_torch import stats
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.sparse import convert, linalg, neighbors, solver

    metric = DistanceType.L2SqrtExpanded
    sl_mod = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    n = x.shape[0]
    knn = prims_knn_check(torch, res, x, k, metric)
    # the first forest against scipy's MST of the same symmetrized graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = neighbors.knn_graph(res, x, k, metric)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sym = linalg.coo_symmetrize(g)
    first = solver.mst(res, convert.coo_to_csr(sym))
    mst_s = time.perf_counter() - t0
    keep = (sym.rows >= 0).cpu().numpy()
    a = scipy.sparse.coo_matrix(
        (sym.vals.cpu().numpy()[keep].astype(np.float64),
         (sym.rows.cpu().numpy()[keep], sym.cols.cpu().numpy()[keep])),
        shape=(n, n)).tocsr()
    want_w = float(scipy.sparse.csgraph.minimum_spanning_tree(a).sum())
    n_comp, _ = scipy.sparse.csgraph.connected_components(a, directed=False)
    fs, _, fw = _host_edges(first)
    got_w = float(fw.astype(np.float64).sum())
    rel = abs(got_w - want_w) / want_w
    if rel > 1e-5 or len(fs) != n - n_comp:
        fail(f"prims: the first MST forest weighs {got_w} with {len(fs)} "
             f"edges, scipy's {want_w} with {n - n_comp} (rel {rel:.3g})")
    if n_comp < 2:
        fail("prims: the kNN graph is connected: cross_component_nn would "
             "never run")
    # the user API returns no tree edges: the spectral graph takes them
    # from the module's own kNN-graph-to-tree step
    t0 = time.perf_counter()
    final = sl_mod._mst_edges_connected(res, x, k, metric)
    tree_s = time.perf_counter() - t0
    src, dst, _ = _host_edges(final)
    t0 = time.perf_counter()
    sl_mod._dendrogram(src, dst, n)
    sl_mod._flat_labels(src, dst, n, n_clusters)
    dendro_s = time.perf_counter() - t0

    # the user call, counted
    rounds0 = _counter("cluster.single_linkage.connect_rounds")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = single_linkage(res, x, n_clusters, metric=metric, k=k)
    total_s = time.perf_counter() - t0
    counts = read_launches(("fused_knn",), "prims single-linkage")
    launches = state.setdefault("launches", {})
    launches["fused_knn"] = launches.get("fused_knn", 0) \
        + counts["fused_knn"]
    rounds = int(_counter("cluster.single_linkage.connect_rounds") - rounds0)
    if rounds < 1:
        fail("prims: single_linkage ran no connect round")
    # one binary tree over the n points: every id but the root's is a
    # child exactly once, each step's children made before it
    ch = np.asarray(out.children, np.int64)
    step = np.arange(n - 1)
    if ch.shape != (n - 1, 2) or int(out.sizes[-1]) != n \
            or not np.array_equal(np.sort(ch.reshape(-1)),
                                  np.arange(2 * n - 2)) \
            or bool((ch.max(axis=1) >= n + step).any()) \
            or bool((np.diff(out.deltas) < 0).any()):
        fail("prims: single_linkage's dendrogram is not one tree over the "
             "points merged in weight order")
    m = n - n_clusters
    _, cc = _components(2 * n - 1, np.concatenate([ch[:m, 0], ch[:m, 1]]),
                        np.concatenate([n + step[:m], n + step[:m]]))
    if not _same_partition(out.labels, cc[:n]) \
            or len(np.unique(out.labels)) != n_clusters:
        fail("prims: single_linkage's labels are not the components of the "
             f"tree less its {n_clusters - 1} heaviest edges")
    ari = float(stats.adjusted_rand_index(
        res, torch.as_tensor(out.labels, device=res.device), y))
    log(f"[prims] single_linkage n={n} d={x.shape[1]} k={k} "
        f"{metric.name} n_clusters={n_clusters}: knn_graph {knn_s:.3f} s, "
        f"first MST {mst_s:.3f} s (forest of {n_comp} trees, weight "
        f"{got_w:.6g} vs scipy {want_w:.6g}, rel {rel:.2e}), kNN graph to "
        f"one tree {tree_s:.3f} s, dendrogram and flat cut {dendro_s:.3f} "
        f"s; the user call {total_s:.3f} s, {rounds} connect rounds "
        f"(fused_knn launched {counts['fused_knn']} times), one dendrogram "
        f"tree, labels = scipy components of the tree less its "
        f"{n_clusters - 1} heaviest edges, ARI against make_blobs' labels "
        f"{ari:.6f}")
    return dict(graph=dict(g=g, final=final), rec=dict(
        n=n, knn_check=knn, knn_graph_s=knn_s, mst_s=mst_s,
        connect_rounds=rounds, tree_s=tree_s, dendrogram_s=dendro_s,
        total_s=total_s, forest_trees=int(n_comp), forest_weight=got_w,
        scipy_weight=want_w, fused_knn_launches=counts["fused_knn"],
        ari=ari))


def _counter(name: str) -> float:
    from raft_tpu_torch.core import tracing

    return tracing.get_counter(name)


def prims_spectral(torch, res, graph: dict, y, n_clusters: int,
                   seed: int) -> dict:
    """spectral.partition on the unit-weight symmetrized kNN graph joined
    with the final MST's edges; lanczos_smallest(k = n_clusters + 1) on
    its Laplacian held to what every correct run satisfies."""
    import scipy.sparse

    from raft_tpu_torch import spectral, stats
    from raft_tpu_torch.sparse import convert, linalg, solver
    from raft_tpu_torch.sparse.types import COO

    g, final = graph["g"], graph["final"]
    n = g.shape[0]
    e = final.src >= 0
    fs, fd = final.src[e], final.dst[e]
    unit = COO(torch.cat([g.rows, fs, fd]), torch.cat([g.cols, fd, fs]),
               torch.ones(g.nnz + 2 * fs.shape[0], device=res.device),
               (n, n))
    adj = convert.coo_to_csr(linalg.coo_symmetrize(unit, torch.ones_like))
    lap = linalg.laplacian(adj)
    k = n_clusters + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev, vec = solver.lanczos_smallest(res, lap, k, seed=seed)
    torch.cuda.synchronize()
    lanczos_s = time.perf_counter() - t0
    evh = ev.cpu().double().numpy()
    v = vec.cpu().double().numpy()
    if not (np.all(np.diff(evh) >= 0) and evh.min() >= -1e-5
            and evh.max() <= 2 + 1e-5):
        fail(f"prims: Lanczos eigenvalues {evh} not ascending in [0, 2]")
    orth = float(np.abs(v.T @ v - np.eye(k)).max())
    if orth > 1e-3:
        fail(f"prims: Ritz vectors orthonormal only within {orth:.3g}")
    keep = (lap.row_ids() >= 0).cpu().numpy()
    lap64 = scipy.sparse.csr_matrix(
        (lap.data.cpu().numpy()[keep].astype(np.float64),
         lap.indices.cpu().numpy()[keep], lap.indptr.cpu().numpy()),
        shape=(n, n))
    lv = lap64 @ v
    rq = np.sum(v * lv, axis=0)
    rq_err = float(np.abs(rq - evh).max())
    if rq_err > 1e-4:
        fail(f"prims: Rayleigh quotients {rq_err:.3g} from their eigenvalues")
    resid = np.linalg.norm(lv - v * evh[None, :], axis=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, evals, emb = spectral.partition(res, adj, n_clusters, seed=seed)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    q = float(spectral.modularity(res, adj, labels))
    ari = float(stats.adjusted_rand_index(res, labels, y))
    if labels.device.type != res.device.type \
            or emb.shape != (n, n_clusters) \
            or not bool(torch.isfinite(emb).all()):
        fail("prims: spectral.partition's outputs are malformed")
    log(f"[prims] spectral: adjacency {n} nodes, {int(adj.indptr[-1])} "
        f"stored edges (unit weights); lanczos_smallest k={k} "
        f"{lanczos_s:.3f} s: eigenvalues {np.round(evh, 6).tolist()}, "
        f"ascending in [0, 2], Ritz vectors orthonormal within {orth:.2e}, "
        f"Rayleigh quotients within {rq_err:.2e} (float64), residuals "
        f"||Lv - lv|| {np.round(resid, 5).tolist()}; partition "
        f"{n_clusters} clusters {part_s:.3f} s: modularity {q:.6f}, ARI "
        f"against make_blobs' labels {ari:.6f}")
    return dict(lanczos_s=lanczos_s, eigenvalues=evh.tolist(),
                orthonormal=orth, rayleigh_err=rq_err,
                residuals=resid.tolist(), partition_s=part_s,
                modularity=q, ari=ari)


def prims_lap(torch, res, seed: int, n: int) -> dict:
    """linear_assignment on integer costs in [0, 1000): the total equal
    to scipy's exactly."""
    import scipy.optimize

    from raft_tpu_torch.solver import linear_assignment

    cost = np.random.default_rng(seed + 17).integers(
        0, 1000, (n, n)).astype(np.float32)
    p0 = _counter("solver.lap.phases")
    i0 = _counter("solver.lap.iterations")
    c = torch.as_tensor(cost, device=res.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assign, total = linear_assignment(res, c)
    torch.cuda.synchronize()
    lap_s = time.perf_counter() - t0
    phases = int(_counter("solver.lap.phases") - p0)
    iters = int(_counter("solver.lap.iterations") - i0)
    t0 = time.perf_counter()
    ri, ci = scipy.optimize.linear_sum_assignment(cost)
    scipy_s = time.perf_counter() - t0
    want = float(cost[ri, ci].astype(np.float64).sum())
    a = assign.cpu().numpy()
    if sorted(a.tolist()) != list(range(n)) or float(total) != want \
            or float(cost[np.arange(n), a].astype(np.float64).sum()) != want:
        fail(f"prims: linear_assignment total {float(total)} != scipy's "
             f"{want}")
    cut = "" if n == LAP_N else f" (cut from {LAP_N} for time)"
    log(f"[prims] linear_assignment n={n}{cut}: total {float(total):.0f} = "
        f"scipy's, {phases} eps-phases, {iters} bidding rounds, "
        f"{lap_s:.3f} s (scipy on the host {scipy_s:.3f} s)")
    return dict(n=n, total=want, phases=phases, iterations=iters,
                seconds=lap_s, scipy_s=scipy_s)


def splade_rows(torch, g, rows: int, cols: int, nnz: int):
    """(indptr, indices, data) on the generator's device: ``rows`` rows of
    about ``nnz`` distinct columns each, drawn with a power-law column
    popularity (SPLADE's term skew), integer values 1..8."""
    dev = g.device
    pop = torch.randperm(cols, generator=g, device=dev)
    p = 1.0 / (torch.arange(cols, device=dev, dtype=torch.float64) + 10.0
               ) ** 0.8
    cdf = torch.cumsum(p, 0) / p.sum()
    u = torch.rand(rows * nnz, generator=g, device=dev, dtype=torch.float64)
    col = pop[torch.searchsorted(cdf, u).clamp(max=cols - 1)]
    key = torch.unique(torch.arange(rows, device=dev).repeat_interleave(nnz)
                       * cols + col)                       # sorted
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(key // cols, minlength=rows), 0)
    data = torch.randint(1, 9, (key.numel(),), generator=g, device=dev
                         ).to(torch.float32)
    return indptr, (key % cols).to(torch.int32), data


def prims_sparse_knn(torch, res, seed: int, cols: int, rows: int,
                     queries: int, doc_nnz: int, query_nnz: int,
                     check: int) -> dict:
    """sparse.neighbors.brute_force_knn on the BigANN'23 sparse track's
    shape (inner product, k 10): ids against the top-10 of a float64
    scipy.sparse product of ``check`` of the queries, ties by the
    smaller id."""
    import scipy.sparse

    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.sparse import CSR
    from raft_tpu_torch.sparse.neighbors import brute_force_knn

    t0 = time.perf_counter()
    g = torch.Generator(device=res.device)
    g.manual_seed(seed + 23)
    db = CSR.from_numpy(*splade_rows(torch, g, rows, cols, doc_nnz),
                        (rows, cols), device=res.device)
    q = CSR.from_numpy(*splade_rows(torch, g, queries, cols, query_nnz),
                       (queries, cols), device=res.device)
    dip, dind, ddat = (t.cpu().numpy() for t in (db.indptr, db.indices,
                                                 db.data))
    qip, qind, qdat = (t.cpu().numpy() for t in (q.indptr, q.indices,
                                                 q.data))
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, i = brute_force_knn(res, db, q, K, DistanceType.InnerProduct)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    sel = np.arange(0, queries, queries // check)[:check]
    dmat = scipy.sparse.csr_matrix((ddat.astype(np.float64), dind, dip),
                                   shape=(rows, cols))
    qmat = scipy.sparse.csr_matrix((qdat.astype(np.float64), qind, qip),
                                   shape=(queries, cols))[sel]
    t0 = time.perf_counter()
    scores = dmat @ qmat.toarray().T                     # (rows, check)
    want = np.argsort(-scores, axis=0, kind="stable")[:K].T
    ref_s = time.perf_counter() - t0
    got = i.cpu().numpy()[sel]
    gd = d.cpu().numpy()[sel]
    want_s = np.take_along_axis(scores.T, want, axis=1)
    got_s = np.take_along_axis(scores.T, got.astype(np.int64), axis=1)
    if not (np.array_equal(got_s, want_s) and np.array_equal(gd, want_s)):
        fail("prims: sparse brute_force_knn scores differ from the float64 "
             "product's top-10")
    differ = int((got != want).sum())
    if differ:
        fail(f"prims: sparse brute_force_knn ids differ from the float64 "
             f"product's at {differ} places of equal score")
    log(f"[prims] sparse brute_force_knn (SPLADE shape: {rows} x {cols} "
        f"docs, {int(dip[-1])} nonzeros ({dip[-1] / rows:.1f} a row); "
        f"{queries} queries ({qip[-1] / queries:.1f} a row); inner product, "
        f"k {K}; rows cut from 8.8M to {rows}, queries to {queries}; data "
        f"{data_s:.2f} "
        f"s): {knn_s:.3f} s on the card; {check} queries' ids equal the "
        f"float64 scipy product's top-10, ties by the smaller id "
        f"(scipy {ref_s:.2f} s)")
    return dict(rows=rows, nnz=int(dip[-1]), queries=queries, seconds=knn_s,
                checked=check)


def _leaves(obj) -> list:
    """The arrays and numbers of an output, in a fixed order."""
    import torch

    if isinstance(obj, (torch.Tensor, np.ndarray, float, int, bool,
                        np.generic)):
        return [obj]
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in _leaves(o)]
    raise TypeError(f"no leaves in {type(obj)}")


def _host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _moments_agree(a: np.ndarray, b: np.ndarray) -> bool:
    """Two samples' means and variances within 5 standard errors."""
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    if abs(a.mean() - b.mean()) > 5 * se + 1e-9:
        return False

    def var_se(x):
        c = x - x.mean()
        return np.sqrt(max(np.mean(c ** 4) - np.mean(c ** 2) ** 2, 0.0)
                       / x.size)

    return abs(a.var() - b.var()) <= 5 * np.hypot(var_se(a), var_se(b)) \
        + 1e-9


def sweep_equal(torch, name: str, got, want, tol, device) -> float:
    """A card output against the CPU run's: every tensor of the card's on
    the card; ``tol`` "exact", "dist" (samples of one distribution),
    "sign" (columns up to sign, atol 1e-4) or (rtol, atol). Returns the
    largest |difference| (0 for "dist")."""
    gl, wl = _leaves(got), _leaves(want)
    if len(gl) != len(wl):
        fail(f"prims sweep {name}: {len(gl)} outputs vs {len(wl)} on the CPU")
    worst = 0.0
    for g, w in zip(gl, wl):
        if isinstance(g, torch.Tensor) and g.device.type != device.type:
            fail(f"prims sweep {name}: an output left the card "
                 f"({g.device})")
        g, w = _host(g), _host(w)
        if g.shape != w.shape:
            fail(f"prims sweep {name}: shape {g.shape} vs {w.shape}")
        if tol == "dist":
            if g.dtype == np.bool_:
                g, w = g.astype(np.float64), w.astype(np.float64)
            if not _moments_agree(g, w):
                fail(f"prims sweep {name}: the card's draws' moments "
                     "differ from the CPU's beyond 5 standard errors")
            continue
        if g.dtype.kind in "biu" and tol != "exact" and tol != "sign":
            g, w = g.astype(np.float64), w.astype(np.float64)
        if tol == "exact" or g.dtype.kind in "bO":
            if not np.array_equal(g, w):
                fail(f"prims sweep {name}: differs from the CPU run")
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if tol == "sign":
            if g64.ndim == 2:
                g64 = g64 * np.where(np.sum(g64 * w64, axis=0) < 0, -1.0,
                                     1.0)[None, :]
            rtol, atol = 1e-4, 1e-4
        else:
            rtol, atol = tol
        fin = np.isfinite(w64)
        if not np.array_equal(fin, np.isfinite(g64)) \
                or not np.array_equal(g64[~fin], w64[~fin]):
            fail(f"prims sweep {name}: non-finite entries differ")
        err = np.abs(g64[fin] - w64[fin])
        if err.size:
            worst = max(worst, float(err.max()))
            if bool((err > atol + rtol * np.abs(w64[fin])).any()):
                fail(f"prims sweep {name}: |difference| {err.max():.3g} "
                     f"beyond rtol {rtol} / atol {atol}")
    return worst


def sweep_cases(torch, seed: int) -> list:
    """(name, fn(res) -> output, tolerance) for every public function of
    the primitive modules but the phase's own entries, on small inputs
    made from ``seed`` (integer-valued where a product is taken, so the
    two devices' different summation orders round alike)."""
    import importlib

    from raft_tpu_torch import label, linalg, matrix, random, spectral, stats
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.core import operators as op
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.solver import (
        LinearAssignmentProblem,
        linear_assignment,
    )
    from raft_tpu_torch.sparse import COO, CSR, convert, neighbors, ops
    from raft_tpu_torch.sparse import distance as sdist
    from raft_tpu_torch.sparse import linalg as slin
    from raft_tpu_torch.sparse import solver
    from raft_tpu_torch.stats.metrics import ICType

    logger = importlib.import_module("raft_tpu_torch.core.logger")
    rng = np.random.default_rng(seed + 29)
    EX = "exact"
    F = (1e-5, 1e-5)          # elementwise float32
    P = (1e-4, 1e-4)          # float products, reductions, solvers
    ai = rng.integers(-4, 5, (24, 16)).astype(np.float32)
    bi = rng.integers(-4, 5, (16, 12)).astype(np.float32)
    ci = rng.integers(-4, 5, (24, 12)).astype(np.float32)
    af = rng.standard_normal((24, 16)).astype(np.float32)
    bf = rng.standard_normal((24, 16)).astype(np.float32)
    pos = np.abs(af) + 0.5
    vec16 = rng.integers(-3, 4, 16).astype(np.float32)
    vec24 = rng.integers(-3, 4, 24).astype(np.float32)
    keys24 = rng.integers(0, 5, 24).astype(np.int32)
    keys16 = rng.integers(0, 4, 16).astype(np.int32)
    spd = (af.T @ af + 16 * np.eye(16)).astype(np.float32)
    chol = np.linalg.cholesky(spd).astype(np.float32)
    lab_a = rng.integers(0, 4, 200).astype(np.int32)
    lab_b = np.where(rng.random(200) < 0.8, lab_a,
                     rng.integers(0, 5, 200)).astype(np.int32)
    blobs = (rng.integers(-20, 20, (4, 6))[rng.integers(0, 4, 120)]
             + rng.integers(-2, 3, (120, 6))).astype(np.float32)
    blob_lab = rng.integers(0, 4, 120).astype(np.int32)
    dense_s = (rng.integers(1, 5, (30, 20))
               * (rng.random((30, 20)) < 0.2)).astype(np.float32)
    dense_t = (rng.integers(1, 5, (20, 18))
               * (rng.random((20, 18)) < 0.25)).astype(np.float32)
    graph = np.triu(rng.integers(1, 4, (30, 30))
                    * (rng.random((30, 30)) < 0.2), 1).astype(np.float32)
    graph = graph + graph.T
    cliques = np.zeros((20, 20), np.float32)
    cliques[:10, :10] = cliques[10:, 10:] = 1.0
    np.fill_diagonal(cliques, 0.0)
    cliques[0, 10] = cliques[10, 0] = 1.0
    cost = rng.integers(0, 100, (24, 24)).astype(np.float32)
    coo_rows = np.array([2, 0, 2, 0, -1, 1], np.int32)
    coo_cols = np.array([1, 1, 1, 1, 0, 0], np.int32)
    coo_vals = np.array([5.0, 1.0, 7.0, 2.0, 9.0, 0.0], np.float32)

    def T(r, a):
        return r.put(a)

    def csr(r, a):
        return CSR.from_dense(a, device=r.device)

    cases = []
    # core.operators on device tensors
    for name in ("identity_op", "sq_op", "abs_op", "nz_op"):
        cases.append((f"operators.{name}",
                      lambda r, f=getattr(op, name): f(T(r, ai)), EX))
    cases.append(("operators.sqrt_op", lambda r: op.sqrt_op(T(r, pos)), F))
    for name in ("add_op", "sub_op", "mul_op", "min_op", "max_op",
                 "equal_op", "notequal_op", "greater_op", "less_op",
                 "greater_or_equal_op", "less_or_equal_op",
                 "div_checkzero_op"):
        cases.append((f"operators.{name}", lambda r, f=getattr(op, name):
                      f(T(r, ai[:, :12]), T(r, ci)), EX))
    cases += [
        ("operators.div_op", lambda r: op.div_op(T(r, af), T(r, pos)), F),
        ("operators.pow_op", lambda r: op.pow_op(T(r, pos), 1.5), F),
        ("operators.mod_op", lambda r: op.mod_op(T(r, ai), 3.0), EX),
        ("operators.const_ops", lambda r: [
            f(2.0)(T(r, pos)) for f in (op.add_const_op, op.sub_const_op,
                                        op.mul_const_op, op.div_const_op,
                                        op.pow_const_op)]
         + [op.plug_const_op(2.0, op.sub_op, "left")(T(r, pos)),
            op.const_op(3.0)(T(r, pos))], F),
        ("operators.compose_map_args_key_value_void", lambda r: [
            op.compose_op(op.sqrt_op, op.sq_op)(T(r, af)),
            op.map_args_op(op.add_op, op.sq_op, op.abs_op)(T(r, af),
                                                           T(r, bf)),
            op.key_op((T(r, ai), T(r, bi))),
            op.value_op((T(r, ai), T(r, bi))), op.void_op(T(r, ai))], F),
    ]

    def trace_text(r):
        seen = []
        old = logger.logger.level
        logger.set_callback(lambda lvl, msg: seen.append(msg))
        try:
            logger.set_level(logger.LogLevel.TRACE)
            logger.trace_vec("v", T(r, af[0]), limit=6)
            lvl = int(logger.get_level())
        finally:
            logger.set_callback(None)
            logger.logger.setLevel(old)
        return [np.array(seen), lvl]

    cases.append(("logger.trace_vec", trace_text, EX))

    # random: distributions on the card against the CPU's draws
    n = 20000
    for name, args, kw in (
            ("uniform", ((n,),), dict(low=-2, high=3)),
            ("uniform_int", ((n,), 2, 9), {}),
            ("normal", ((n,),), dict(mu=1.0, sigma=2.0)),
            ("lognormal", ((n,),), {}), ("gumbel", ((n,),), {}),
            ("logistic", ((n,),), {}), ("laplace", ((n,),), {}),
            ("exponential", ((n,),), {}), ("rayleigh", ((n,),), {}),
            ("bernoulli", ((n,),), dict(prob=0.3)),
            ("scaled_bernoulli", ((n,),), dict(prob=0.3, scale=2.0)),
            ("permute", (n,), {}),
            ("sample_without_replacement", (100, n), {}),
            ("rmat", (10, 8, n), {}),
            ("multi_variable_gaussian", (np.zeros(2), np.array(
                [[2.0, 0.5], [0.5, 1.0]], np.float32), n), {})):
        cases.append((f"random.{name}", lambda r, f=getattr(random, name),
                      a=args, k=kw: f(random.RngState(seed), *a,
                                      device=r.device, **k), "dist"))
    cases += [
        ("random.sample_without_replacement(weights)", lambda r: torch.sort(
            random.sample_without_replacement(
                random.RngState(seed), 10, 50, weights=np.r_[
                    np.ones(10), np.full(40, 1e-9)], device=r.device)
        ).values, EX),
        ("random.subsample", lambda r: random.subsample(
            random.RngState(seed), 1000, 37, device=r.device), EX),
        # the centers and weights differ by draw: compare the noise
        # around them, the labels, the centers and the weights
        ("random.make_blobs", lambda r: (lambda x, lab, c: [
            x - c[lab.long()], lab, c])(*random.make_blobs(
                random.RngState(seed), 4000, 8, n_clusters=4,
                device=r.device)), "dist"),
        ("random.make_regression", lambda r: random.make_regression(
            random.RngState(seed), 4000, 8, device=r.device)[::2], "dist"),
    ]

    # linalg
    cases += [
        ("linalg.gemm", lambda r: linalg.gemm(r, ai, bi, alpha=2.0, beta=0.5,
                                              c=ci), EX),
        ("linalg.gemm(trans)", lambda r: linalg.gemm(
            r, ai.T, bi.T, trans_a=True, trans_b=True), EX),
        ("linalg.gemv", lambda r: linalg.gemv(r, ai, vec16, beta=1.0,
                                              y=vec24), EX),
        ("linalg.axpy", lambda r: linalg.axpy(r, 2.0, ai, ai), EX),
        ("linalg.dot", lambda r: linalg.dot(r, vec16, vec16), EX),
        ("linalg.elementwise", lambda r: [
            linalg.add(r, af, bf), linalg.subtract(r, af, bf),
            linalg.multiply(r, af, bf), linalg.divide(r, af, pos),
            linalg.power(r, pos, 1.5), linalg.sqrt(r, pos),
            linalg.scalar_add(r, af, 2.0), linalg.scalar_multiply(r, af, 3.0),
            linalg.transpose(r, af),
            linalg.unary_op(r, af, torch.abs),
            linalg.binary_op(r, af, bf, torch.maximum),
            linalg.ternary_op(r, af, bf, pos, lambda a, b, c: a * b + c),
            linalg.map(r, lambda a, b: a - b, af, bf),
            linalg.map_offset(r, (4, 6), lambda i: i * 2,
                              dtype=torch.int32)], F),
        ("linalg.matrix_vector_op", lambda r: [
            linalg.matrix_vector_op(r, ai, vec16, torch.add),
            linalg.matrix_vector_op(r, ai, vec24, torch.mul,
                                    along_rows=False)], EX),
        ("linalg.reductions", lambda r: [
            linalg.reduce(r, ai, reduce_op=torch.amax, init=0.0),
            linalg.coalesced_reduction(r, ai),
            linalg.strided_reduction(r, ai),
            linalg.map_reduce(r, ai, lambda v: v * v),
            linalg.mean_squared_error(r, ai, ai[::-1].copy()),
            linalg.reduce_rows_by_key(r, ai, keys24, 5),
            linalg.reduce_cols_by_key(r, ai, keys16, 4)]
         + [linalg.norm(r, ai, t, along_rows=ax)
            for t in (linalg.L1Norm, linalg.L2Norm, linalg.LinfNorm)
            for ax in (True, False)], EX),
        ("linalg.normalize", lambda r: [linalg.normalize(r, af, t) for t in (
            linalg.L1Norm, linalg.L2Norm, linalg.LinfNorm)], F),
        ("linalg.eig_dc", lambda r: linalg.eig_dc(r, spd), "sign"),
        ("linalg.eig_jacobi", lambda r: linalg.eig_jacobi(r, spd), "sign"),
        ("linalg.svd", lambda r: linalg.svd(r, af), "sign"),
        ("linalg.qr", lambda r: [m.T if m.shape[0] == m.shape[1] else m
                                 for m in linalg.qr(r, af)], "sign"),
        ("linalg.rsvd", lambda r: linalg.rsvd(r, ai @ bi, 4, key=seed)[1],
         P),
        ("linalg.lstsq", lambda r: linalg.lstsq(r, af, af @ vec16), P),
        ("linalg.cholesky_rank_one_update", lambda r:
         linalg.cholesky_rank_one_update(r, chol, vec16), P),
        ("linalg.lanczos_smallest", lambda r: linalg.lanczos_smallest(
            r, CSR.from_dense(graph, device=r.device), 4, seed=seed)[0], P),
    ]

    # matrix ops (tensors on the device; eye takes device=)
    cases += [
        ("matrix.ops", lambda r: [
            matrix.gather(T(r, ai), T(r, keys24)),
            matrix.gather_if(T(r, ai), T(r, keys24), T(r, keys24),
                             lambda s: s > 1),
            matrix.scatter(T(r, ai), T(r, np.array([3, 1])), T(r, ai[:2])),
            matrix.slice(T(r, ai), (2, 9), (1, 5)),
            matrix.argmax(T(r, ai)), matrix.argmin(T(r, ai), 0),
            matrix.col_sort(T(r, ai)), matrix.col_sort(T(r, ai), T(r, af)),
            matrix.copy(T(r, ai)), matrix.diagonal(T(r, ai)),
            matrix.set_diagonal(T(r, ai), T(r, vec16)),
            matrix.eye(5, device=r.device), matrix.fill(T(r, ai), 2.0),
            matrix.l2_norm(T(r, ai)),
            matrix.linewise_op(T(r, ai), T(r, vec16), True, torch.add),
            matrix.power(T(r, ai), 2.0), matrix.ratio(T(r, pos)),
            matrix.reciprocal(T(r, ai), 1.0, 0.5),
            matrix.reverse(T(r, ai)), matrix.sign_flip(T(r, ai)),
            matrix.sqrt(T(r, pos)), matrix.threshold(T(r, ai), 2.0),
            matrix.zero_small_values(T(r, af), 0.5),
            matrix.triangular_upper(T(r, ai)),
            matrix.triangular_lower(T(r, ai))], F),
    ]

    def printed(r):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            matrix.matrix_print(T(r, ai), "m")
        return np.array(buf.getvalue())

    cases.append(("matrix.matrix_print", printed, EX))

    # label and stats
    cases += [
        ("label", lambda r: [
            label.get_unique_labels(r, lab_a * 3),
            label.make_monotonic(r, lab_a * 3), label.ovr_labels(r, lab_a, 2),
            label.merge_labels(r, lab_a, lab_b)], EX),
        ("stats.summary", lambda r: [
            stats.mean(r, af), stats.mean(r, af, along_rows=True),
            stats.sum_stat(r, af), stats.var(r, af), stats.stddev(r, af),
            stats.meanvar(r, af), stats.mean_center(r, af),
            stats.cov(r, af), stats.minmax(r, af),
            stats.weighted_mean(r, af, pos[0]),
            stats.weighted_mean(r, af, pos[:, 0], along_rows=False),
            stats.regression_metrics(r, af, bf)], P),
        ("stats.histogram", lambda r: [stats.histogram(r, ai, 5),
                                       stats.histogram(r, af, 7, lo=-1.0,
                                                       hi=1.0)], EX),
        ("stats.labelings", lambda r: [
            stats.contingency_matrix(r, lab_a, lab_b),
            stats.accuracy(r, lab_a, lab_b), stats.rand_index(r, lab_a, lab_b),
            stats.adjusted_rand_index(r, lab_a, lab_b),
            stats.mutual_info_score(r, lab_a, lab_b),
            stats.homogeneity_score(r, lab_a, lab_b),
            stats.completeness_score(r, lab_a, lab_b),
            stats.v_measure(r, lab_a, lab_b), stats.entropy(r, lab_a, 4)],
         F),
        ("stats.scores", lambda r: [
            stats.r2_score(r, af[:, 0], bf[:, 0]),
            stats.kl_divergence(r, pos[0] / pos[0].sum(),
                                pos[1] / pos[1].sum()),
            stats.silhouette_score(r, blobs, blob_lab, tile=50),
            stats.trustworthiness(r, blobs, blobs[:, :2], 5),
            stats.trustworthiness_score(r, blobs, blobs[:, :3], 5),
            stats.information_criterion(r, np.array([-100.0, -50.0],
                                                    np.float32),
                                        ICType.BIC, 3, 50),
            stats.dispersion(r, af[:4], keys24[:4] + 1)], P),
    ]

    # sparse
    def coo_of(r):
        return COO.from_numpy(coo_rows, coo_cols, coo_vals, (3, 2),
                              device=r.device)

    cases += [
        ("sparse.types_convert", lambda r: [
            csr(r, dense_s), csr(r, dense_s).row_ids(),
            csr(r, dense_s).to_dense(), COO.from_dense(dense_s, nnz=600,
                                                       device=r.device),
            convert.coo_to_csr(COO.from_dense(dense_s, nnz=600,
                                              device=r.device)),
            convert.csr_to_coo(csr(r, dense_s)),
            convert.dense_to_csr(dense_s, device=r.device),
            convert.dense_to_coo(dense_s, device=r.device),
            convert.csr_to_dense(csr(r, dense_s)),
            convert.coo_to_dense(coo_of(r)),
            CSR.from_numpy(**csr(r, dense_s).to_numpy(), device=r.device),
            COO.from_numpy(**coo_of(r).to_numpy(), device=r.device)], EX),
        ("sparse.ops", lambda r: [
            ops.coo_sort(coo_of(r)), ops.sum_duplicates(coo_of(r)),
            ops.max_duplicates(coo_of(r)), ops.remove_scalar(coo_of(r), 7.0),
            ops.remove_zeros(coo_of(r)), ops.degree(coo_of(r)),
            ops.row_slice(csr(r, dense_s), 4, 19),
            ops.csr_row_op(csr(r, dense_s), lambda i, v: v * 2)], EX),
        ("sparse.linalg", lambda r: [
            slin.spmm(csr(r, dense_s), T(r, dense_t)),
            slin.spmv(csr(r, dense_s), T(r, dense_t[:, 0])),
            slin.spgemm(csr(r, dense_s), csr(r, dense_t)),
            slin.row_norm_csr(csr(r, dense_s), "linf"),
            slin.transpose(csr(r, dense_s)),
            slin.add(csr(r, dense_s), csr(r, dense_s[::-1].copy())),
            slin.coo_symmetrize(convert.csr_to_coo(csr(r, graph))),
            slin.laplacian(csr(r, graph), normalized=False)], EX),
        ("sparse.linalg(float)", lambda r: [
            slin.csr_row_normalize(csr(r, dense_s), "l2"),
            slin.laplacian(csr(r, graph))], F),
        ("sparse.distance", lambda r: [
            sdist.pairwise_distance(r, csr(r, dense_s), csr(r, dense_s[:9]),
                                    DistanceType.L1, tile=8),
            sdist.pairwise_distance(r, csr(r, dense_s), csr(r, dense_s[:9]),
                                    DistanceType.L2Expanded, tile=8,
                                    col_tile=6)], EX),
        ("sparse.neighbors", lambda r: [
            neighbors.knn_graph(r, blobs, 5, DistanceType.L2Expanded),
            neighbors.cross_component_nn(r, blobs, blob_lab % 2,
                                         DistanceType.L2Expanded)], EX),
        ("sparse.solver.mst", lambda r: solver.mst(r, csr(r, graph)), EX),
        ("cluster.single_linkage", lambda r: single_linkage(
            r, blobs, 4, metric=DistanceType.L2Expanded, k=5), EX),
    ]

    # spectral and the solver on tiny inputs
    def emb(r):
        ev, e = spectral.fit_embedding(r, csr(r, cliques), 2, seed=seed)
        return [ev, e]

    def parts(r):
        lab, ev, _ = spectral.partition(r, csr(r, cliques), 2, seed=seed)
        mlab, mev, _ = spectral.modularity_maximization(r, csr(r, cliques), 2,
                                                        seed=seed)
        halves = np.repeat(np.arange(2), 10)
        return [np.array(_same_partition(_host(lab), halves)),
                np.array(_same_partition(_host(mlab), halves)), ev, mev,
                spectral.modularity(r, csr(r, cliques), halves),
                spectral.analyze_partition(r, csr(r, cliques), halves)]

    def lap(r):
        a, t = linear_assignment(r, cost)
        obj = LinearAssignmentProblem(r, 24, 2)
        return [a, t, obj.solve(np.stack([cost, cost.T]))]

    cases += [("spectral.fit_embedding", emb, "sign"),
              ("spectral.partition_modularity", parts, P),
              ("solver.linear_assignment", lap, EX)]
    return cases


def prims_sweep(torch, seed: int, device) -> dict:
    """Every case of :func:`sweep_cases` on ``device`` against the same
    call on the CPU."""
    from raft_tpu_torch import Resources

    res = Resources(device=device, seed=seed)
    cpu = Resources(device="cpu", seed=seed)
    out = {}
    t0 = time.perf_counter()
    for name, fn, tol in sweep_cases(torch, seed):
        out[name] = sweep_equal(torch, name, fn(res), fn(cpu), tol,
                                res.device)
    return dict(cases=len(out), seconds=time.perf_counter() - t0,
                worst={k: v for k, v in out.items() if v})


def prims_blobs_1m(torch, seed: int) -> dict:
    """make_blobs at 1,000,000 x 128 on the card, with stats.cov and
    stats.meanvar on it against float64 numpy of the same rows."""
    from raft_tpu_torch import Resources, random, stats

    res = Resources(device="cuda", seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, centers = random.make_blobs(random.RngState(seed + 1), BLOBS_1M,
                                      PRIMS_DIM, n_clusters=PRIMS_BLOBS,
                                      device="cuda")
    torch.cuda.synchronize()
    blobs_s = time.perf_counter() - t0
    cov = stats.cov(res, x).cpu().numpy().astype(np.float64)
    mu, var = (t.cpu().numpy().astype(np.float64)
               for t in stats.meanvar(res, x))
    xh = x.cpu().numpy().astype(np.float64)
    del x
    mu64 = xh.mean(axis=0)
    xh -= mu64
    cov64 = (xh.T @ xh) / (BLOBS_1M - 1)
    var64 = np.diagonal(cov64)
    scale = float(np.abs(cov64).max())
    cov_err = float(np.abs(cov - cov64).max()) / scale
    mu_err = float(np.abs(mu - mu64).max()) / max(1.0, float(
        np.abs(mu64).max()))
    var_err = float(np.abs(var - var64).max()) / scale
    if cov_err > 1e-4 or mu_err > 1e-5 or var_err > 1e-4:
        fail(f"prims: stats.cov/meanvar of the 1M blobs off float64 by "
             f"{cov_err:.3g} / {mu_err:.3g} / {var_err:.3g}")
    if y.device.type != "cuda" or int(y.max()) != PRIMS_BLOBS - 1:
        fail("prims: make_blobs' labels are malformed")
    log(f"[prims] make_blobs {BLOBS_1M} x {PRIMS_DIM} on the card in "
        f"{blobs_s:.3f} s; stats.cov within {cov_err:.2e} and "
        f"stats.meanvar within {mu_err:.2e} / {var_err:.2e} of float64 "
        "numpy (of max |cov|, max(1, max |mean|))")
    return dict(seconds=blobs_s, cov_err=cov_err, mean_err=mu_err,
                var_err=var_err)


def phase_prims(torch, seed: int, state: dict) -> None:
    """The primitives on the card (the module docstring, phase 14)."""
    from raft_tpu_torch import Resources, random

    res = Resources(device="cuda", seed=seed)
    out = {"card": state.get("card")}
    x, y, _ = random.make_blobs(random.RngState(seed), PRIMS_ROWS, PRIMS_DIM,
                                n_clusters=PRIMS_BLOBS, device="cuda")
    log(f"[prims] make_blobs {PRIMS_ROWS} x {PRIMS_DIM} float32, "
        f"{PRIMS_BLOBS} blobs (cluster_std 1.0, center_box (-10, 10)); the "
        f"rows are a cut from 1M for the time limit")
    sl = prims_single_linkage(torch, res, x, y, PRIMS_BLOBS, PRIMS_K, state)
    out["single_linkage"] = sl["rec"]
    out["spectral"] = prims_spectral(torch, res, sl["graph"], y,
                                     PRIMS_BLOBS, seed)
    del sl, x
    out["lap"] = prims_lap(torch, res, seed, LAP_N)
    out["sparse_knn"] = prims_sparse_knn(torch, res, seed, **SPLADE)
    out["blobs_1m"] = prims_blobs_1m(torch, seed)
    out["sweep"] = prims_sweep(torch, seed, "cuda")
    log(f"[prims] sweep: {out['sweep']['cases']} cases of the primitive "
        f"modules' other public functions on the card equal their CPU runs "
        f"(integer data exactly; float32 within rtol/atol 1e-5 elementwise, "
        f"1e-4 for products and solvers; eigen- and singular vectors up to "
        f"sign; random draws by their moments within 5 standard errors) in "
        f"{out['sweep']['seconds']:.2f} s; largest differences "
        f"{out['sweep']['worst']}")
    path = os.path.join("chiprun_out", "prims.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"[prims] {state.get('card')}: results in {path}")


# bench: the ANN benchmark harness through its CLI on blobs-100000-128 (the
# bundled config's own shape, nothing cut), hnswlib on a 10,000-row tree
BENCH_N, BENCH_DIM, BENCH_QUERIES, BENCH_GT_K = 100_000, 128, 1000, 100
BENCH_HNSW_N = 10_000     # a cut: the hnswlib build is one host thread
BENCH_HNSW_QUERIES = 500  # a cut: its searches are one host thread too
BENCH_CONFIG = "blobs-100000-128"
BENCH_ALGOS = ("raft_brute_force", "raft_ivf_flat", "raft_ivf_pq",
               "raft_ivf_bq", "raft_cagra", "raft_quantized", "ivf_flat_cpu")
BENCH_LATENCY_ALGOS = ("raft_ivf_flat", "raft_cagra")
BENCH_CACHED_ALGOS = ("raft_ivf_flat", "raft_ivf_pq", "raft_cagra")
BENCH_KERNELS = ("fused_knn", "list_major_scan", "ivf_pq_scan", "bq_scan",
                 "beam_search")
BENCH_PRIM_KERNELS = ("fused_knn", "list_major_scan", "select_k",
                      "stream_read_sum")
BENCH_GT_SAMPLE = 100


def bench_config() -> dict:
    """BENCH_CONFIG's entries: a bundled config's name, or a file."""
    path = BENCH_CONFIG
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "raft_tpu_torch", "bench", "conf",
                            f"{BENCH_CONFIG}.json")
    with open(path) as f:
        return json.load(f)


def bench_cli(argv) -> list:
    """``raft_tpu_torch.bench.__main__.main(argv)``, its stdout (the rows
    it prints) captured so no JSON line of its own reaches ours; returns
    the printed lines."""
    import importlib

    cli = importlib.import_module("raft_tpu_torch.bench.__main__").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    if rc != 0:
        fail(f"bench: {' '.join(argv[:1])} returned {rc}")
    return buf.getvalue().splitlines()


def bench_rows(lines) -> list:
    return [json.loads(line) for line in lines if line.startswith("{")]


def bench_groundtruth(torch, tree: str, seed: int) -> dict:
    """The dataset's ground truth for BENCH_GT_SAMPLE sampled queries
    against float64 numpy on base.fbin: ids equal but at float64 ties (two
    ids whose float64 distances are within the tolerance), distances
    within 1e-4 (1 + |d|)."""
    from raft_tpu_torch.io import read_bin

    base = read_bin(os.path.join(tree, "base.fbin")).astype(np.float64)
    queries = read_bin(os.path.join(tree, "query.fbin")).astype(np.float64)
    gi = read_bin(os.path.join(tree, "groundtruth.neighbors.ibin"))
    gd = read_bin(os.path.join(tree, "groundtruth.distances.fbin"))
    if gi.shape[0] != queries.shape[0] or gd.shape != gi.shape:
        fail(f"bench: ground truth shape {gi.shape}")
    k = gi.shape[1]
    rows = np.random.default_rng(seed).choice(
        queries.shape[0], min(BENCH_GT_SAMPLE, queries.shape[0]),
        replace=False)
    # the sampled queries' squared distances to every row in one product
    d2 = ((base * base).sum(axis=1)[:, None] - 2.0 * base @ queries[rows].T
          + (queries[rows] ** 2).sum(axis=1)[None])
    err = 0.0
    ties = 0
    for j, r in enumerate(rows):
        d64 = np.sqrt(np.maximum(d2[:, j], 0.0))
        part = np.argpartition(d64, k)[:k + 1]
        want = part[np.argsort(d64[part], kind="stable")][:k]
        tol = 1e-4 * (1.0 + np.abs(d64[want]))
        got_d = gd[r].astype(np.float64)
        e = np.abs(got_d - d64[gi[r]])
        if bool((e > tol).any()):
            fail(f"bench: ground truth of query {r}: distance off float64 by "
                 f"{e.max():.3g}")
        other = gi[r] != want
        if bool((np.abs(d64[gi[r]] - d64[want]) > tol)[other].any()):
            fail(f"bench: ground truth of query {r}: ids differ from float64 "
                 "beyond ties")
        ties += int(other.sum())
        err = max(err, float(e.max()))
    return dict(sampled=len(rows), k=k, max_abs_err=err, ties=ties)


def bench_kernel_checks(torch, tree: str, results: str) -> dict:
    """One search of each kernel-backed family at the sweep's parameters
    (BENCH_CONFIG's entries), on the sweep's own index (the runner's cache
    file under ``results``; brute force's is its norms), against the plain
    engine on the same index, over every query of ``tree``."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.bench.datasets import METRICS
    from raft_tpu_torch.bench.runner import _index_cache_key
    from raft_tpu_torch.io import read_bin
    from raft_tpu_torch.neighbors import (
        brute_force,
        cagra,
        ivf_bq,
        ivf_flat,
        ivf_pq,
    )
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain
    from raft_tpu_torch.ops.fused_topk import fused_knn, fused_knn_plain

    res = Resources(device="cuda")
    cfg = {a["name"]: a for a in bench_config()["algos"]}
    base = res.put(read_bin(os.path.join(tree, "base.fbin")))
    queries = res.put(read_bin(os.path.join(tree, "query.fbin")))
    metric = METRICS["euclidean"]
    name = os.path.basename(tree)
    nq = queries.shape[0]

    def cached(algo):
        key = _index_cache_key(algo, name, base.shape[0], base.shape[1],
                               "euclidean", cfg[algo]["build"])
        path = os.path.join(results, "indexes", f"{key}.bin")
        if not os.path.exists(path):
            fail(f"bench: no cache file for {algo} ({path})")
        return path

    out = {}
    t0 = time.perf_counter()
    bf = brute_force.build(res, base, metric)
    blocks = []
    for s in range(0, nq, brute_force.FUSED_MAX_QUERIES):
        q = queries[s:s + brute_force.FUSED_MAX_QUERIES]
        blocks.append(compare(
            f"bench brute force block {s}", fused_knn(
                q, bf.dataset, K, metric, dataset_norms=bf.norms),
            fused_knn_plain(q, bf.dataset, K, metric,
                            dataset_norms=bf.norms), exact_ids=False))
    out["fused_knn"] = max(blocks)
    bf_d, bf_i = brute_force.search(res, bf, queries, K)

    flat = ivf_flat.load(res, cached("raft_ivf_flat"))
    n_lists = flat.n_lists
    fd, fi = ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(
        n_probes=n_lists), flat, queries, K)
    torch.cuda.synchronize()
    x64 = base.double()
    q64 = queries.double()

    def d64(ids):
        return (x64[ids.long()] - q64[:, None]).norm(dim=2)

    tol = 1e-4 * (1.0 + bf_d.double().abs())
    other = fi != bf_i
    if bool(((d64(fi) - d64(bf_i)).abs() > tol)[other].any()):
        fail(f"bench: IVF-Flat at n_probes {n_lists} = n_lists differs from "
             f"brute force in {int(other.sum())} ids beyond float64 ties")
    if bool(((fd - bf_d).abs() > 1e-4 * (1.0 + bf_d.abs())).any()):
        fail("bench: IVF-Flat at n_probes = n_lists: distances off brute "
             "force beyond 1e-4 (1 + |d|)")
    out["list_major_scan"] = float((fd - bf_d).abs().max())
    out["ivf_flat_ties"] = int(other.sum())

    pq = ivf_pq.load(res, cached("raft_ivf_pq"))
    for ratio in (1.0, 2.0):
        k0 = max(K, int(K * ratio))
        got = pq_body(pq, queries, 128, "cuda", k0)
        want = pq_body(pq, queries, 128, "torch", k0)
        pq_equal(torch, f"bench ivf_pq n_probes 128 refine {ratio}", got,
                 want)
        if ratio > 1.0:
            got = refine(res, base, queries, got[1], K, metric)
            want = refine(res, base, queries, want[1], K, metric)
            pq_equal(torch, "bench ivf_pq refined", got, want)
    out["ivf_pq_scan"] = 0.0

    bq = ivf_bq.load(res, cached("raft_ivf_bq"))
    if bq.bits != 2:
        fail(f"bench: the IVF-BQ cache holds bits {bq.bits}, not 2")
    k0 = int(K * 8.0)
    runs = []
    for engine in ("cuda", "torch"):
        _, arrays, static = ivf_bq.serving_plan(ivf_bq.IvfBqSearchParams(
            n_probes=64, scan_engine=engine), bq, k0)
        runs.append(ivf_bq._search_arrays(queries, *arrays, None,
                                          **static)[:3])
    out["bq_scan"] = bq_equal("bench ivf_bq bits 2 n_probes 64", *runs)

    cg = cagra.load(res, cached("raft_cagra"))
    errs = []
    for kw in (dict(itopk_size=256), dict(itopk_size=128, seed_pool=2048)):
        # the walk of the search's first query tile (a cut for the time
        # limit: the plain walk takes ~1 s a tile)
        sp = cagra.CagraSearchParams(**kw)
        args, bkw = cagra.beam_search_args(sp, cg, queries[:sp.query_tile], K)
        errs.append(beam_equal(f"bench cagra {kw}", beam_search(
            *args, **bkw), beam_search_plain(*args, **bkw)))
    out["beam_search"] = max(errs)
    out["seconds"] = time.perf_counter() - t0
    return out


def bench_prims(torch) -> dict:
    """run_prims("small") on the card, its launches counted; then each prim
    that launches a kernel held once against its plain version at the
    prim's own shape."""
    from raft_tpu_torch.bench import prims as bprims
    from raft_tpu_torch.matrix.select_k import SelectAlgo, select_k
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops.fused_topk import (
        fused_knn,
        fused_knn_plain,
        select_k_tiles,
        select_k_tiles_plain,
        stream_read_sum,
        stream_read_sum_plain,
    )

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        recs = bprims.run_prims("small", budget_s=0.5, device="cuda")
    secs = time.perf_counter() - t0
    launches = read_launches(BENCH_PRIM_KERNELS, "bench prims")
    bad = [r for r in recs if "error" in r]
    if bad or [r["prim"] for r in recs] != bprims.names():
        fail(f"bench: prims records with errors or missing: {bad}")

    dev = torch.device("cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, ds, norms, k = bprims.fused_knn_inputs("small", dev, dtype)
        errs[f"fused_knn_{str(dtype)[6:]}"] = compare(
            f"bench prims fused_knn {dtype}",
            fused_knn(qs, ds, k, dataset_norms=norms),
            fused_knn_plain(qs, ds, k, dataset_norms=norms), exact_ids=False)
    v, _, _, k = bprims._select_values("small", dev)
    got = select_k_tiles(v, k)
    want = select_k_tiles_plain(v, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("bench prims select_k_pallas differs from its plain version")
    if not torch.equal(want[0], select_k(None, v, k,
                                         algo=SelectAlgo.TOPK)[0]):
        fail("bench prims select_k: the TOPK route's values differ")
    errs["select_k"] = 0.0
    res, idx, qs, sp, _ = bprims.ivf_flat_inputs("small", dev)
    got = ivf_flat.search(res, sp, idx, qs, 10)
    want = ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(
        n_probes=sp.n_probes, scan_engine="torch"), idx, qs, 10)
    errs["ivf_flat_search"] = compare("bench prims ivf_flat_search", got,
                                      want, exact_ids=False)
    for seed, size, dtype in ((0, 1 << 18, torch.float32),
                              (3, 1 << 18, torch.float32),
                              (0, 1 << 18, torch.bfloat16)):
        x = bprims._normal(seed, (size, 128), dev, dtype)
        got, want = stream_read_sum(x), stream_read_sum_plain(x)
        e = float((got - want).abs().max())
        if e > 1e-4 * (1.0 + float(want.abs().max())):
            fail(f"bench prims stream_read {dtype}: {e} off the plain sum")
        errs[f"stream_read_{str(dtype)[6:]}_{seed}"] = e
    return dict(records=recs, seconds=secs, launches=launches,
                max_abs_err=errs)


def phase_bench(torch, seed: int, state: dict) -> None:
    """The ANN benchmark harness on the card (the module docstring,
    phase 15)."""
    import importlib.util
    import shutil
    import tempfile

    from raft_tpu_torch.bench import hnsw_cpu

    t_phase = time.perf_counter()
    out = {"card": state.get("card"), "config": BENCH_CONFIG}
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_bench_")
    try:
        ds = os.path.join(tmp, "datasets")
        results = os.path.join(tmp, "results")
        tree = os.path.join(ds, f"blobs-{BENCH_N}-{BENCH_DIM}")
        reset_launches()
        t0 = time.perf_counter()
        bench_cli(["get-dataset", "--kind", "blobs", "--n", str(BENCH_N),
                   "--dim", str(BENCH_DIM), "--n-queries", str(BENCH_QUERIES),
                   "--k", str(BENCH_GT_K), "--metric", "euclidean", "--seed",
                   str(seed), "--out-dir", ds, "--device", "cuda"])
        out["get_dataset_s"] = time.perf_counter() - t0
        log(f"[bench] get-dataset: {out['get_dataset_s']:.2f} s")
        runs = {}

        def sweep(label, *extra):
            t1 = time.perf_counter()
            rows = bench_rows(bench_cli(
                ["run", "--dataset", tree, "--config", BENCH_CONFIG,
                 "--out-dir", results, "-k", str(K), "--device", "cuda",
                 *extra]))
            # each run's rows in a file of its own, so data-export reads all
            os.replace(os.path.join(results, "results.jsonl"),
                       os.path.join(results, f"{label}.jsonl"))
            runs[label] = rows
            out[f"{label}_s"] = time.perf_counter() - t1
            log(f"[bench] run {label}: {len(rows)} rows in "
                f"{out[label + '_s']:.2f} s")
            if not rows or any(r["backend"] != "cuda" for r in rows):
                fail(f"bench: the {label} run gave {len(rows)} rows, or rows "
                     "of another backend")
            return rows

        sweep("batch1000", "--algos", ",".join(BENCH_ALGOS))
        sweep("batch10", "--batch-size", "10", "--search-iters", "1",
              "--algos", ",".join(BENCH_LATENCY_ALGOS))
        cached = sweep("cached", "--require-cached-index", "--algos",
                       ",".join(BENCH_CACHED_ALGOS))
        first = {(r["algo"], json.dumps(r["search_params"], sort_keys=True)):
                 r for r in runs["batch1000"]}
        for r in cached:
            f = first[r["algo"], json.dumps(r["search_params"],
                                            sort_keys=True)]
            if not r["build_cached"] or r["recall"] != f["recall"]:
                fail(f"bench: cache round trip {r['algo']} "
                     f"{r['search_params']}: build_cached "
                     f"{r['build_cached']}, recall {r['recall']} vs "
                     f"{f['recall']}")
        if not hnsw_cpu.available():
            fail(f"bench: hnswlib's native library did not build "
                 f"({hnsw_cpu._build_error})")
        t1 = time.perf_counter()
        bench_cli(["get-dataset", "--kind", "blobs", "--n", str(BENCH_HNSW_N),
                   "--dim", str(BENCH_DIM), "--n-queries",
                   str(BENCH_HNSW_QUERIES),
                   "--k", str(K), "--seed", str(seed), "--out-dir", ds,
                   "--device", "cuda"])
        hnsw = bench_rows(bench_cli(
            ["run", "--dataset", os.path.join(
                ds, f"blobs-{BENCH_HNSW_N}-{BENCH_DIM}"), "--config",
             BENCH_CONFIG, "--out-dir", os.path.join(tmp, "hnsw"), "-k",
             str(K), "--search-iters", "1", "--algos", "hnswlib", "--device",
             "cuda"]))
        if len(hnsw) != 6:
            fail(f"bench: hnswlib gave {len(hnsw)} rows, not 6")
        shutil.copy(os.path.join(tmp, "hnsw", "results.jsonl"),
                    os.path.join(results, "hnswlib.jsonl"))
        runs["hnswlib"] = hnsw
        out["hnswlib_s"] = time.perf_counter() - t1
        log(f"[bench] hnswlib on {BENCH_HNSW_N} rows: "
            f"{out['hnswlib_s']:.2f} s")
        launches = read_launches(BENCH_KERNELS, "bench")

        csv = bench_cli(["data-export", "--results", results])[-1]
        n_csv = len(open(csv).read().splitlines()) - 1
        if n_csv != sum(len(v) for v in runs.values()):
            fail(f"bench: data-export wrote {n_csv} rows")
        out["plot_bytes"] = None
        if importlib.util.find_spec("matplotlib") is None:
            log("[bench] plot skipped: matplotlib does not import here")
        else:
            png = bench_cli(["plot", "--results", results])[-1]
            out["plot_bytes"] = os.path.getsize(png)

        t1 = time.perf_counter()
        out["groundtruth"] = bench_groundtruth(torch, tree, seed)
        out["groundtruth_s"] = time.perf_counter() - t1
        out["kernel_checks"] = bench_kernel_checks(torch, tree, results)
        out["kernel_checks_s"] = out["kernel_checks"]["seconds"]
        log(f"[bench] ground truth check {out['groundtruth_s']:.2f} s, "
            f"kernel checks {out['kernel_checks_s']:.2f} s")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out["prims"] = bench_prims(torch)
        out["prims_s"] = time.perf_counter() - t1
        for name, c in out["prims"]["launches"].items():
            launches[name] = launches.get(name, 0) + c
        total = state.setdefault("launches", {})
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
        out["launches"] = launches
        out["runs"] = runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    best = {}
    for r in runs["batch1000"] + runs["hnswlib"]:
        b = best.get(r["algo"])
        if b is None or (r["recall"], r["qps"]) > (b["recall"], b["qps"]):
            best[r["algo"]] = r
    out["best"] = best
    for algo, r in best.items():
        log(f"[bench] {algo}: best recall@{K} {r['recall']} at "
            f"{r['qps']} QPS ({r['search_params']}, batch "
            f"{r['batch_size']}), build {r['build_seconds']} s")
    for r in runs["batch10"]:
        log(f"[bench] batch 10 {r['algo']} {r['search_params']}: recall "
            f"{r['recall']}, {r['qps']} QPS")
    g, kc, pr = out["groundtruth"], out["kernel_checks"], out["prims"]
    log(f"[bench] ground truth (k {BENCH_GT_K}) against float64 on "
        f"{g['sampled']} queries: max |dd| {g['max_abs_err']:.3g}, "
        f"{g['ties']} ids at ties; kernels at the sweep's parameters: "
        f"fused_knn max |dd| {kc['fused_knn']:.3g}, IVF-Flat at n_probes = "
        f"n_lists vs brute force {kc['list_major_scan']:.3g} "
        f"({kc['ivf_flat_ties']} ids at ties), ivf_pq_scan, bq_scan and the "
        f"beam walk equal bit for bit (max |dd| {kc['ivf_pq_scan']}, "
        f"{kc['bq_scan']}, {kc['beam_search']}) in {kc['seconds']:.2f} s")
    log(f"[bench] prims small: {len(pr['records'])} records, no error, "
        f"{pr['seconds']:.2f} s; kernel prims against their plain versions: "
        f"{pr['max_abs_err']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[bench] launches {launches}; phase split "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out.items()
                    if k.endswith("_s")))
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "bench.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    log(f"[bench] {state.get('card')}: results in {path}")


def _record(name, source, replaces, launches, err, ms, plain_ms, nbytes,
            ops: dict, lib_ms, link_bytes: int = 0, **extra):
    """One kernel's record; ``ops`` counts operations by type (keys of
    PEAK_OPS_PER_S), each type's time over its peak bounds the call;
    ``nbytes`` move over device memory and ``link_bytes`` over the host
    link, each at its own rate (the two run at once, so the larger time
    bounds the call). ``extra`` keys (other shapes, routes) are added as
    they are."""
    t_bytes = max(nbytes / PEAK_BYTES_PER_S,
                  link_bytes / HOST_LINK_BYTES_PER_S) * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[kind] * 1e3 for kind, n in ops.items())
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, **extra}
    log(f"[times] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}), bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes} bytes"
        + (f" + {link_bytes} host-link bytes" if link_bytes else "") + ", "
        + ", ".join(f"{n:.4g} {kind}" for kind, n in ops.items()) + " ops)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="env,build,kernels,main,serve,ragged,"
                            "distance,pq,stream,dist,meshserve,observe,"
                            "fleet,prims,bench,times")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: raft_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    state: dict = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    state["card"] = phase_env(torch)["card"]
    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        timed("kernels", phase_kernels, torch, args.seed)
    records = []
    if "main" in phases:
        timed("main", phase_main, torch, args.seed, state)
        if "serve" in phases:
            timed("serve", phase_serve, torch, state)
            if "ragged" in phases:
                timed("ragged", phase_ragged, torch, state)
    if "distance" in phases:
        if "index" not in state:
            distance_alone(torch, args.seed, state)
        timed("distance", phase_distance, torch, state)
    if "pq" in phases:
        if "gt_i" not in state:
            pq_data(torch, args.seed, state)
        timed("pq", phase_pq, torch, state)
    if "stream" in phases or "dist" in phases:
        stream_alone(torch, args.seed, state)
        timed("stream", phase_stream, torch, state)
    if "dist" in phases:
        timed("dist", phase_dist, torch, state)
        if "meshserve" in phases:
            timed("meshserve", phase_meshserve, torch, state)
        if "observe" in phases:
            timed("observe", phase_observe, torch, state)
    if "fleet" in phases and "index" in state:
        timed("fleet", phase_fleet, torch, state)
    if "prims" in phases:
        timed("prims", phase_prims, torch, args.seed, state)
    if "bench" in phases:
        timed("bench", phase_bench, torch, args.seed, state)
    if "main" in phases:
        if "times" in phases:
            records = timed("times", phase_times, torch, state)
        if "profile" in phases:
            timed("profile", phase_profile, torch, state)
    faulthandler.cancel_dump_traceback_later()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
