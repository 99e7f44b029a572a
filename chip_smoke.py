#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--items 10000000] [--port 0]

Phases, each reported on its own lines:

1. ``env``       — the card (``nvidia-smi`` name and power limit), CUDA
                   and torch versions.
2. ``build``     — compiles every kernel under
                   ``predictionio_tpu_torch/csrc`` with nvcc for sm_90a,
                   one nvcc per source, all at once (set-up time).
3. ``kernels``   — holds each hand-written kernel against its plain
                   PyTorch version on the card.
                   B2, the shortlist kernel, at the serving shapes (rank
                   32, tile 16384, 10M items so the last tile is ragged),
                   B in {1, 8, 64}, c in {1, 16} and every c the serve
                   phase's query kinds run at (the scorer's own rule,
                   ``twostage_cand``), with and without an exclusion
                   mask: vals within rtol 1e-5 / atol 1e-5 (f32 sums in
                   another order); ids equal wherever the plain version's
                   neighbouring values differ by more than that. Each B2
                   row also records its device time (``graph_ms``: calls
                   captured in a CUDA graph, no host time) and the launch
                   plan the wrapper picked (``ops/kernels.shortlist_plan``:
                   the finish C (2/4/8 per-thread lists, 16 a queue a
                   row, 0 every key kept), rows per group, cluster size,
                   staged items and the bytes of each row a stage holds,
                   where the sort runs, shared memory,
                   whether the product runs on the tensor cores; such rows'
                   bound counts two TF32 products a score at 495 TFLOP/s).
                   Three tie-heavy rows (``TIE_B2_SHAPES``) are held exactly
                   to a stable sort: values and ids.
                   B1, the batched SPD solve, at K in {10, 16, 32, 64} x
                   S in {1, 129, 27000, 138000} on systems built like a
                   half-sweep's (the Gramian of seeded factors over up to
                   24 ratings, its ridge 0.01 * max(cnt, 1) and the 1e-6
                   jitter; about 1% of segments empty), both with the
                   ridge passed as ``diag`` (the trains' call) and with it
                   summed into A: max |x - x_plain| <= 1e-4 * max(1,
                   max |x_plain|) (f32 Cholesky in another order), empty
                   segments exactly 0, A unchanged. Each row records the
                   call's time (CUDA events over back-to-back calls) and
                   the kernel's device time (a CUDA graph of the calls,
                   replayed: no host time), its regime (as the built
                   library reports its boundary) and whether A and b fit
                   in the 50 MB L2 (then the time is warm and is not a
                   share of the bound).
4. ``train``     — the training main path at the full width of the
                   reference's ML-20M ALS bench: 20M synthetic ratings
                   over 138,000 users x 27,000 items
                   (``synthetic_ratings``, seed 20), rank 10, 20
                   iterations, reg 0.01, chunk 16384, the ``full``
                   solver, through ``ALSData.build`` and ``train_als``.
                   Checks: exactly 40 SPD kernel launches counted from
                   zero, a finite RMSE on the first 1M ratings, and a
                   twin train from the same initial factors with
                   ``PIO_TPU_SOLVE=vec`` (the plain solve, no launch)
                   within ``TWIN_TOL``. Then a ``subspace`` leg on the
                   same data (rank 64, block 16, 3 iterations): 24
                   launches at K = 16, held to its plain twin the same
                   way. Then a ``full_r64`` leg: the ``full`` solver at
                   rank 64, 3 iterations, 6 launches at K = 64, held to
                   its plain twin the same way. Each leg first runs one
                   uncounted train (a process's first train is 2-3x
                   slower), and after the timed one a profiled train for
                   the device's busy time and idle share.
5. ``lifecycle`` — the system's own lifecycle at the reference
                   pipeline bench's ML-100k shape (943 x 1682, 100,000
                   ratings and 50 buys; rank 10, 20 iterations, reg
                   0.01), every step through the port's CLI in
                   subprocesses on a fresh store chosen by
                   ``PIO_STORAGE_*`` (sqlite for events and metadata,
                   ``localfs`` for model blobs): ``eventserver``, ``app
                   new`` and ``accesskey new``; all 100,050 events over
                   ``POST /batch/events.json``, 50 a request from 8
                   client threads (every one 201, the store holding
                   exactly the acknowledged ids, a sample read back
                   unchanged through ``GET /events/<id>.json``, a bad
                   key 401, one malformed event in a batch 400 beside
                   49 201s); ``train`` (instance COMPLETED, release v1,
                   40 SPD launches); ``deploy`` of the latest release and
                   20 queries plus unknown users against the exact
                   top-10 of v1's factors on the card (same ids up to
                   ties, scores within 1e-4); 10,000 more events with
                   100 new users, ``train`` (v2, 40 launches); ``GET
                   /reload`` (200, v2's instance), new users answered,
                   the top-10s those of v2's factors, ``GET
                   /releases.json`` listing v2 and v1, ``POST /stop``,
                   and the event server draining on SIGTERM. Then, in
                   this process on the same data: ``train_als`` with
                   ``Checkpointer(interval=5)`` (40 launches) and a
                   20-iteration train resuming a step-10 snapshot (20
                   launches), both within ``TWIN_TOL`` of the straight
                   run.
6. ``foldin``    — online fold-in (``deploy/foldin``), two legs. Leg 1,
                   inside the lifecycle after the v2 checks: ``deploy``
                   of v2 with ``PIO_FOLDIN=1`` and a 0.25 s apply interval
                   (the reference bench's, bench.py:1914-1922); 120 new
                   users x 8 rate events over the event server in the
                   other process (the pull path), one user a request 4 ms
                   apart, every 4th probed until answered (event ->
                   reflected p50/p95, held to the bench's bound p95 <=
                   interval + the longest apply + 0.5 s); 8 more ratings
                   for 20 sampled users; 5 new items rated by 10 users
                   each. Checks: every folded user's served top-10 equal
                   to the exact top-10 of rows recomputed here by
                   ``FoldInSolver`` on the plain solve from v2's factors
                   and the stored events (ids up to ties, scores within
                   1e-4); a whiteList of the new items serves them; the
                   controls' answers unchanged unless a new item belongs
                   in their top-10; the deploy's B1 launches equal the
                   controller's solves, every apply's solve on the card;
                   a LIVE drift release over v2, v2 RETIRED; then
                   ``rollback``: the sampled and control answers byte
                   for byte as before, the new users unknown, the drift
                   ROLLED_BACK. Leg 2, beside the lifecycle after the
                   eval legs, on the serve cell's model (built once, in
                   this process):
                   ``FoldInSolver`` over the 10M x 64 factors on the card,
                   256 users x 8 ratings batched (1 launch) against one
                   at a time (256), explicit and implicit (the Gramian
                   once per solver), rows within 1e-4 * max(1, max |x|)
                   of the plain solve and the batched solve at least 5x
                   the rows/s (bench.py:1967); a ``QueryServer`` (twostage,
                   shortlist ``SHORTLIST``) with its controller and a
                   ``WriteBuffer`` flush tap (the push path), the same
                   stream and bound, user-only folds keeping the
                   quantized scorer, the folded users served through B2
                   with recall@10 >= 0.99 against the exact top-10 of
                   their rows; then 16 new items (24 raters each), the
                   scorer rebuilt (and parity-gated) before the swap, and
                   a user aligned with each new item served it first,
                   through B2 if the gate kept twostage, else exactly.
7. ``serve``     — the same model (10M items x rank 64, 138,493 users,
                   factors with a geometrically decaying spectrum from
                   ``--seed``), saved and deployed
                   with ``python -m predictionio_tpu_torch.cli.main
                   deploy`` under ``PIO_SCORER_MODE=twostage`` (tile
                   16384, shortlist ``SHORTLIST``) and POSTs
                   ``/queries.json``: plain, blackList, whiteList,
                   unknown user and num above the shortlist. It checks
                   that the scorer serves twostage (not parity-demoted)
                   at the shapes the kernels phase checked, that the
                   server's launch counts are zero once it is warm (it
                   zeroes them just before it takes traffic) and that the
                   shortlist kernel launched for every scored query,
                   recall@10 >= 0.99 against an exact top-10 computed on
                   the card, served scores equal to the exact f32 scores
                   within 1e-4, and that blacklisted items are absent.

8. ``canary``    — staged rollouts (``deploy/canary``) at the serve
                   cell's width: the same 10M x 64 model as v1, served
                   by a ``QueryServer`` in this process over HTTP
                   (twostage, fold-in on with the push tap, a 1 s apply
                   interval), and v2 and v3 from ``--seed`` + 1 and + 2
                   stored as COMPLETED instances, ``localfs`` blobs and
                   releases. ``POST /deploy.json`` of v2 as a canary at
                   fraction 0.2 (window 200, 20 samples, promote after
                   100): its prepare split (blob load, scorer build,
                   parity gate and its recall, warm-up, verify; a
                   candidate gated to exact fails the phase); 8 new users
                   x 8 ratings streamed while it is judged (no apply
                   runs, all 8 stay pending); sequential single queries
                   until the verdict, each answer the exact f32 top-10
                   of the arm that served it (the arms' factors differ,
                   so the ids show the arm) and one B2 launch each; the
                   realized split round(N * 0.2) +-1; the verdict
                   promote, and ``/releases.json`` reading v2 LIVE and
                   v1 RETIRED on the request after ``/deploy/status.json``
                   shows no canary; the held users folded (B1 at K = 64)
                   within one interval plus one apply of the verdict and
                   answered. Then 200 queries, ``POST /deploy.json`` of
                   v3 as a shadow, the same 200 queries: every answer
                   v2's, B2 twice a query, the incumbent's p50 beside
                   its p50 before; ``POST /rollback.json`` answers
                   "Canary aborted" and the next ``/releases.json`` reads
                   v3 ROLLED_BACK. Its CLI leg runs inside the
                   lifecycle, after the fold-in leg, at the ML-100k
                   shape: ``deploy`` of v2 with ``--feedback
                   --event-server-app --log-url --log-prefix`` (the sink
                   a stdlib HTTP server here that sleeps 2 s before it
                   answers); 50 queries write 50 ``predict`` events, each
                   with its answer's ``prId``; a failing query gets its
                   400 in under 0.5 s and the sink the prefixed body;
                   ``undeploy`` stops the server, which exits 0 within
                   5 s.

9. ``engines``   — the other three ALS engines (e-commerce,
                   similar-product, recommended-user), in two legs.
                   Leg 2, right after the train phase, in this process
                   on its ML-20M arrays: ``train_cooccurrence`` (n 20) on
                   the integer codes takes the card's slabbed int8
                   product (never the host path), 64 seeded items'
                   lists recounted exactly on the host (int64 bincount
                   over each item's users, lowest-id ties) and a planted
                   incidence with counts 255, 256, 257, 300 and 5000
                   exact; then implicit ALS on the train phase's data
                   (rank 10, 10 iterations, 20 B1 launches), V
                   row-normalized as a ``SimilarityModel`` over 27,000
                   ids, ``ALSAlgorithm.batch_predict`` under twostage at
                   B in {1, 8, 64} (B2 at T = 16384, two tiles, c = 256):
                   every answer the exact lane's, one B2 launch a batch.
                   Leg 1, beside the train phase (see "Order" below),
                   each engine through the CLI on its own sqlite store
                   (events written with ``insert_batch``, the
                   engine.json naming the reference's factory string):
                   e-commerce at cfg_ecommerce's shape (bench.py:741-760;
                   2,000 x 1,500, 200,000 views and buys, 4 categories, 10
                   unavailable items; rank 10, 10 iterations), its query
                   paths (known users, categories, whiteList, blackList,
                   an unknown user's recent views, popularity) against a
                   numpy recompute from the stored model; a second
                   variant with unseenOnly deployed with ``PIO_FOLDIN=1``,
                   8 new users x 8 views and 5 buys of one item folded in
                   (rows against a plain-solve recompute, popularity + 5,
                   B1 launches = the controller's solves); similar-product
                   at cfg_cooccurrence's ML-1M shape (bench.py:665-676;
                   a quarter of its events, 250,000 views and 25,000
                   likes/dislikes, to fit the time limit; als,
                   likealgo and cooccurrence in one engine) deployed
                   under ``PIO_SCORER_MODE=twostage`` with shortlist 1024
                   (the default 512 demotes its als catalog, in both
                   packages; both gates reported), 40 plain queries
                   from 8 concurrent clients (the micro-batcher forms
                   batches) and a categories and a whiteList query (the
                   exact lane), each the first algorithm's exact
                   recompute, B2 launches = 2 x the fused batches, both
                   scorers active; recommended-user at the smoke's own
                   shape (6,040 users, 100,000 follows without
                   self-follows; rank 10, 10 iterations), 20 queries
                   against a numpy recompute. Every train launches B1 2 x
                   iterations per ALS algorithm, counted from zero.
                   Answers: scores within 1e-4 relative, ids equal up to
                   ties (the ties at the cut included). The kernels phase
                   also holds B2 at these engines' shapes: R in {8, 10},
                   (3,706 items, T 4096, c 512 and 1024) and (27,000
                   items, T 16384, c 256), B in {1, 8, 64}, masked and
                   unmasked.

10. ``eval``     — ``pio eval``'s k-fold x hyperparameter ALS sweep
                   (``models/als_sweep``), in three legs, each counting
                   B1 launches from zero. Leg 1, after the engines'
                   width leg: the reference bench's eval_sweep_grid
                   (bench.py:282-294, 779-870; 943 x 1,682, 100,000
                   ratings from seed 5, 3 folds, 5 iterations, ranks
                   {8, 12} x regs {0.01, 0.02, 0.05, 0.1, 0.2, 0.4},
                   chunk 16384, precision@10 and the top-N MSE), run
                   batched (2 groups of 18 units: exactly 20 launches,
                   at S = 16,974 and 30,276), one unit at a time (360)
                   and batched on the plain solve (``PIO_TPU_SOLVE=vec``,
                   0): the same best (rank, reg), every candidate's
                   held-out RMSE within 1e-4, equal test and qualifying
                   counts, hits within max(1, nQual // 100); seconds,
                   candidates/s, the batched side's build / upload /
                   train / metric split, and from one more batched
                   sweep under the profiler B1's kernel time over its
                   trains and the device's idle share of its wall.
                   Leg 2, on the train phase's ML-20M arrays before
                   they are freed: rank 10, regs {0.01, 0.05, 0.1}, 3
                   folds, 2 iterations, held-out RMSE only: exactly 4
                   launches over 9 units (S = 1,242,000 and 243,000),
                   held to its plain twin within ``EVAL_TWIN_TOL``
                   and profiled as leg 1 is. Leg 3,
                   inside the lifecycle on its store: the smoke writes
                   an evaluation module (PrecisionAtK(k=10) and
                   RMSEMetric on the recommendation engine) into its
                   work directory, on ``PYTHONPATH``, and runs ``eval
                   --grid rank=8,12 --grid reg=0.01,0.1`` (batched, 20
                   launches, ``best.json`` the best candidate's params),
                   then ``--sequential`` on ranks {8, 12} at reg 0.01
                   (60 launches, the batched run's best of those two),
                   then
                   a failing evaluation (exit 1): two EVALCOMPLETED
                   instances and one EVALFAILED. The kernels phase holds
                   B1 at the four eval shapes too.

11. ``batchpredict`` — ``pio batchpredict`` (``workflow/batch_predict``),
                   in three legs. Leg 2, after the canary phase, on the
                   serve cell's 10M x 64 model in this process
                   (twostage, tile 16384, scan rank 32, shortlist 1024;
                   chunk 1,024, pipelined): 16,384 plain queries of num
                   10 (16 full chunks, B2 at B = 1,024, c 2), then 1
                   chunk (cut from 2 for the time limit) in which 1 query
                   in 6 carries a one-item blackList (a dense [1,024,
                   10M] mask a chunk, c 16);
                   each part: B2 launches equal to its chunks, no lane
                   fallback, the scorer still on twostage, 64 spread
                   rows (every masked row of the first masked chunk too)
                   equal to an exact recompute on the card (ids up to
                   ties, scores within 1e-4) with recall@10 >= 0.99;
                   rows/s and the split: read/decode, score, B2 (CUDA
                   events), uploads, rescore, serialize, file writes.
                   Leg 1, during the build in a process of its own
                   (see "Order" below): the reference bench's
                   cfg_batch_predict shape (bench.py:2251-2300; 5,000
                   users x 2,000 items, rank 32, num 50, 40,000 queries,
                   chunk 1,024, exact scorer) through
                   ``run_batch_predict(loaded=...)``, inline, pipelined
                   and as a 2-process fleet on the one card (ready/go
                   rendezvous, manifest merge), one timed round each
                   (cut from the bench's best of 2 for the time limit):
                   queries/s, which scorer path ran, the three outputs
                   the same answers (ids and order exact, scores within
                   1e-5 relative); no kernel runs there. Leg 3, inside
                   the lifecycle after eval's CLI leg: ``batchpredict``
                   through the CLI on the latest release, one query per
                   user and 5 planted malformed lines (``invalid`` 5, the
                   sidecar those rows), a 2-shard CLI run into the same
                   output name (the merge holds the single run's
                   answers), and a deployed query server answering 60 of
                   the users as the batch run did (ids exact, scores
                   within rel 1e-5 / abs 1e-6). The kernels phase holds
                   B2 at B = 1,024 too (unmasked c 2, masked c 16 at 10M
                   items): the kernel at the full B, 16 spread rows
                   (the first and the last) held to the plain version run
                   on those rows; ``plain_ms`` is that subset's,
                   ``library_ms`` the composite in blocks of 128 rows.

12. ``obs``      — the serving observability plane, after the serve
                   phase, on its 10M x 64 model through B2. Legs 1, 3
                   and 4 on a ``deploy`` of the serve phase's model file
                   with tracing, the anatomy, a server.json SLO spec (a
                   latency objective at 16 ms and an errors one, the
                   reference's 300 s / 3600 s windows) and telemetry at
                   a 1 s interval under a fresh PIO_HOME. Leg 1: 34
                   queries from one client, 384 from 8 (cfg_telemetry's
                   per_level and n_clients, bench.py:2502-2503); every
                   traced request has each stage of
                   ``SERVING_WALL_STAGES`` and the middleware's own
                   stage around the handler, and they sum to its
                   middleware wall within 10% or 0.5 ms (each set's
                   gap, wall - the stages' sum, and its middleware
                   stage printed first: the largest with its request,
                   the p99); B2's launches
                   equal the micro-batches scored and the ``shortlist``
                   dispatches; each stage's p50/p99 beside the HTTP
                   ones. Leg 4: ``POST /debug/profile`` for 2 s while 8
                   clients run 384 more: the trace names
                   ``shortlist_kernel``, a second capture 409, no query
                   fails. Leg 3: ``/history/range.json`` counts every
                   query sent, ``/slo.json``'s latency window equals the
                   served histogram's share above 16 ms, ``/capacity.
                   json``'s scorer bytes are the scorer's tiles and
                   scales and within the allocator's live bytes. Then,
                   in this process: leg 2, the plane's p99 cost at 8
                   clients, alternating best-of-2 (the bench's best-of-3,
                   cut for the time limit; bench.py:1140-1238,
                   :2538-2591): tracing with an SLO engine ticking every
                   50 ms against ``PIO_TRACING=0``, the anatomy against
                   ``PIO_ANATOMY=0`` (tracing on both) and telemetry at
                   a 50 ms scrape against none, recorded beside the
                   reference's 5% + 0.3 ms (not gated); leg 3's restart: a server with
                   the SLO spec and telemetry runs a canary of a v2
                   (the served users over a 4,096-item catalog) at 0.2
                   and stops mid-rollout; a second server on the same
                   store rehydrates the SLO windows (the history's span)
                   and resumes the split at the persisted accumulator;
                   a second live writer of the store gets TSDBLocked;
                   and the reference bench's store legs (10,000 series x
                   12 ticks: samples/s, a range read, a quantile over
                   time). The lifecycle also starts its event server
                   with ``--stats``: after the REST ingest its /metrics
                   counts each ``/batch/events.json`` request by status,
                   ``/stats.json`` the events by name, and every submit
                   has its ``flush_wait`` and ``commit`` stages. The
                   foldin phase's SLO leg, in the lifecycle on v2: the
                   served traffic breaches a 0.5 ms latency objective, a
                   fold-in tick of 32 of leg 1's stream users defers
                   (``pio_foldin_applies_total{outcome="deferred"}``,
                   the rows pending, no launch); once the 2 s window
                   clears the next tick applies them through one B1
                   launch and one ``spd_solve`` dispatch, their answers
                   the exact top-10 of leg 1's plain-solve rows.

13. ``fleet``    — the serving fleet and continuous training, after the
                   batchpredict phase's width leg, in three legs. Leg 2
                   on the serve cell's 10M x 64 model, stored as a
                   COMPLETED instance, ``localfs`` blob and LIVE release:
                   ``router --replicas 2 --device cuda`` through the CLI
                   (twostage, tile 16384, shortlist 1024; a server.json
                   SLO of a 2 ms latency bound over a 1 s window, which
                   any traffic breaches; ``PIO_FLEET_*`` 2 to 3 replicas,
                   a 6 s burn sustain, idle under 30 queries/s for 2 s, a
                   1 s cooldown; the leg's other bursts stay shorter). Steady: 384 queries at 8 clients through
                   the router, each the exact top-10 of its user on the
                   card, each replica's ``pio_router_requests_total``
                   within +-1 of half, the replicas' B2 launches equal to
                   their micro-batches, one query's trace id in the
                   router's and in exactly one replica's
                   ``/debug/traces.json``, HTTP p50/p99 through the router
                   against direct to one replica at 1 and 8 clients, and
                   the router's pid without a CUDA context while each
                   replica's has one (``nvidia-smi --query-compute-apps``,
                   or the processes that map libcuda). Autoscaling: 8
                   clients until the sustained breach starts a scale-up,
                   then a trickle under the idle rate: the third replica
                   healthy within 60 s (each replica's RSS then), the
                   fleet drained back to 2 with no failed query, both
                   actions archived ``done`` under the fleet's state
                   directory. Cutover: a v2 (V perturbed from the seed)
                   registered, ``POST /deploy.json`` to the router cuts
                   both replicas over in rank order (each replica's
                   prepare time, and the longest ``/slo.json`` or
                   ``/deploy/status.json`` probe seen meanwhile), both
                   answer v2's exact top-10, ``POST /rollback.json``
                   brings both back to v1's. Kill: ``kill -9`` of a
                   replica under 8 clients, no query fails, the replica
                   ``pio_router_replica_healthy`` 0. Leg 1, the router
                   tier alone: the reference bench's fleet_scaling leg 1
                   (bench.py:2805-2958) over stub replicas (the port's
                   ``HttpServer``, 20 ms service, 1 slot, 3 clients a
                   replica, 2 s at 1, 2 and 4 replicas, cut from the
                   bench's 4 s for the time limit): no drop, an
                   exact spread, qps(4)/qps(1) >= 3 and p99(4) <= 2
                   p99(1) + 5 ms; no kernel runs there. Leg 3, beside
                   the train phase, one cycle of ``orchestrate`` through
                   the CLI on a store of its own at the ML-100k shape
                   (100,000 ratings written directly): ``train`` and
                   ``deploy`` of a baseline, a
                   first ``orchestrate --once`` (no trigger; the
                   watermark), 600 fresh events over REST, then
                   ``orchestrate --once --server --eval-class`` with a
                   smoke query file, queries driving the server's canary:
                   the ingest trigger fires, the cycle promotes, its
                   ``orch_*`` events (and the train's and eval's) share
                   one trace id, its train launched B1 40 times, its eval
                   gate B1, its smoke B2, the canary window's B2 launches
                   equal the batches scored, and the served top-10s are
                   the promoted release's stored factors'. Then
                   ``PIO_FAULT_KILL=orch:canary:armed orchestrate --once
                   --force`` dies, and ``orchestrate --once`` unwinds it:
                   one LIVE release, no CANARY, the killed candidate
                   ROLLED_BACK, the served answers unchanged. The
                   orchestrator runs as ``orch_cli_worker``, which calls
                   the CLI and writes its flight recorder and launch
                   counts out on exit.

14. ``multitenant`` — ``pio multiserve``'s host (``server/multitenant``),
                   after the fleet phase, in three legs. Leg 2 on the
                   serve cell's 10M x 64 model, stored as a COMPLETED
                   instance, ``localfs`` blob and release that both
                   tenants serve, in a host in this process (served over HTTP on a loop
                   thread): ``rec`` twostage (tile 16384, shortlist 1024,
                   B2) and ``rec8`` fused int8 (the plain torch scan, no
                   kernel), a reload wait of 120 s and no background
                   sweep. A block of 64 queries (num 10, one user each,
                   the same users in every block) to each, then the
                   budget set to 1.2x the larger tenant's ledger bytes
                   (both never fit) and a sweep, then a second block to
                   each: each tenant evicted and warm-reloaded, every
                   answer 200 and equal to its first block's (ids up to
                   ties, scores within 1e-4), ``rec``'s the exact top-10
                   on the card by the serve phase's rule, B2 launches
                   equal to ``rec``'s micro-batches and none for
                   ``rec8`` (each block after its first query, which may
                   reload), every eviction lowering
                   ``torch.cuda.memory_allocated()`` by at least the
                   tenant's ledger ``residentBytes`` less 1 MiB, every
                   reload back at the bytes before its eviction, and
                   ``pio_mt_resident_bytes_total`` within the budget
                   after each sweep; eviction ms, each reload's split
                   (load, warm-up, verify, the scorer build within them,
                   swap), the first query after an eviction and each
                   tenant's steady p50/p99. Leg 1: the reference bench's
                   cfg_multitenant (bench.py:3139-3465; 20,000 items x
                   64, 400 users, seed 23): recommendation under fused
                   int8, similar-product under fused bf16 and
                   recommended-user, each first served alone (32 untimed
                   queries, then 300), then consolidated in one host
                   under 0.8x the standalone residencies' sum (two
                   passes, 16 untimed queries before each tenant's 300, a
                   sweep after each): evictions and warm reloads > 0,
                   every answer 200, the end residency <= budget < the
                   standalone sum; the p50/p99 of both runs reported
                   beside the reference's 1.15x slack (not gated). Leg 3,
                   inside the lifecycle after batchpredict's CLI leg:
                   ``multiserve`` in its own process with two tenants of
                   the ML-100k variant, queries through
                   ``/t/NAME/queries.json`` (each the exact top-10 of
                   v2), ``/tenants.json``, ``/residency.json`` and each
                   tenant's ``deploy/status.json`` through the mount, and
                   neither jax nor the reference in its ``sys.modules``.
15. ``classify`` — the classification template (``models/naive_bayes``,
                   ``models/logreg``, ``models/forest``,
                   ``engines/classification``), right after the build,
                   in three legs. Leg
                   1: the reference bench's naive_bayes_spam
                   (bench.py:247-255, :712-738; 20,000 documents x 2,000
                   vocabulary of Poisson counts, seed 3, 40% spam):
                   ``train_multinomial_nb`` then ``predict`` on the same
                   X, both through the device branch (the model's branch
                   counts), accuracy > 0.9, log_prior/log_prob within
                   1e-5 of the float64 recompute (bench.py:258-269),
                   every label equal to the host branch's on a copy of
                   X; train and predict best of 3 with the cold compaction
                   and upload apart; the count and score products timed
                   alone (CUDA events) beside their bounds. Leg 2 on the
                   same corpus: logistic regression (200 Adam steps, lr
                   0.1, reg 1e-4) from ``initial_W(seed 0)``, its W and b
                   within 1e-4 * max(1, max |W|) of the port's CPU run
                   from the same W (the CPU test's tolerance), a step's
                   time as (200 steps - 0 steps) / 200; the forest (10
                   trees, depth 4, 32 bins, auto: 45 features a node,
                   gini) with each level's histogram time, its votes equal
                   to a numpy walk of its own trees at full width, its
                   node arrays equal to the CPU fit's on the first 4,000
                   documents; one level's histogram timed alone at the
                   deepest level's shape. Leg 3: the template through the
                   CLI on a fresh store: 10,000 ``$set`` users of the
                   classification_app law (tests/test_engines.py:129-145)
                   over the event server, ``template get classification``,
                   ``train`` of ``naive``, ``logreg`` and ``randomforest``
                   at once (the engine.json naming the reference's factory
                   string), their ``deploy``s and one ``eval`` (Accuracy,
                   eval_k 3, the three algorithms) at once; 200 queries a
                   variant, each answering the label a numpy recompute from
                   the stored model gives; logreg's Accuracy > 0.85;
                   every train, deploy and eval process holding neither
                   jax nor the reference in ``sys.modules``; in this
                   process a second ``aggregate_scan`` of the unchanged
                   app hits the scan cache and the scan after one more
                   event misses it. No kernel runs in this phase.
16. ``sessionrec`` — the session-recommendation template
                   (``ops/attention``, ``models/seqrec``,
                   ``engines/sessionrec``), in two legs. Leg 1, in this
                   process: the template's widths (d_model 64, 2 heads, 2
                   layers, max_len 32, batch 128, lr 1e-3, seed 7; 1
                   epoch, cut from the template's 10 for the leg's 60 s)
                   over ML-20M's catalog as BERT4Rec uses it
                   (138,493 users x 26,744 items, V 26,745), sessions of
                   2-64 items from ``--seed`` with a planted law (the
                   next item the current + 1 with probability 0.8, else
                   a Zipf-popular one): the first step's loss and
                   gradients on the card against the port's CPU run of
                   the same step from the same init and batch (loss
                   within 1e-5 relative, each gradient within 1e-4
                   relative Frobenius norm); ``train_seqrec`` on the card
                   (the last epoch's mean loss below the first 10
                   steps'); 1,000 ``recommend_next(..., 10)`` on the card
                   against the CPU model of the same arrays (scores
                   within 1e-4, ids equal up to near-ties) and the
                   planted law's hit@10 (recorded); a step timed alone
                   (host clock synchronised, CUDA events), a few under
                   the profiler (top device ops, idle share) beside the
                   step's bound. Leg 2, in a process of its own: the
                   template through the CLI on a fresh store: 2,000
                   users' 5-30 views along a cyclic 200-item catalog
                   over the event server, ``template get sessionrec``,
                   ``train`` and ``deploy`` (the engine.json naming the
                   reference's factory string), 200 queries over HTTP,
                   each the stored model's answer recomputed on the CPU,
                   the learned successor in the top 10 of at least half;
                   neither jax nor the reference in the train's or the
                   deploy's ``sys.modules``. No kernel runs in this phase.
17. ``loadtest`` — the partitioned event store, its commit lanes and
                   ``pio loadtest``'s storm (``storage/partitioned``,
                   ``storage/audit``, ``data/write_buffer``,
                   ``loadtest/*``), in a process of its own (the fleet
                   sets ``PIO_INGEST_PARTITIONS`` and ``PIO_SERVER_CONF``
                   for its whole process), in three legs. Leg 1, host
                   work only: the reference bench's ``ingest_write``
                   partition curve (bench.py:1783-1866): 8,192 events
                   open loop in batches of 256 with 24 outstanding,
                   ``flush_max`` 256, ``linger_s`` 0.004, ``queue_max``
                   2^20, a 30 ms commit wall injected by
                   ``FaultyEvents(ops=("insert_batch",))``, P in {1, 2,
                   4}, best of 2 at each: no drop, failure or timeout,
                   8,192 rows held, the audit clean, events/s at each P
                   and at least the bench's 2.5x at P 4 over P 1. Leg 2:
                   cfg_loadtest's leg 1 (bench.py:3040-3077): a
                   ``LocalFleet`` of 2 replicas with fold-in behind the
                   router over 2 partitions (sqlite), the replicas, the
                   orchestrator's trains and fold-in on the card;
                   population 200,000, items 20,000, 24 s at 400/s,
                   amplitude 0.5, mix 0.6 / 0.3 / 0.1, ``maxOutstanding``
                   256, a retrain at 9.6 s, p99 bounds of 2,000 ms: every
                   invariant of ``run_storm``'s report (freshness
                   included), the exactly-once audit over every acked id,
                   a cycle promoted mid-run, B1's launches counted from
                   zero around the fleet equal to its trains' (6 each)
                   and its fold-in solves, B2's reported (0 under the
                   replicas' exact scorer, which the leg says); ops/s,
                   each lane's ack p99, the audited events and the rows
                   folded in. Leg 3, on leg 2's store: ``reshard -p 4``,
                   ``reshard -p 2`` and ``compact`` through the CLI,
                   after each the audit clean against the same ledger and
                   the training read's rows those before it (as a
                   multiset).
18. ``distributed`` — multi-process training and the sharded scorer
                   (``parallel/*``, ``models/als.build_distributed``,
                   ``ops/scoring.ShardedScorer``, the classifiers,
                   cooccurrence, the eval sweep and seqrec over a mesh),
                   in seven legs. Legs 1-2 and 4-7 run, in that order,
                   in two processes of one gloo group on the
                   card (``dist_worker``: the repo root on
                   ``PYTHONPATH``, a free loopback port, gloo on ``lo``;
                   a rendezvous or run past its bound fails the phase and
                   kills both). Leg 1: the train phase's width (ML-20M
                   ``synthetic_ratings``, seed 20; rank 10, 20
                   iterations, reg 0.01, the ``full`` solver), each
                   process holding its ``contiguous_range`` slice of the
                   COO, ``build_distributed`` (one row exchange a side)
                   and ``train_als`` over the 2-position process mesh,
                   an uncounted train first: B1 40 times in each process
                   counted from zero, U and V equal across the processes
                   within 1e-5, both within ``TWIN_TOL`` of the train
                   phase's one-process train from the same initial
                   factors, the digest its ``ALSData.build``'s; the
                   exchange's rows, bytes and seconds, the all-gathers'
                   ms a half-sweep, the train's wall. Leg 2: the
                   recommendation engine at the ML-100k shape on a sqlite
                   store of its own (100,000 rate events written with
                   ``insert_batch``): the DataSource's sharded read (a
                   strict subset in each process, the two summing to the
                   total) and ``ALSAlgorithm.train`` (B1 40 times in each
                   process); the answers to 100 queries equal a
                   one-process train's (ids up to ties, scores within
                   1e-4). Leg 3, after the obs phase, alone on the card:
                   the serve cell's model under ``PIO_SCORER_SHARDS=2``
                   (twostage, tile 16384, shortlist 1024), in this process
                   (12 batches, B 1 and 8, and a whitelist batch of 8
                   inside the second shard): both shards twostage,
                   ``maxShardFactorBytes`` <= half the catalog's f32
                   bytes < ``exactBytes``, B2 launches = 2 x the batches,
                   every top-10 the host's exact top-10 (ids up to ties,
                   scores within 1e-5); then ``deploy`` of the serve
                   phase's file with two shards over HTTP: the serve
                   phase's 24 plain queries answered as the unsharded
                   server answered them, B2 launches = 2 x the queries,
                   the merged recall probe and p50 beside the unsharded
                   p50. Between the two, mode ``exact`` with two shards
                   in this process on the same batches: each shard's
                   rows on the card and every batch allocating there (no
                   host product), no B2, the same exact top-10s.
                   Legs 4-7, in the processes of legs 1-2 after them,
                   each then checked here against one process on the
                   card. Leg 4: the classify phase's spam width (20,000
                   x 2,000 Poisson, bench.py:247-255): naive Bayes (its
                   mesh branch), logistic regression (200 Adam steps)
                   and the forest (10 trees, depth 4, 32 bins) over the
                   2-position process mesh, each process then predicting
                   its own whole X (naive Bayes on its resident X on
                   the card): the log-probs, the forest's node arrays
                   and every answer equal to one process's, logreg's W
                   and b within ``LOGREG_TOL``. Leg 5:
                   ``cooccurrence_topn_distributed`` at the ML-1M shape
                   (6,040 x 3,706, 1,000,000 events, bench.py:674), each
                   process passing every other event: counts and ids
                   exactly a one-process ``cooccurrence_topn``'s (its
                   slabbed product on the card). Leg 6:
                   ``run_sweep`` over the eval grid (``EVAL_GRID``)
                   across the processes, one rank group each: B1 10
                   times in each process, the merged results the
                   one-process sweep's (``_hold_sweeps``). Leg 7: seqrec
                   at the template's widths over ML-20M's catalog (V
                   26,745), 40 steps (``DIST_SR``): (a) a data 1 x model
                   2 mesh across the processes against the same mesh in
                   one process on the card, each step's loss and every
                   parameter within ``DIST_SR_TOL``, the answers equal
                   on both and the one process's; (b) here, a data 2 x
                   seq 2 mesh of positions on the card with ring
                   attention against flash, ``emb`` within 2e-4; (c)
                   ``ulysses_attention`` against ``mha`` on the card.
                   Each leg reports its
                   seconds, its bytes and seconds in host-staged
                   collectives, and leg 7 its ms a step and their share.

19. ``operator`` — the operator's surface (``utils/server_config``'s
                   ``ServerConfig`` and ``ServingConfig``, TLS on
                   ``server/http``, ``data/webhooks``, ``server/admin``,
                   ``server/dashboard``, the CLI's ``export``, app,
                   channel and key commands, ``analyze``, ``version``,
                   ``run`` and ``shell``), in two legs. Leg 1, inside the
                   lifecycle beside the eval, batchpredict and
                   multiserve CLI legs, on its store and event server:
                   ``export`` of the app right after train v2 (before the
                   fold-in leg writes more events), ``app new`` and
                   ``import`` of the file into a second app (its events
                   the source's as a multiset: properties, times and
                   ids), a train of a variant on it (40 B1 launches; for
                   ``OPERATOR["users"]`` users and unknown ones its
                   top-10s v2's, ids up to ties, scores within 1e-4);
                   ``OPERATOR["hook_events"]`` rate events one a request
                   through ``POST /webhooks/examplejson.json`` and
                   ``exampleform.json`` (form-encoded), the reference's
                   segmentio and mailchimp payloads, each beside the
                   event it stands for through ``POST /events.json`` into
                   another app: both apps' events equal as multisets
                   (ids and creation times aside); ``GET
                   /webhooks/<name>.json`` and an unknown connector
                   answer the reference's messages; ``app channel-new``,
                   ``app data-delete --channel`` (that channel empty, the
                   default one untouched), ``app channel-delete``,
                   ``accesskey delete`` (the key 401 at the running
                   event server), ``app delete --force`` (no event, key
                   or channel left); ``version``, ``run`` of a module and
                   ``shell`` fed a line on stdin. Leg 2, after obs: a
                   ``deploy`` of the serve phase's model file under a
                   server.json with a key, TLS (a certificate of
                   ``openssl req -x509``; without openssl the leg prints
                   ``tls: no openssl on this host`` and serves plain
                   HTTP) and ``serving`` {batchMax 8, batchInflight 2},
                   ``PIO_BATCH_LINGER_S`` 0.002, durable telemetry and
                   the anatomy: the serve phase's plain users over HTTPS
                   from one client, then ``OPERATOR_SERVE["queries"]``
                   from 64 clients, every top-10 the serve phase's
                   answer (ids up to ties, scores within 1e-4); B2
                   launches above 0 and equal to the micro-batches, none
                   above 8 in ``pio_batch_size``; ``POST /stop`` without
                   the key 401 and a plain-HTTP request refused; then
                   ``analyze --json --since 10m`` over its telemetry
                   root (every serving stage counted once a query), and
                   ``adminserver`` and ``dashboard`` (started beside the
                   deploy, the same server.json) over a copy of the
                   lifecycle's store: the admin app round-trip and
                   ``/cmd/releases`` (v1 and v2), the dashboard's 401
                   without the key, its console's releases, SLO and
                   capacity sections, ``/evaluations.json`` (the eval
                   leg's completed evaluations) and
                   ``/history/series.json`` (the deploy's series).
                   The HTTPS p50/p99 stand beside the serve phase's
                   plain-HTTP ones.
20. ``evlog``    — the evlog event store (``native/evlog`` over
                   ``csrc/evlog.cc``, built with g++ into
                   ``build/torch_kernels/``; ``storage/evlog_backend``),
                   in two legs, every one on the native codec (a failed
                   build or load fails the run). Leg 1, host work only,
                   in a process of its own during the build: ML-1M's
                   1,000,209 ratings (6,040 x 3,706, 30 days of event
                   times) as event JSON of the lifecycle's shape
                   (``Event.to_json``'s, checked on a sample), appended
                   in batches of 20,000 through the native codec and
                   through ``PyCodec``: the two files byte for byte
                   equal; each codec scans the other's file whole (every
                   record), over the middle half of its times and for
                   one user's hash (the counts numpy gives), then
                   verifies it; each codec's append, scan, window,
                   entity and verify seconds and MB/s. Also the port's
                   postgres source, on a machine with neither driver:
                   ``StorageError`` naming both. Leg 2, in a process of
                   its own beside the train phase, on its own store
                   (EVENTDATA an ``evlog`` source with ``CODEC=native``,
                   METADATA sqlite, MODELDATA ``localfs``): ``app new``,
                   the lifecycle's ML-100k shape (943 x 1,682, 100,000
                   ratings; rank 10, 20 iterations, reg 0.01) over
                   ``POST /batch/events.json`` (the write buffer into
                   ``EvlogEvents.insert_batch``), the store holding
                   exactly the acknowledged ids; ``DELETE`` of one event
                   and its ``GET`` 404; ``export``, its bag the posted
                   one less the deleted event; ``train`` (B1 40 times
                   in its process; the split of its wall: the evlog read
                   with its decode, the build, ``train_s``); the same
                   events in the log's order into a sqlite store and a
                   twin ``train`` (B1 40); ``deploy`` under twostage
                   (shortlist ``SHORTLIST``) and 100 queries over HTTP,
                   each the exact top-10 of the sqlite twin's factors
                   (scores within ``EVLOG_TOL`` x max(1, |score|), ids
                   equal up to ties within it), B2's launches equal to
                   the micro-batches scored; ``POST /stop`` and the
                   event server's drain.
21. ``check``    — static analysis of the port's own tree
                   (``analysis``, the reference's ``pio check``), in
                   two legs. Leg 1, host only, in a process of its own
                   during the build: ``python -m
                   predictionio_tpu_torch.cli.main check`` in four
                   processes at once: the whole tree as JSON (exit 0,
                   ``ok``, the 13 rule ids, every ``.py`` under
                   ``predictionio_tpu_torch/`` plus this file scanned, no
                   finding, no parse error; its wall, file count and
                   finding counts on lines of their own), ``-r PIO004
                   predictionio_tpu_torch/data/write_buffer.py`` (exit
                   0), a path outside the root (exit 2) and
                   ``--list-rules`` (the 13 ids). Leg 2, on the card
                   right after the kernels phase: the entry module
                   (``predictionio_tpu_torch/entry.py``), ``entry()``'s
                   top-10 against an f64 recompute and
                   ``dryrun_multichip(2)`` over two positions of the
                   card (a sharded ALS step, a seqrec dp x tp step), B1
                   launched 4 times (one a position a half-sweep)
                   counted from zero around it.

Order, for the time limit: batchpredict's, evlog's and check's legs 1
(no kernel) run each in a process of its own while nvcc builds; then the
distributed phase's legs 1-2 and 4-7 with nothing beside them (their
processes' launches are their own; leg 1's factors are held to the
train phase's after it), then the classify phase alone; after the
kernels phase, check's leg 2 alone on the card, then the lifecycle
(with the eval, batchpredict and multitenant CLI legs and the operator
phase's leg 1 inside it, the four at once), the engines' three CLI legs, the fleet's orchestrated cycle,
sessionrec's leg 2 and evlog's leg 2 run each in a process of its own,
each on its own store, while this process runs the train phase, the
engines' width leg, eval legs 1-2, sessionrec's leg 1 and the fold-in
width leg; then the
other phases on the serve cell's model, one at a time (the operator
phase's leg 2 and the distributed phase's leg 3 after obs); then the
loadtest phase, alone. The kernels
phase and the phases of the serve cell share the card with no other
work; a leg run beside others has its times taken under that load.

Each phase's launch counts are its own: zeroed just before the phase
drives its path and read just after (in the process that launched).
Then it prints one JSON line describing each kernel (times from this
run, CUDA events), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Without a CUDA device, or outside a checkout of the repo, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores (both kernels' products are exact f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: dense TF32 on the tensor cores, where B2's plan puts the product there
TF32_FLOPS = 495e12

TOL = 1e-5
#: B1 against its plain version: max |dx| <= SPD_TOL * max(1, max |x|)
SPD_TOL = 1e-4
#: a train against its plain-solve twin from the same initial factors:
#: relative Frobenius distance of U and of V, and the relative RMSE gap
#: (index_add_ sums in a run-dependent order and the solves round
#: differently, and 20 sweeps carry the differences along)
TWIN_TOL = 1e-3

#: the reference's ML-20M ALS bench (bench.py:592-663, cfg_als_ml20m)
ML20M = dict(n_users=138_000, n_items=27_000, nnz=20_000_000, seed=20,
             rank=10, iters=20, reg=0.01, chunk=16_384)
#: its subspace leg: the als_kernel bench's rank and block
#: (bench.py:895-897), 3 iterations
SUBSPACE = dict(rank=64, block=16, iters=3)
#: its full-solver leg at the als_kernel bench's rank 64 (bench.py:951),
#: 3 iterations: B1 at K = 64
FULL_R64 = dict(rank=64, iters=3)
#: the reference's pipeline bench shape (bench.py:466, cfg_pipeline_ml100k)
ML100K = dict(n_users=943, n_items=1682, nnz=100_000, rank=10, iters=20,
              reg=0.01, buys=50, queries=20)

#: the reference bench's eval_sweep_grid (bench.py:282-294, config
#: bench.py:779-870): 3 folds x 12 candidates, 5 iterations, chunk
#: 16384; the rank metrics of the DASE metrics (query_num 10, precision
#: k 10, threshold 2.0)
EVAL_GRID = dict(n_users=943, n_items=1682, nnz=100_000, seed=5, folds=3,
                 iters=5, ranks=(8, 12),
                 regs=(0.01, 0.02, 0.05, 0.1, 0.2, 0.4), chunk=16_384,
                 rank_metrics=(10, 10, 2.0))
#: the eval phase's width leg on the train phase's ML-20M arrays
EVAL_WIDTH = dict(rank=10, regs=(0.01, 0.05, 0.1), folds=3, iters=2)
#: the eval phase's CLI leg on the lifecycle's store: the batched grid,
#: then the sequential loop on its ranks at the first reg
EVAL_CLI = dict(ranks=(8, 12), regs=(0.01, 0.1), iters=5, folds=3)
#: candidates within this held-out RMSE of each other across the eval
#: sides (batched, one unit at a time, the plain solve)
EVAL_RMSE_TOL = 1e-4
#: the width leg's held-out RMSE against its plain-solve twin, relative:
#: the same assembly feeds both solves, so only the solves' rounding
#: (and index_add_'s order) parts them over 2 iterations
EVAL_TWIN_TOL = 1e-6

#: the serve phase's two-stage shortlist. The reference default, 512, is
#: under one candidate per tile at 10M items (611 tiles): a query loses
#: a top-10 item whenever two of them share a tile (about 7% of
#: queries), and the build-time parity gate (recall@10 >= 0.99 over 8
#: probe queries) demotes the scorer to exact — it did at seed 0 (probe
#: recall 0.975 on an NVIDIA H100 80GB HBM3, 700 W). 1024 gives each
#: tile two candidates.
SHORTLIST = 1024
TILE = 16384
SCAN_RANK = 32     # 96% of the serve model's spectrum, rounded up to 8

#: the serve phase's query kinds: (num, masked). The kernels phase checks
#: the kernel at the per-tile candidate count each kind runs at.
QUERY_KINDS = {"plain": (10, False), "blackList": (10, True),
               "whiteList": (10, True),
               "num>shortlist": (SHORTLIST + 500, False)}


#: the card; the phases' functions take every tensor there
DEV = "cuda"


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs
    (``tools/kernel_ab.event_ms``, the A/B tool's timer)."""
    from predictionio_tpu_torch.tools import kernel_ab

    return kernel_ab.event_ms(fn, iters, warmup)


@contextlib.contextmanager
def solve_env(value):
    """``PIO_TPU_SOLVE`` set to ``value`` inside the block (None: left
    as it is), restored after it."""
    # pio: ignore[PIO006]: save/restore around the solver toggle
    saved = os.environ.get("PIO_TPU_SOLVE")
    if value is not None:
        os.environ["PIO_TPU_SOLVE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PIO_TPU_SOLVE", None)
        else:
            os.environ["PIO_TPU_SOLVE"] = saved


def graph_ms(fn, launches: int, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn()`` without its host time, a
    CUDA graph of ``launches`` calls replayed ``reps`` times
    (``tools/kernel_ab.graph_ms``)."""
    from predictionio_tpu_torch.tools import kernel_ab

    return kernel_ab.graph_ms(fn, launches, reps)


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def shortlist_bound_ms(b: int, n_items: int, r: int, cand: int, nt: int,
                       masked: bool, tensor_cores: bool = False):
    """Least time for the shortlist function on these inputs: every
    input byte read once and every output byte written once over HBM
    bandwidth, or its operations over the peak of the unit that does
    them: the dot products' multiply-adds on the CUDA cores (f32), or,
    where the plan puts the product on the tensor cores, two TF32
    products a score (u split into hi and lo halves) at the dense TF32
    rate; the scale multiply on the CUDA cores either way."""
    bytes_ = (n_items * r + n_items * 4 + b * r * 4
              + (b * n_items if masked else 0) + b * nt * cand * 8)
    dots = 2.0 * b * n_items * r
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    if tensor_cores:
        t_ops = (2 * dots / TF32_FLOPS + b * n_items / F32_FLOPS) * 1e3
    else:
        t_ops = (dots + b * n_items) / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_shortlist(got, ref_wide, cand: int):
    """(max_abs_err, problems) of kernel output vs the plain version's
    top-(cand+1) per tile ([B, nt, cand+1]; the extra column exposes
    near-ties at the cut)."""
    import torch

    gv, gi = got
    rv, ri = ref_wide
    b = gv.shape[0]
    nt = rv.shape[1]
    gv = gv.reshape(b, nt, cand)
    gi = gi.reshape(b, nt, cand)
    ref_v, ref_i = rv[..., :cand], ri[..., :cand]
    fin = torch.isfinite(ref_v)
    problems = []
    if not torch.equal(fin, torch.isfinite(gv)):
        problems.append("finite pattern differs")
    close = torch.isclose(gv, ref_v, rtol=TOL, atol=TOL) | (~fin & ~torch.isfinite(gv))
    if not bool(close.all()):
        problems.append(f"{int((~close).sum())} values outside tolerance")
    diff = (gv - ref_v).abs()
    max_err = float(diff[fin].max()) if bool(fin.any()) else 0.0
    # ids must agree where the value is separated from both neighbours
    # (within the tile's list, and from the first value past the cut)
    tol = TOL + TOL * rv.abs()
    sep_next = (rv[..., :cand] - rv[..., 1:cand + 1]).abs() > tol[..., :cand]
    sep_prev = torch.ones_like(sep_next)
    sep_prev[..., 1:] = (rv[..., 1:cand] - rv[..., :cand - 1]).abs() > tol[..., 1:cand]
    must = fin & sep_next & sep_prev
    bad = must & (gi != ref_i)
    if bool(bad.any()):
        problems.append(f"{int(bad.sum())} ids differ at separated values")
    return max_err, problems


def kernels_phase(seed: int, n_items: int):
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import (
        shortlist_per_tile, shortlist_topc, shortlist_topc_reference,
        twostage_cand,
    )

    dev = torch.device("cuda")
    r, t = SCAN_RANK, TILE
    nt = -(-n_items // t)
    per_tile = shortlist_per_tile(SHORTLIST, nt, t)
    served = {kind: twostage_cand(per_tile, nt, t, num, masked)
              for kind, (num, masked) in QUERY_KINDS.items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randint(-127, 128, (nt, t, r), generator=g, device=dev,
                          dtype=torch.int8)
    scales = (0.5 + torch.rand((nt, t), generator=g, device=dev)) / 127.0
    deq = (tiles.float() * scales[..., None]).reshape(nt * t, r)
    results = []
    max_err = 0.0
    for b in (1, 8, 64):
        u = torch.randn((b, r), generator=g, device=dev)
        mask_all = torch.rand((b, nt * t), generator=g, device=dev) < 0.3
        for masked in (False, True):
            mask = mask_all if masked else None
            for cand in sorted({1, 16, *served.values()}):
                kernels.reset_counts()
                got = shortlist_topc(u, tiles, scales, n_items, mask, cand)
                torch.cuda.synchronize()
                check(kernels.SHORTLIST_LAUNCHES == 1,
                      "shortlist wrapper did not launch its kernel")
                wide = shortlist_topc_reference(u, tiles, scales, n_items,
                                                mask, cand + 1)
                ref_wide = (wide[0].reshape(b, nt, cand + 1),
                            wide[1].reshape(b, nt, cand + 1))
                err, problems = compare_shortlist(got, ref_wide, cand)
                check(not problems, f"shortlist B={b} c={cand} masked="
                      f"{masked}: {'; '.join(problems)}")
                max_err = max(max_err, err)
                ms = cuda_ms(lambda: shortlist_topc(
                    u, tiles, scales, n_items, mask, cand), iters=10)
                plain_ms = cuda_ms(lambda: shortlist_topc_reference(
                    u, tiles, scales, n_items, mask, cand), iters=2)

                def library():
                    # two-call composite (no single PyTorch call computes
                    # the function): product over pre-dequantized f32
                    # factors, then top-c per tile
                    sc = torch.matmul(u, deq.T)
                    sc[:, n_items:] = float("-inf")
                    if mask is not None:
                        sc = sc.masked_fill(mask, float("-inf"))
                    return torch.topk(sc.view(b, nt, t), cand, dim=2)

                library_ms = cuda_ms(library, iters=3)
                device_ms = graph_ms(lambda: shortlist_topc(
                    u, tiles, scales, n_items, mask, cand), launches=4)
                plan = kernels.shortlist_plan(b, nt, t, r, cand, masked)
                bound, bound_by = shortlist_bound_ms(
                    b, n_items, r, cand, nt, masked, plan.tensor_cores)
                row = {"B": b, "c": cand, "masked": masked,
                       "ms": ms, "device_ms": device_ms,
                       "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": err,
                       "plan": plan.as_dict()}
                results.append(row)
                log("kernels: shortlist " + json.dumps(row))
    # a masked batch ships its [B, n_pad] bool mask host -> device
    import numpy as np

    for b in (1, 8):
        m = np.zeros((b, nt * t), bool)
        ms = cuda_ms(lambda: torch.from_numpy(m).to(dev), iters=3)
        log(f"kernels: mask transfer B={b} {m.nbytes} bytes "
            f"{ms:.4f} ms (pageable host memory)")
    del tiles, scales, deq
    torch.cuda.empty_cache()
    kernels.reset_counts()
    return results, max_err, {"R": r, "T": t, "nt": nt, "n_items": n_items,
                              "c": served}


# ---------------------------------------------------------------------------
# kernels phase, B1: the batched SPD solve
# ---------------------------------------------------------------------------

SPD_SHAPES = [(k, s) for k in (10, 16, 32, 64)
              for s in (1, 129, 27_000, 138_000)]
#: B1 at the eval phase's half-sweeps: K 8 and 12 over the 18 units of a
#: group of the ML-100k grid (S = 18 x 943 users, 18 x 1,682 items), K 10
#: over the 9 units of the ML-20M width leg (9 x 138,000, 9 x 27,000)
EVAL_SPD_SHAPES = [(8, 16_974), (8, 30_276), (12, 16_974), (12, 30_276),
                   (10, 1_242_000), (10, 243_000)]
#: H100 L2 cache: inputs below this stay resident across timed launches
L2_BYTES = 50e6


def spd_bound_ms(s: int, k: int):
    """Least time for the solve: A, b and diag read once and x written
    once over HBM bandwidth, or its f32 multiply-adds (about K^3/3 for
    the factorization and 2K^2 for the substitutions, per system) over
    the f32 peak."""
    t_bytes = s * (k * k + 2 * k + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * s * (k ** 3 / 3 + 2 * k * k) / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_inputs(s: int, k: int, g):
    """Systems built like a half-sweep's on the card: the Gramian of
    seeded random factors over cnt <= 24 ratings and its ridge lam =
    reg * max(cnt, 1), kept apart; about 1% of segments empty (gram = 0,
    b = 0). Returns (gram, lam, b, empty)."""
    import torch

    dev = torch.device(DEV)
    n, reg = 24, 0.01
    cnt = torch.randint(1, n + 1, (s,), generator=g, device=dev)
    cnt[torch.rand((s,), generator=g, device=dev) < 0.01] = 0
    if s > 1:
        cnt[0] = 0                        # at least one empty segment
    w = (torch.arange(n, device=dev)[None, :] < cnt[:, None]).float()
    f = torch.randn((s, n, k), generator=g, device=dev) / k ** 0.5
    r = torch.randint(1, 6, (s, n), generator=g, device=dev).float()
    fw = f * w[..., None]
    gram = torch.bmm(fw.transpose(1, 2), f)
    lam = reg * cnt.clamp_min(1).float()
    b = torch.bmm(fw.transpose(1, 2), r[..., None])[..., 0]
    return gram.contiguous(), lam, b.contiguous(), cnt == 0


def spd_kernels_phase(seed: int):
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.linalg import (
        cholesky_solve_vec, spd_solve, with_diagonal,
    )

    g = torch.Generator(device=DEV).manual_seed(seed + 2)
    rows, max_err = [], 0.0
    jitter = 1e-6
    thread_max_k = kernels.spd_solve_thread_max_k()
    for k, s in SPD_SHAPES + EVAL_SPD_SHAPES:
        gram, lam, b, empty = spd_inputs(s, k, g)
        A = with_diagonal(gram, lam, jitter)
        gram0, A0 = gram.clone(), A.clone()
        kernels.reset_counts()
        x_diag = spd_solve(gram, b, lam, jitter)     # the trains' call
        x_sum = spd_solve(A, b)                      # the sum given
        synchronize()
        check(kernels.SPD_SOLVE_LAUNCHES == 2,
              "spd_solve wrapper did not launch its kernel")
        check(torch.equal(gram, gram0) and torch.equal(A, A0),
              f"spd K={k} S={s}: the kernel wrote A")
        plain = cholesky_solve_vec(A, b)
        scale = max(1.0, float(plain.abs().max()))
        n_empty = int(empty.sum())
        err = 0.0
        for name, x in (("diag", x_diag), ("summed", x_sum)):
            check(bool(torch.isfinite(x).all()),
                  f"spd K={k} S={s} {name}: non-finite")
            e = float((x - plain).abs().max())
            check(e <= SPD_TOL * scale, f"spd K={k} S={s} {name}: max "
                  f"|dx| {e} > {SPD_TOL} * {scale}")
            check(bool((x[empty] == 0).all()), f"spd K={k} S={s} {name}: "
                  f"an empty segment did not solve to 0")
            err = max(err, e)
        max_err = max(max_err, err)
        # small shapes take the wrapper's host time, not the kernel's:
        # many launches, after a warm-up, to keep that time steady
        n_it, n_warm = (10, 1) if s >= 27_000 else (200, 20)
        ms = cuda_ms(lambda: spd_solve(gram, b, lam, jitter), iters=n_it,
                     warmup=n_warm)
        device_ms = graph_ms(lambda: spd_solve(gram, b, lam, jitter),
                             launches=10 if s >= 27_000 else 50)
        plain_ms = cuda_ms(lambda: cholesky_solve_vec(
            with_diagonal(gram, lam, jitter), b), iters=3)
        library_ms = cuda_ms(lambda: torch.linalg.solve(A, b), iters=3)

        def chol():
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.cholesky_solve(b[..., None], L)

        chol_ms = cuda_ms(chol, iters=3)
        bound, bound_by = spd_bound_ms(s, k)
        in_bytes = s * (k * k + k + 1) * 4
        row = {"K": k, "S": s, "eval": (k, s) in EVAL_SPD_SHAPES,
               "regime": "thread" if k <= thread_max_k else "warp",
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_chol_ms": chol_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "fits_l2": in_bytes <= L2_BYTES,
               "max_abs_err": err, "max_abs_x": scale, "empty": n_empty}
        rows.append(row)
        log("kernels: spd_solve " + json.dumps(row))
        del gram, lam, A, b, x_diag, x_sum, plain, gram0, A0
    torch.cuda.empty_cache()
    kernels.reset_counts()
    return rows, max_err


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def synthetic_ratings(n_users, n_items, nnz, seed=0, implicit=False):
    """Copy of the reference bench's generator (bench.py:106-117):
    uniform users and items, ratings from a rank-4 latent model rounded
    and clipped to 1..5."""
    import numpy as np

    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, nnz).astype(np.int32)
    items = rng.integers(0, n_items, nnz).astype(np.int32)
    latent_u = rng.normal(size=(n_users, 4))
    latent_v = rng.normal(size=(n_items, 4))
    raw = np.einsum("nk,nk->n", latent_u[users], latent_v[items])
    if implicit:
        ratings = (raw > 0).astype(np.float32) + 1.0
    else:
        ratings = np.clip(np.round(2.5 + raw), 1, 5).astype(np.float32)
    return users, items, ratings


def _rel(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def device_profile(fn):
    """``fn()`` under the profiler: ``(its result, the device's busy ms,
    B1's kernel ms)``. Busy is the summed durations of the events the
    profiler ran on the card (kernels, copies, sets; one stream, so they
    do not overlap); B1's are those of the ``spd_*`` kernels. None where
    it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        synchronize()
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in cuda)
    b1 = sum(e.time_range.elapsed_us() for e in cuda if "spd_" in e.name)
    return (out, total / 1e3 if total > 0 else None,
            b1 / 1e3 if b1 > 0 else None)


def device_busy_ms(fn) -> float | None:
    """Device time of ``fn()`` in ms (:func:`device_profile`)."""
    return device_profile(fn)[1]


def _train_leg(name, data, params, init_V, users, items, ratings,
               want_launches):
    """One train on the card and its plain-solve twin from the same
    initial factors; returns the leg's report. An uncounted train first
    warms the process (the first train of a process runs 2-3x slower:
    library handles, allocator), so the timed one is steady; a profiled
    train after it gives the device's busy time per half-sweep and its
    idle share of the timed train's wall time."""
    import numpy as np

    from predictionio_tpu_torch.models.als import rmse, train_als
    from predictionio_tpu_torch.ops import kernels

    head = slice(0, 1_000_000)
    train_als(data, params, device=DEV, init_V=init_V)
    synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    U, V = train_als(data, params, device=DEV, init_V=init_V)
    train_s = time.perf_counter() - t0
    launches = kernels.counts()["spd_solve"]
    busy = device_busy_ms(
        lambda: train_als(data, params, device=DEV, init_V=init_V))
    check(launches == want_launches, f"{name}: {launches} SPD kernel "
          f"launches, expected {want_launches}")
    err = rmse(U, V, users[head], items[head], ratings[head])
    check(bool(np.isfinite(err)), f"{name}: RMSE is not finite")

    with solve_env("vec"):
        kernels.reset_counts()
        t0 = time.perf_counter()
        U2, V2 = train_als(data, params, device=DEV, init_V=init_V)
        plain_s = time.perf_counter() - t0
        check(kernels.counts()["spd_solve"] == 0,
              f"{name}: the plain twin launched the kernel")
    err2 = rmse(U2, V2, users[head], items[head], ratings[head])
    du, dv = _rel(U, U2), _rel(V, V2)
    drmse = abs(err - err2) / err2
    half = 2 * params.num_iterations
    report = {"leg": name, "launches": launches, "train_s": train_s,
              "half_sweep_ms": train_s / half * 1e3,
              "device_busy_half_sweep_ms":
                  None if busy is None else busy / half,
              "device_idle_share":
                  None if busy is None else 1 - busy / (train_s * 1e3),
              "plain_train_s": plain_s,
              "plain_half_sweep_ms": plain_s / half * 1e3,
              "rmse_1m": err, "plain_rmse_1m": err2,
              "rel_diff_U": du, "rel_diff_V": dv, "rel_diff_rmse": drmse}
    log("train: " + json.dumps(report))
    check(max(du, dv) <= TWIN_TOL, f"{name}: factors differ from the "
          f"plain twin by {max(du, dv)} > {TWIN_TOL}")
    check(drmse <= TWIN_TOL, f"{name}: RMSE differs from the plain twin "
          f"by {drmse} > {TWIN_TOL}")
    return report, (U, V)


def train_phase(spd_rows):
    import torch

    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, _init_item_factors, block_starts,
    )
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    c = ML20M
    t0 = time.perf_counter()
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = ALSData.build(users, items, ratings, c["n_users"], c["n_items"])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = data.put(make_mesh(devices=[torch.device(DEV)]))
    upload_s = time.perf_counter() - t0
    log(f"train: {c['nnz']} ratings, {c['n_users']} x {c['n_items']}: "
        f"synthesis {synth_s:.3f} s, build_s {build_s:.3f}, upload_s "
        f"{upload_s:.3f} (rows by user {tuple(data.by_user.tgt[0].shape)}, "
        f"by item {tuple(data.by_item.tgt[0].shape)})")
    dev = torch.device(DEV)
    params = ALSParams(rank=c["rank"], num_iterations=c["iters"],
                       reg=c["reg"], chunk_size=c["chunk"])
    init_V = _init_item_factors(data.n_items, data.n_items_pad, params.rank,
                                params.seed, dev).cpu().numpy()
    full, full_UV = _train_leg("full", data, params, init_V, users, items,
                               ratings, 2 * c["iters"])
    # the kernel's share of a half-sweep, from the kernels phase's times
    # at the two half-sweeps' shapes (S users and S items, K = rank)
    by = {(r["K"], r["S"]): r["ms"] for r in spd_rows}
    per_iter = by[(c["rank"], c["n_users"])] + by[(c["rank"], c["n_items"])]
    full["kernel_share"] = per_iter / (2 * full["half_sweep_ms"])
    full.update(build_s=build_s, upload_s=upload_s, synth_s=synth_s)

    sc = SUBSPACE
    sub_params = ALSParams(rank=sc["rank"], num_iterations=sc["iters"],
                           reg=c["reg"], chunk_size=c["chunk"],
                           solver="subspace", block_size=sc["block"])
    sub_V = _init_item_factors(data.n_items, data.n_items_pad, sc["rank"],
                               params.seed, dev).cpu().numpy()
    n_blocks = len(block_starts(sc["rank"], sc["block"]))
    sub, _ = _train_leg("subspace", data, sub_params, sub_V, users, items,
                        ratings, 2 * sc["iters"] * n_blocks)
    sub_ms = by.get((sc["block"], c["n_users"]), 0.0) + \
        by.get((sc["block"], c["n_items"]), 0.0)
    sub["kernel_share"] = sub_ms * n_blocks / (2 * sub["half_sweep_ms"])

    rc = FULL_R64
    r64_params = ALSParams(rank=rc["rank"], num_iterations=rc["iters"],
                           reg=c["reg"], chunk_size=c["chunk"])
    r64_V = _init_item_factors(data.n_items, data.n_items_pad, rc["rank"],
                               params.seed, dev).cpu().numpy()
    r64, _ = _train_leg("full_r64", data, r64_params, r64_V, users, items,
                        ratings, 2 * rc["iters"])
    r64["kernel_share"] = (by[(rc["rank"], c["n_users"])]
                           + by[(rc["rank"], c["n_items"])]) \
        / (2 * r64["half_sweep_ms"])
    summary = {"full": full, "subspace": sub, "full_r64": r64,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log("train: " + json.dumps({"summary": summary}))
    # the engines phase's width leg reuses the arrays and the uploaded
    # layout; the distributed phase's leg 1 is held to the full leg's
    # factors and the build's digest
    return summary, {"users": users, "items": items, "ratings": ratings,
                     "data": data, "full_UV": full_UV}


# ---------------------------------------------------------------------------
# eval phase
# ---------------------------------------------------------------------------

def _sweep_side(data, cands, rank_metrics, batched=True, solve=None):
    """One counted sweep: (result, wall s, B1 launches)."""
    from predictionio_tpu_torch.models.als_sweep import run_sweep
    from predictionio_tpu_torch.ops import kernels

    with solve_env(solve):
        synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = run_sweep(data, cands, rank_metrics=rank_metrics,
                        batched=batched, device=DEV)
        synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.counts()["spd_solve"]
    return res, wall, launches


def _best_of(res):
    best = min(res.candidates, key=lambda c: c.heldout_rmse)
    return (best.params.rank, best.params.reg)


def _hold_sweeps(name, sides, rank_metrics):
    """Every side of a sweep picks the same best (rank, reg); each
    candidate's held-out RMSE within ``EVAL_RMSE_TOL`` (relative to 1)
    and its test and qualifying counts equal; hits within max(1, nQual //
    100). Returns the largest RMSE gap and hit gap."""
    first = next(iter(sides.values()))
    bests = {k: _best_of(res) for k, res in sides.items()}
    check(len(set(bests.values())) == 1, f"{name}: best candidates "
          f"differ: {bests}")
    gap, hit_gap = 0.0, 0
    for other in sides.values():
        for a, b in zip(first.candidates, other.candidates):
            d = abs(a.heldout_rmse - b.heldout_rmse)
            gap = max(gap, d)
            check(d <= EVAL_RMSE_TOL * max(1.0, a.heldout_rmse),
                  f"{name}: held-out RMSE {a.heldout_rmse} vs "
                  f"{b.heldout_rmse} at {a.params.rank}/{a.params.reg}")
            check(a.n_test == b.n_test and a.n_qual == b.n_qual,
                  f"{name}: counts differ: {a.n_test}/{a.n_qual} vs "
                  f"{b.n_test}/{b.n_qual}")
            if rank_metrics is not None:
                denom = min(rank_metrics[0], rank_metrics[1])
                ha = round(a.precision * denom * a.n_qual)
                hb = round(b.precision * denom * b.n_qual)
                hit_gap = max(hit_gap, abs(ha - hb))
                check(abs(ha - hb) <= max(1, a.n_qual // 100),
                      f"{name}: hits {ha} vs {hb} of {a.n_qual}")
    return gap, hit_gap


def _profiled_sweep(data, cands, rank_metrics):
    """A batched sweep under the profiler: B1's share of its trains (B1's
    kernel ms over the trains' seconds) and the device's idle share of
    its wall, both from this one run (the profiler slows the host, so
    the idle share is an upper bound)."""
    (res, wall, _n), busy, b1 = device_profile(
        lambda: _sweep_side(data, cands, rank_metrics))
    return {"wall_s": wall, "train_s": res.seconds["train"],
            "device_busy_ms": busy, "b1_device_ms": b1,
            "b1_share_of_train": None if b1 is None
            else b1 / (res.seconds["train"] * 1e3),
            "device_idle_share": None if busy is None
            else 1 - busy / (wall * 1e3)}


def eval_grid_leg():
    """Leg 1 of the eval phase: the reference bench's eval_sweep_grid,
    batched (20 B1 launches), one unit at a time (360) and batched on
    the plain solve (0), each counted from zero."""
    import numpy as np

    from predictionio_tpu_torch.core.cross_validation import (
        fold_assignments,
    )
    from predictionio_tpu_torch.models.als import ALSParams
    from predictionio_tpu_torch.models.als_sweep import build_sweep_data

    c = EVAL_GRID
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    fold_of = fold_assignments(c["folds"], c["nnz"])
    t0 = time.perf_counter()
    data = build_sweep_data(users, items, ratings, fold_of, c["n_users"],
                            c["n_items"])
    build_s = time.perf_counter() - t0
    cands = [ALSParams(rank=r, num_iterations=c["iters"], reg=g,
                       chunk_size=c["chunk"])
             for r in c["ranks"] for g in c["regs"]]
    spec = c["rank_metrics"]
    units = len(c["regs"]) * c["folds"]
    # the first sweep of a process pays its allocations: one uncounted
    _sweep_side(data, cands, spec)
    batched, b_s, b_n = _sweep_side(data, cands, spec)
    sequential, s_s, s_n = _sweep_side(data, cands, spec, batched=False)
    plain, p_s, p_n = _sweep_side(data, cands, spec, solve="vec")
    profiled = _profiled_sweep(data, cands, spec)
    want = 2 * len(c["ranks"]) * c["iters"]
    check(b_n == want, f"eval grid: batched sweep launched B1 {b_n} "
          f"times, expected {want}")
    check(s_n == 2 * c["iters"] * len(cands) * c["folds"],
          f"eval grid: sequential sweep launched B1 {s_n} times")
    check(p_n == 0, f"eval grid: the plain twin launched B1 {p_n} times")
    check(batched.n_groups == len(c["ranks"])
          and batched.batch_sizes == [units] * len(c["ranks"]),
          f"eval grid: groups {batched.n_groups}, units per launch "
          f"{batched.batch_sizes}")
    for res in (batched, sequential, plain):
        check(all(np.isfinite(x.heldout_rmse) and x.n_test == c["nnz"]
                  for x in res.candidates), "eval grid: a candidate's "
              "held-out RMSE is not finite or misses test entries")
    gap, hit_gap = _hold_sweeps("eval grid", {
        "batched": batched, "sequential": sequential, "plain": plain}, spec)
    n = len(cands)
    report = {
        "candidates": n, "groups": batched.n_groups,
        "units_per_launch": batched.batch_sizes,
        "launches": {"batched": b_n, "sequential": s_n, "plain": p_n},
        "batched_s": b_s, "sequential_s": s_s, "plain_s": p_s,
        "candidates_per_s": {"batched": n / b_s, "sequential": n / s_s,
                             "plain": n / p_s},
        "speedup_batched_vs_sequential": s_s / b_s,
        "batched_split_s": {"build": build_s, **batched.seconds},
        "half_sweep_ms": batched.seconds["train"]
        / (2 * c["iters"] * batched.n_groups) * 1e3,
        "profiled": profiled,
        "best": _best_of(batched),
        "max_rmse_gap": gap, "max_hit_gap": hit_gap,
        "best_rmse": min(x.heldout_rmse for x in batched.candidates),
        "n_qual": batched.candidates[0].n_qual}
    log("eval: grid " + json.dumps(report))
    return report


def eval_width_leg(held):
    """Leg 2 of the eval phase, on the train phase's ML-20M arrays: a
    batched sweep of 3 regs x 3 folds at rank 10, 2 iterations, held-out
    RMSE only (4 B1 launches over 9 units), held to its plain-solve twin
    as the train phase holds its twin."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.core.cross_validation import (
        fold_assignments,
    )
    from predictionio_tpu_torch.models.als import ALSParams
    from predictionio_tpu_torch.models.als_sweep import build_sweep_data

    c, w = ML20M, EVAL_WIDTH
    t0 = time.perf_counter()
    data = build_sweep_data(held["users"], held["items"], held["ratings"],
                            fold_assignments(w["folds"], c["nnz"]),
                            c["n_users"], c["n_items"])
    build_s = time.perf_counter() - t0
    cands = [ALSParams(rank=w["rank"], num_iterations=w["iters"], reg=g,
                       chunk_size=c["chunk"]) for g in w["regs"]]
    res, wall, n = _sweep_side(data, cands, None)
    twin, twin_s, twin_n = _sweep_side(data, cands, None, solve="vec")
    profiled = _profiled_sweep(data, cands, None)
    units = len(cands) * w["folds"]
    check(n == 2 * w["iters"], f"eval width: B1 launched {n} times, "
          f"expected {2 * w['iters']}")
    check(twin_n == 0, f"eval width: the plain twin launched B1 {twin_n} "
          "times")
    check(res.batch_sizes == [units], f"eval width: units per launch "
          f"{res.batch_sizes}")
    gap = 0.0
    for a, b in zip(res.candidates, twin.candidates):
        check(np.isfinite(a.heldout_rmse) and a.n_test == c["nnz"],
              f"eval width: candidate {a.params.reg}: RMSE "
              f"{a.heldout_rmse}, {a.n_test} test entries")
        rel = abs(a.heldout_rmse - b.heldout_rmse) / b.heldout_rmse
        gap = max(gap, rel)
        check(rel <= EVAL_TWIN_TOL, f"eval width: held-out RMSE differs "
              f"from the plain twin by {rel} > {EVAL_TWIN_TOL}")
    check(_best_of(res) == _best_of(twin), "eval width: the plain twin "
          "picks another best")
    report = {
        "candidates": len(cands), "units": units, "launches": n,
        "systems_per_launch": [units * c["n_users"], units * c["n_items"]],
        "wall_s": wall, "plain_wall_s": twin_s,
        "split_s": {"build": build_s, **res.seconds},
        "plain_split_s": twin.seconds,
        "half_sweep_ms": res.seconds["train"] / (2 * w["iters"]) * 1e3,
        "profiled": profiled,
        "rmse": {str(x.params.reg): x.heldout_rmse for x in res.candidates},
        "rel_diff_rmse_plain": gap, "best": _best_of(res),
        "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log("eval: width " + json.dumps(report))
    return report


#: the evaluation module the CLI leg writes, as a user would
_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.recommendation import (
    AlgorithmParams, DataSourceParams, PrecisionAtK, RMSEMetric, engine,
)


def _params(app):
    return [EngineParams(
        data_source_params=DataSourceParams(
            app_name=app, eval_params={"kFold": FOLDS, "queryNum": 10}),
        algorithm_params_list=[("als", AlgorithmParams(
            num_iterations=ITERS))])]


evaluation = Evaluation(engine=engine(), metric=PrecisionAtK(k=10),
                        other_metrics=[RMSEMetric()], output_path=BEST)
evaluation.engine_params_list = _params(APP)
failing = Evaluation(engine=engine(), metric=PrecisionAtK(k=10),
                     output_path=None)
failing.engine_params_list = _params("NoSuchApp")
"""


def eval_cli_leg(env, work, app: str):
    """Leg 3 of the eval phase, on the lifecycle's store: ``eval`` of a
    user's evaluation module through the CLI, batched over the grid
    (B1 2 x groups x iterations), ``--sequential`` on its ranks at the
    first reg (2 x candidates x folds x iterations), picking the batched
    run's best of those two, and a failing evaluation that leaves
    EVALFAILED: the three at once, each in its own process."""
    import numpy as np

    from predictionio_tpu_torch.storage.registry import Storage

    c = EVAL_CLI
    # one module a run that writes its best params, as the runs go at once
    best_path, seq_best = work / "best.json", work / "best_seq.json"
    for module, best in (("smoke_eval", best_path),
                         ("smoke_eval_seq", seq_best)):
        (work / f"{module}.py").write_text(
            f"BEST = {str(best)!r}\nAPP = {app!r}\n"
            f"FOLDS = {c['folds']}\nITERS = {c['iters']}\n" + _EVAL_MODULE)
    env = dict(env, PYTHONPATH=os.pathsep.join(
        [str(work)] + [p for p in [env.get("PYTHONPATH")] if p]))
    grid = [f"rank={','.join(map(str, c['ranks']))}",
            f"reg={','.join(map(str, c['regs']))}"]

    def run(module, *extra):
        t0 = time.perf_counter()
        out = _cli(["eval", f"{module}:evaluation", "--device", DEV,
                    *extra], env)
        line = json.loads(out[-1])
        line["wall_s"] = time.perf_counter() - t0
        return line

    def failing():
        return subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             "eval", "smoke_eval:failing", "--device", DEV], cwd=str(ROOT),
            env=env, capture_output=True, text=True, timeout=600)

    # the ranks at the first reg: the pair differs in rank, not only in
    # the ridge, so their scores are apart by more than the run-to-run
    # noise of near-tied top-10 edges
    batched, sequential, proc = _together(
        lambda: run("smoke_eval", "--grid", grid[0], "--grid", grid[1]),
        lambda: run("smoke_eval_seq", "--grid", grid[0], "--grid",
                    f"reg={c['regs'][0]}", "--sequential"),
        failing)
    log("lifecycle: eval batched " + json.dumps(batched))
    n_cand = len(c["ranks"]) * len(c["regs"])
    want = 2 * len(c["ranks"]) * c["iters"]
    check(batched["mode"] == "batched" and batched["groups"]
          == len(c["ranks"]) and batched["candidates"] == n_cand,
          f"eval CLI: {batched['mode']} over {batched['groups']} groups")
    check(batched["launches"]["spd_solve"] == want, "eval CLI: batched "
          f"B1 launches {batched['launches']['spd_solve']}, expected "
          f"{want}")
    check(json.loads(best_path.read_text()) == batched["best_params"],
          "eval CLI: best.json is not the best candidate's params")
    log("lifecycle: eval sequential " + json.dumps(sequential))
    check(json.loads(seq_best.read_text()) == sequential["best_params"],
          "eval CLI: the sequential run's best.json is not its best "
          "candidate's params")
    want_seq = 2 * len(c["ranks"]) * c["folds"] * c["iters"]
    check(sequential["mode"] == "sequential"
          and sequential["launches"]["spd_solve"] == want_seq,
          f"eval CLI: sequential B1 launches "
          f"{sequential['launches']['spd_solve']}, expected {want_seq}")
    # the batched run's scores of those candidates
    pair = [s for j, (s, _o) in enumerate(batched["scores"])
            if j % len(c["regs"]) == 0]
    check(sequential["best_idx"] == int(np.argmax(pair)),
          f"eval CLI: sequential best #{sequential['best_idx']} "
          f"({sequential['scores']}), batched {pair}")
    check(proc.returncode == 1 and "[ERROR] Evaluation failed"
          in proc.stdout, f"eval CLI: the failing evaluation exited "
          f"{proc.returncode}: {proc.stdout[-500:]}")
    statuses = sorted(i.status for i in
                      Storage.get_meta_data_evaluation_instances().get_all())
    check(statuses == ["EVALCOMPLETED", "EVALCOMPLETED", "EVALFAILED"],
          f"eval CLI: evaluation instances {statuses}")
    report = {"batched": batched, "sequential": sequential,
              "instances": statuses,
              "candidates_per_s": {
                  "batched": n_cand / batched["eval_s"],
                  "sequential": len(c["ranks"]) / sequential["eval_s"]}}
    log("lifecycle: eval " + json.dumps(report["candidates_per_s"]))
    return report


# ---------------------------------------------------------------------------
# lifecycle phase
# ---------------------------------------------------------------------------

def _cli(args, env, timeout=600):
    """One port CLI command in a subprocess; its stdout lines."""
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)
    check(proc.returncode == 0, f"cli {args[0]} failed (rc "
          f"{proc.returncode}): {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    return proc.stdout.strip().splitlines()


def _wire(users, items, values, names):
    """Event Server JSON of (user, item, value, event name) rows."""
    return [{"event": e, "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{i}",
             **({"properties": {"rating": r}} if e == "rate" else {})}
            for u, i, r, e in zip(users, items, values, names)]


def ingest(port: int, key: str, events, threads: int = 8, per: int = 50):
    """POST ``events`` to ``/batch/events.json``, ``per`` a request, from
    ``threads`` clients; returns (the acknowledged id of each event, in
    the order of ``events``; request latencies in ms; wall seconds).
    Every event must be acknowledged 201."""
    import queue as _queue

    jobs = _queue.Queue()
    for s in range(0, len(events), per):
        jobs.put((s, events[s:s + per]))
    ids, lat, errors = [None] * len(events), [], []
    lock = threading.Lock()

    def client():
        c = Client(port)
        while True:
            try:
                start, batch = jobs.get_nowait()
            except _queue.Empty:
                return
            try:
                status, body, dt = c.call(
                    "POST", f"/batch/events.json?accessKey={key}", batch)
            except Exception as e:      # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            ok = status == 200 and [r["status"] for r in body] == \
                [201] * len(batch)
            with lock:
                lat.append(dt * 1e3)
                if ok:
                    ids[start:start + len(batch)] = [r["eventId"]
                                                     for r in body]
                else:
                    errors.append(f"{status} {str(body)[:200]}")

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(w.is_alive() for w in workers), "ingest clients hung")
    check(not errors, f"ingest: {len(errors)} requests failed, first "
          f"{errors[:3]}")
    return ids, lat, wall


def _factors_on_card(model, tag: str):
    import torch

    U = torch.from_numpy(model.U).to(DEV)
    V = torch.from_numpy(model.V).to(DEV)
    check(bool(torch.isfinite(U).all() and torch.isfinite(V).all()),
          f"{tag}: trained factors are not finite")
    return U, V


def _top10_err(U, V, model, user: str, body, tag: str) -> float:
    """One served top-10 against the exact top-10 of ``model``'s factors
    ``U``, ``V`` on the card: same ids up to ties within 1e-4, scores
    within 1e-4. Returns the largest score error."""
    import numpy as np
    import torch

    got = body["itemScores"]
    vals, idx = torch.topk(V @ U[model.user_index(user)], 10)
    want_ids = [str(model.item_vocab[j]) for j in idx.tolist()]
    vals = vals.cpu().numpy()
    got_ids = [x["item"] for x in got]
    check(len(got) == 10, f"{tag}: {user} got {len(got)} items")
    err = np.abs(np.array([x["score"] for x in got]) - vals)
    check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(vals))).all()),
          f"{tag}: {user}'s scores differ from the exact top-10 by "
          f"{float(err.max())}")
    for a, b_, v in zip(got_ids, want_ids, vals):
        tied = np.abs(vals - v) <= 1e-4 * max(1.0, abs(v))
        check(a == b_ or a in {want_ids[j]
                               for j in np.flatnonzero(tied)},
              f"{tag}: {user} served {got_ids}, exact {want_ids}")
    return float(err.max())


def check_top10(client, model, users, tag: str):
    """Each user's served top-10 against the exact top-10 of ``model``'s
    factors on the card (``_top10_err``). Returns (max score error,
    latencies in ms)."""
    U, V = _factors_on_card(model, tag)
    max_err, lat = 0.0, []
    for user in users:
        status, body, dt = client.call("POST", "/queries.json",
                                       {"user": user, "num": 10})
        check(status == 200, f"{tag}: query for {user} answered {status}")
        lat.append(dt * 1e3)
        max_err = max(max_err, _top10_err(U, V, model, user, body, tag))
    return max_err, lat


def _stored_model(instance_id: str):
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.workflow.serialization import (
        deserialize_models,
    )

    got = Storage.get_model_data_models().get(instance_id)
    check(got is not None, f"no model blob stored for {instance_id}")
    return deserialize_models(got.models, device=DEV)[0]


def smoke_store(work):
    """The CLI's environment for a fresh sqlite event store and a
    ``localfs`` model store under ``work``, configured in this process
    too (the smoke writes events, checks what the servers did and reads
    models there)."""
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.storage.registry import Storage

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, **{
        "PIO_STORAGE_SOURCES_SMOKE_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SMOKE_PATH": str(work / "pio.db"),
        "PIO_STORAGE_SOURCES_MODELS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_MODELS_PATH": str(work / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SMOKE",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SMOKE",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MODELS"})
    Storage.configure({
        "sources": {"SMOKE": {"TYPE": "sqlite", "PATH": str(work / "pio.db")},
                    "MODELS": {"TYPE": "localfs",
                               "PATH": str(work / "models")}},
        "repositories": {
            "METADATA": {"NAME": "pio_meta", "SOURCE": "SMOKE"},
            "EVENTDATA": {"NAME": "pio_event", "SOURCE": "SMOKE"},
            "MODELDATA": {"NAME": "pio_model", "SOURCE": "MODELS"}}})
    eventstore.clear_cache()
    return env


def event_server_obs(client, key: str, ingest_requests: int,
                     by_name: dict) -> dict:
    """The event server's plane after the lifecycle's REST ingest (the
    ingest's requests, a bad key's 401 and one batch with a malformed
    event): ``/metrics.json`` counts each ``/batch/events.json`` request
    by status, ``/stats.json`` (``--stats``) counts the events by name,
    and every submit to the write buffer has its ``flush_wait`` and
    ``commit`` stages."""
    _, mj, _ = client.call("GET", "/metrics.json")
    by_status = {}
    for smp in mj["pio_http_request_duration_seconds"]["samples"]:
        lb = smp["labels"]
        if lb["handler"] == "/batch/events.json":
            by_status[lb["status"]] = smp["count"]
    check(by_status == {"200": ingest_requests + 1, "401": 1},
          f"the event server's /metrics counts /batch/events.json "
          f"{by_status}, sent {ingest_requests + 1} + one 401")
    status, st, _ = client.call("GET", f"/stats.json?accessKey={key}")
    check(status == 200, f"/stats.json answered {status}")
    got = {}
    for row in st["longLive"]:
        if row["status"] == 201:
            got[row["event"]] = got.get(row["event"], 0) + row["count"]
    check(got == by_name, f"/stats.json counts {got}, ingested {by_name}")
    stages = {smp["labels"]["stage"]: smp["count"] for smp in
              mj["pio_anatomy_stage_seconds"]["samples"]
              if smp["labels"]["path"] == "ingest"}
    check(stages == {"flush_wait": ingest_requests + 1,
                     "commit": ingest_requests + 1},
          f"ingest anatomy counts {stages}, submits {ingest_requests + 1}")
    walls = {smp["labels"]["stage"]: 1e3 * smp["avg"] for smp in
             mj["pio_anatomy_stage_seconds"]["samples"]
             if smp["labels"]["path"] == "ingest"}
    return {"batch_requests_by_status": by_status, "stats": got,
            "ingest_stage_mean_ms": walls}


def lifecycle_phase(seed: int, port: int):
    import numpy as np

    from predictionio_tpu_torch.storage.registry import Storage

    c = ML100K
    work = WORK / "lifecycle"
    # this process reads the same store to check what the servers did
    env = smoke_store(work)
    events_srv = server = None
    try:
        # 1. event server, app and keys ------------------------------------
        events_srv = Server(["eventserver", "--ip", "127.0.0.1", "--port",
                             "0", "--stats"], env, tag="lifecycle")
        es_port = events_srv.wait_ready(timeout_s=120)
        out = _cli(["app", "new", "SmokeApp"], env)
        key = next(x for x in out if "Access Key:" in x).split()[-1]
        out = _cli(["accesskey", "new", "SmokeApp"], env)
        key2 = out[-1].split()[-1]
        app_id = Storage.get_meta_data_apps().get_by_name("SmokeApp").id

        # 2. the ML-100k events over REST ----------------------------------
        users, items, ratings = synthetic_ratings(
            c["n_users"], c["n_items"], c["nnz"], seed=seed)
        rng = np.random.default_rng(seed + 3)
        bu = rng.integers(0, c["n_users"], c["buys"])
        bi = rng.integers(0, c["n_items"], c["buys"])
        wire = _wire(users.tolist(), items.tolist(), ratings.tolist(),
                     ["rate"] * len(ratings))
        wire += _wire(bu.tolist(), bi.tolist(), [None] * c["buys"],
                      ["buy"] * c["buys"])
        ids, lat, wall = ingest(es_port, key, wire)
        n1 = len(wire)
        check(None not in ids and len(set(ids)) == n1,
              f"ingest acknowledged {len(set(ids) - {None})} distinct "
              f"events of {n1}")
        stored = Storage.get_events().find_columns(
            app_id, columns=("event_id",), ordered=False)["event_id"]
        check(len(stored) == n1 and set(stored.tolist()) == set(ids),
              f"the store holds {len(stored)} rows, "
              f"{len(set(stored.tolist()) & set(ids))} of the acknowledged "
              f"{n1} ids")
        client = Client(es_port)
        for j in rng.choice(n1, size=20, replace=False).tolist():
            status, body, _ = client.call(
                "GET", f"/events/{ids[j]}.json?accessKey={key}")
            check(status == 200, f"GET event answered {status}")
            sent = wire[j]
            check({k: body.get(k) for k in sent if k != "properties"}
                  == {k: v for k, v in sent.items() if k != "properties"}
                  and body["properties"] == sent.get("properties", {})
                  and body["eventId"] == ids[j],
                  f"event {ids[j]} read back as {body}, sent {sent}")
        status, _, _ = client.call(
            "POST", "/batch/events.json?accessKey=not-a-key", wire[:2])
        check(status == 401, f"a bad key answered {status}")
        probe = [dict(w, event="view") for w in wire[:49]] + [
            {"event": "view", "entityType": "user"}]
        status, body, _ = client.call(
            "POST", f"/batch/events.json?accessKey={key}", probe)
        check(status == 200 and [r["status"] for r in body]
              == [201] * 49 + [400],
              f"a batch with one malformed event answered {status} "
              f"{[r['status'] for r in body]}")
        ingest_obs = event_server_obs(client, key, len(lat), {
            "rate": len(ratings), "buy": c["buys"], "view": 49})
        ingest_report = {
            "events": n1, "requests": len(lat), "clients": 8,
            "events_per_s": n1 / wall, "wall_s": wall,
            "request_p50_ms": float(np.percentile(lat, 50)),
            "request_p99_ms": float(np.percentile(lat, 99)),
            "obs": ingest_obs}
        log("lifecycle: ingest " + json.dumps(ingest_report))

        # 3. train -> instance 1, release v1 -------------------------------
        variant = work / "engine.json"
        variant.write_text(json.dumps({
            "id": "default",
            "engineFactory": "predictionio_tpu_torch.engines."
                             "recommendation:engine",
            "datasource": {"params": {"appName": "SmokeApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": c["rank"], "numIterations": c["iters"],
                "lambda": c["reg"]}}]}))
        want = 2 * c["iters"]

        def train(n_events: int, release: int):
            t0 = time.perf_counter()
            out = _cli(["train", "--variant", str(variant), "--device",
                        DEV], env)
            line = json.loads(out[-1])
            line["wall_s"] = time.perf_counter() - t0
            log(f"lifecycle: train v{release} " + json.dumps(line))
            check(line["launches"]["spd_solve"] == want,
                  f"train v{release} launched the SPD kernel "
                  f"{line['launches']['spd_solve']} times, expected {want}")
            check(line["nnz"] == n_events, f"train v{release} read "
                  f"{line['nnz']} ratings of {n_events} events")
            check(line["release"] == release, f"train registered release "
                  f"{line['release']}, expected v{release}")
            inst = Storage.get_meta_data_engine_instances().get(
                line["instance"])
            check(inst is not None and inst.status == "COMPLETED",
                  f"instance {line['instance']} is not COMPLETED")
            return line

        t1 = train(n1, 1)
        m1 = _stored_model(t1["instance"])

        # 4. deploy the latest release --------------------------------------
        server = Server(["deploy", "--variant", str(variant), "--port",
                         str(port), "--device", DEV, "--accesskey", key],
                        env, tag="lifecycle")
        q_port = server.wait_ready(timeout_s=300)
        qc = Client(q_port)
        _, root, _ = qc.call("GET", "/")
        check(root["engineInstance"]["id"] == t1["instance"]
              and root["engineInstance"]["releaseVersion"] == 1,
              f"deploy serves {root['engineInstance']}, not release v1")
        picks = [str(m1.user_vocab[i]) for i in np.random.default_rng(
            seed + 4).choice(len(m1.user_vocab), size=c["queries"],
                             replace=False)]
        err1, lat1 = check_top10(qc, m1, picks, "v1")
        new_users = [f"u{c['n_users'] + j}" for j in range(100)]
        for user in new_users[:5] + ["nobody"]:
            status, body, _ = qc.call("POST", "/queries.json",
                                      {"user": user, "num": 10})
            check(status == 200 and body["itemScores"] == [],
                  f"v1 answered unknown {user}: {status} {body}")

        # 5. 10,000 more events (100 new users) -> train v2 ----------------
        r2 = np.random.default_rng(seed + 5)
        nu = np.concatenate([np.repeat(np.arange(c["n_users"],
                                                 c["n_users"] + 100), 20),
                             r2.integers(0, c["n_users"], 8000)])
        ni = r2.integers(0, c["n_items"], 10_000)
        nr = r2.integers(1, 6, 10_000).astype(float)
        more = _wire(nu.tolist(), ni.tolist(), nr.tolist(),
                     ["rate"] * 10_000)
        ids2, _, wall2 = ingest(es_port, key2, more)
        check(len(set(ids2)) == 10_000, "second ingest lost events")
        t2 = train(n1 + 10_000, 2)
        m2 = _stored_model(t2["instance"])
        # the operator phase's export: the app as v2 read it
        export = operator_export(env, work, "SmokeApp", app_id)

        # 6. GET /reload -> v2 ---------------------------------------------
        status, reload, reload_dt = qc.call("GET",
                                            f"/reload?accessKey={key}")
        check(status == 200
              and reload["engineInstanceId"] == t2["instance"]
              and reload["releaseVersion"] == 2,
              f"/reload answered {status} {reload}")
        status, first, first_dt = qc.call(
            "POST", "/queries.json", {"user": picks[0], "num": 10})
        check(status == 200 and len(first["itemScores"]) == 10,
              f"first query after the reload: {status} {first}")
        for user in new_users[:5]:
            status, body, _ = qc.call("POST", "/queries.json",
                                      {"user": user, "num": 10})
            check(status == 200 and len(body["itemScores"]) == 10,
                  f"v2 gave {user} {len(body['itemScores'])} items")
        err2, lat2 = check_top10(qc, m2, picks + new_users[:10], "v2")
        _, listing, _ = qc.call("GET", "/releases.json")
        versions = [r["version"] for r in listing["releases"]]
        check(versions == [2, 1] and listing["serving"]["releaseVersion"]
              == 2, f"/releases.json lists {versions}, serving "
              f"{listing['serving']}")
        status, _, _ = qc.call("POST", f"/stop?accessKey={key}")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the query server did not stop on POST /stop")
        # 7. the foldin phase's first leg, on v2 and the same event server
        t0 = time.perf_counter()
        foldin = foldin_lifecycle_leg(seed, env, variant, key, es_port,
                                      port, m2)
        foldin["leg_s"] = time.perf_counter() - t0
        # 7b. the foldin phase's SLO leg, in this process on v2
        t0 = time.perf_counter()
        foldin_slo = foldin_slo_leg(m2)
        foldin_slo["leg_s"] = time.perf_counter() - t0
        # 8. the canary phase's CLI leg, on v2 and the same store
        feedback = feedback_leg(seed, env, variant, key, port, app_id, m2)
        # 9-11. the eval, batchpredict and multitenant phases' CLI legs,
        #     at once on the same store: none writes what another reads
        def timed(leg, *args):
            t0 = time.perf_counter()
            rep = leg(*args)
            rep["leg_s"] = time.perf_counter() - t0
            return rep

        # 12. and the operator phase's CLI leg beside them: its apps and
        #     its variant are its own
        eval_cli, bp_cli, mt_cli, op_cli = _together(
            lambda: timed(eval_cli_leg, env, work, "SmokeApp"),
            lambda: timed(batchpredict_cli_leg, env, work, variant, key,
                          port),
            lambda: multiserve_cli_leg(env, work, variant, m2,
                                       t2["instance"]),
            lambda: timed(operator_cli_leg, seed, env, work, variant, key,
                          es_port, m2, export))
        log("multitenant: cli " + json.dumps(mt_cli))
        events_srv.stop()
        check(events_srv.proc.returncode == 0, "the event server did not "
              f"drain and exit cleanly (rc {events_srv.proc.returncode})")
        reload_report = {
            "reload_ms": reload_dt * 1e3,
            "reload_server_s": reload["seconds"],
            "first_query_after_reload_ms": first_dt * 1e3,
            "second_ingest_events_per_s": 10_000 / wall2,
            "query_p50_ms_v1": float(np.percentile(lat1, 50)),
            "query_p50_ms_v2": float(np.percentile(lat2, 50)),
            "max_score_abs_err": max(err1, err2)}
        log("lifecycle: reload " + json.dumps(reload_report))
        ckpt = checkpoint_leg(users, items, ratings, bu, bi, work)
        report = {"ingest": ingest_report, "train": t1, "train_v2": t2,
                  **reload_report, "checkpoint": ckpt,
                  "queries": len(picks) + 11, "foldin": foldin,
                  "foldin_slo": foldin_slo,
                  "feedback": feedback, "eval_cli": eval_cli,
                  "batchpredict_cli": bp_cli, "multiserve_cli": mt_cli,
                  "operator_cli": op_cli}
        log("lifecycle: " + json.dumps(report))
        # the operator phase's consoles read this store after the phase
        operator_store_copy(work / "pio.db")
        return report
    finally:
        for proc in (server, events_srv):
            if proc is not None:
                proc.stop()
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def checkpoint_leg(users, items, ratings, bu, bi, work):
    """Checkpoint-resume of ``train_als`` on the lifecycle's first data
    (the ML-100k ratings and the buys at 4.0), in this process: a train
    with ``Checkpointer(interval=5)`` launches B1 40 times and lands
    within TWIN_TOL of the straight run; a 20-iteration train against a
    snapshot written at step 10 (from a straight 10-iteration run)
    resumes, launches B1 20 times and lands within TWIN_TOL of the
    straight 20-iteration run."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, _init_item_factors, als_fingerprint, train_als,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.workflow.checkpoint import Checkpointer

    c = ML100K
    data = ALSData.build(
        np.concatenate([users, bu]).astype(np.int32),
        np.concatenate([items, bi]).astype(np.int32),
        np.concatenate([ratings, np.full(len(bu), 4.0, np.float32)]),
        c["n_users"], c["n_items"])
    params = ALSParams(rank=c["rank"], num_iterations=c["iters"],
                       reg=c["reg"])
    init_V = _init_item_factors(data.n_items, data.n_items_pad, c["rank"],
                                params.seed, torch.device(DEV)
                                ).cpu().numpy()

    def run(p, ck=None):
        kernels.reset_counts()
        t0 = time.perf_counter()
        U, V = train_als(data, p, device=DEV, init_V=init_V,
                         checkpointer=ck)
        return U, V, kernels.counts()["spd_solve"], time.perf_counter() - t0

    U0, V0, n0, s0 = run(params)
    U1, V1, n1, s1 = run(params, Checkpointer(str(work / "ck5"),
                                              interval=5))
    half = ALSParams(rank=c["rank"], num_iterations=10, reg=c["reg"])
    Uh, Vh, nh, _ = run(half)
    ck = Checkpointer(str(work / "ck_resume"), interval=10)
    ck.save(10, {"V": Vh}, fingerprint=als_fingerprint(data, params))
    U2, V2, n2, s2 = run(params, ck)
    out = {"straight_launches": n0, "checkpointed_launches": n1,
           "half_launches": nh, "resumed_launches": n2,
           "straight_s": s0, "checkpointed_s": s1, "resumed_s": s2,
           "checkpointed_rel_diff": max(_rel(U1, U0), _rel(V1, V0)),
           "resumed_rel_diff": max(_rel(U2, U0), _rel(V2, V0))}
    log("lifecycle: checkpoint " + json.dumps(out))
    want = 2 * c["iters"]
    check(n0 == n1 == want, f"checkpointed train launched B1 {n1} times "
          f"(straight {n0}), expected {want}")
    check(n2 == want // 2, f"resumed train launched B1 {n2} times, "
          f"expected {want // 2}")
    check(out["checkpointed_rel_diff"] <= TWIN_TOL,
          f"checkpointed train differs from the straight run by "
          f"{out['checkpointed_rel_diff']}")
    check(out["resumed_rel_diff"] <= TWIN_TOL,
          f"resumed train differs from the straight run by "
          f"{out['resumed_rel_diff']}")
    return out


# ---------------------------------------------------------------------------
# canary phase, its CLI leg: feedback, the remote log and undeploy
# ---------------------------------------------------------------------------

#: the canary phase's CLI leg at the lifecycle's shape: queries recorded
#: by the feedback loop, the remote log sink's delay and the prefix
FEEDBACK = dict(queries=50, sink_sleep_s=2.0, prefix="pio-smoke-log:")


class _LogSink:
    """A stdlib HTTP sink for the remote error log: it records each body
    and its arrival, then sleeps ``sleep_s`` before answering."""

    def __init__(self, sleep_s: float):
        import http.server

        self.bodies = []
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                sink.bodies.append((time.perf_counter(),
                                    self.rfile.read(n).decode()))
                time.sleep(sleep_s)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        # pio: ignore[PIO003]: the smoke's stub log sink; no request trace
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/log"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def feedback_leg(seed, env, variant, key, port, app_id, m2):
    """The canary phase's CLI leg, on the lifecycle's store: ``deploy``
    of v2 with ``--feedback --event-server-app --log-url --log-prefix``;
    each answer's ``prId`` recorded as a ``predict`` event, a failing
    query's 400 out at once while the sink sleeps, the sink receiving the
    prefixed body, then ``undeploy``."""
    import numpy as np

    from predictionio_tpu_torch.storage.registry import Storage

    f = FEEDBACK
    sink = _LogSink(f["sink_sleep_s"])
    server = None
    try:
        server = Server(["deploy", "--variant", str(variant), "--release",
                         "2", "--port", str(port), "--device", DEV,
                         "--accesskey", key, "--feedback",
                         "--event-server-app", "SmokeApp", "--log-url",
                         sink.url, "--log-prefix", f["prefix"]], env,
                        tag="feedback")
        q_port = server.wait_ready(timeout_s=300)
        qc = Client(q_port)
        picks = np.random.default_rng(seed + 9).choice(
            len(m2.user_vocab), size=f["queries"], replace=False)
        pr_ids = []
        for i in picks:
            status, body, _ = qc.call("POST", "/queries.json",
                                      {"user": str(m2.user_vocab[i]),
                                       "num": 10})
            check(status == 200 and len(body["itemScores"]) == 10
                  and body.get("prId"), f"feedback query: {status} {body}")
            pr_ids.append(body["prId"])
        t_fail = time.perf_counter()
        status, body, fail_dt = qc.call("POST", "/queries.json", {"num": 10})
        check(status == 400, f"a query without a user answered {status}")
        check(fail_dt < 0.5, f"the failing query's 400 took {fail_dt:.3f} s "
              f"with the log sink asleep {f['sink_sleep_s']} s")
        deadline = time.monotonic() + 10
        while not sink.bodies and time.monotonic() < deadline:
            time.sleep(0.01)
        check(len(sink.bodies) == 1 and sink.bodies[0][1].startswith(
            f["prefix"]), f"the log sink received {sink.bodies}")
        logged = json.loads(sink.bodies[0][1][len(f["prefix"]):])
        check(set(logged) == {"engineInstance", "message"}
              and logged["message"].startswith("Query:\n"),
              f"remote log payload {logged}")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            events = list(Storage.get_events().find(
                app_id, entity_type="pio_pr"))
            if len(events) >= f["queries"]:
                break
            time.sleep(0.05)
        check(sorted(e.entity_id for e in events) == sorted(pr_ids)
              and all(e.event == "predict" for e in events),
              f"{len(events)} predict events for {len(pr_ids)} answers")
        _, root, _ = qc.call("GET", "/")
        fb = root["feedback"]
        check(fb["writes"] == f["queries"] and fb["failures"] == 0,
              f"feedback writes {fb}")
        t0 = time.perf_counter()
        _cli(["undeploy", "--port", str(q_port), "--accesskey", key], env,
             timeout=60)
        rc = server.proc.wait(timeout=5)
        undeploy_s = time.perf_counter() - t0
        check(rc == 0, f"the undeployed server exited {rc}")
        report = {
            "queries": f["queries"], "predict_events": len(events),
            "feedback_write_p50_ms": fb["p50WriteSec"] * 1e3,
            "feedback_write_max_ms": fb["maxWriteSec"] * 1e3,
            "failed_query_400_ms": fail_dt * 1e3,
            "log_arrived_after_400_start_ms":
                (sink.bodies[0][0] - t_fail) * 1e3,
            "sink_sleep_s": f["sink_sleep_s"], "undeploy_s": undeploy_s}
        log("canary: feedback " + json.dumps(report))
        return report
    finally:
        if server is not None:
            server.stop()
        sink.close()


# ---------------------------------------------------------------------------
# foldin phase, leg 1: the lifecycle's deploy with online fold-in
# ---------------------------------------------------------------------------

#: the reference bench's fold-in stream (bench.py:1914-1922): apply
#: interval, streamed users, ratings per user, and the p95 slack of its
#: bound p95 <= interval + the longest apply + slack (bench.py:2078-2091)
FOLDIN = dict(interval_s=0.25, stream_users=120, events_per_user=8,
              p95_slack_s=0.5, gap_s=0.004)
#: folded rows (kernel against the plain solve) and served scores
FOLDIN_TOL = 1e-4


def _percentile_pair(lat):
    """(p50, p95) as the reference bench takes them."""
    lat = sorted(lat)
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.95 * len(lat)))]


def _plain_solve(fn):
    """``fn()`` with the plain batched solve (PIO_TPU_SOLVE=vec); checks
    that it launched no kernel."""
    from predictionio_tpu_torch.ops import kernels

    before = kernels.counts()["spd_solve"]
    with solve_env("vec"):
        out = fn()
    check(kernels.counts()["spd_solve"] == before,
          "the plain fold-in twin launched the kernel")
    return out


def _fold_rows(spec, factors, vocab, history):
    """The rows the controller folds from ``history`` ({id: (others,
    values)}) against ``factors``: only ratings of known targets join,
    and an entity with none is skipped (``FoldInController._solve_side``)."""
    from predictionio_tpu_torch.data.bimap import batch_lookup
    from predictionio_tpu_torch.models.als import FoldInSolver

    kept, rated, values = [], [], []
    for ent, (others, vals) in history.items():
        idx = batch_lookup(vocab, others)
        if (idx >= 0).any():
            kept.append(ent)
            rated.append(idx[idx >= 0])
            values.append(vals[idx >= 0])
    if not kept:
        return {}
    rows = FoldInSolver(factors, spec.als_params, device=DEV).solve(rated,
                                                                    values)
    return dict(zip(kept, rows))


def _wait_quiet(qc, after_ticks: int, what: str, timeout_s: float = 120):
    """Wait until the controller has run ``after_ticks`` more ticks than
    now and nothing is pending: a tick that starts after the events were
    acknowledged reads all of them. Returns the fold-in status."""
    def ticks(st):
        return sum(st["outcomes"].values())

    _, st, _ = qc.call("GET", "/deploy/status.json")
    goal = ticks(st["foldin"]) + after_ticks
    deadline = time.monotonic() + timeout_s
    while True:
        _, st, _ = qc.call("GET", "/deploy/status.json")
        f = st["foldin"]
        if ticks(f) >= goal and f["pendingRows"] == 0:
            return f
        check(time.monotonic() < deadline, f"fold-in did not settle after "
              f"{what}: {json.dumps(f)[:500]}")
        time.sleep(0.05)


#: the SLO-gated fold-in leg: a latency objective at the first bucket
#: edge (0.5 ms) that served queries breach, over a 2 s window, so the
#: breach clears 2 s after the traffic stops
FOLDIN_SLO = dict(users=32, queries=20, spec={
    "objectives": [{"name": "p99", "kind": "latency", "thresholdS": 0.0005,
                    "budget": 0.01}],
    "windows": [{"seconds": 2, "burnThreshold": 1.0}],
    "evalIntervalS": 0.1})


def foldin_slo_leg(m2):
    """The foldin phase's SLO leg, at leg 1's shape, in this process on
    the lifecycle's store: a server of v2 with an SLO spec and fold-in
    on; the traffic breaches the latency objective, a fold-in tick of
    the first stream users of leg 1 defers and leaves them pending; once
    the breach clears the next tick applies them through B1 (one
    launch, one ``spd_solve`` dispatch), and their answers are those of
    leg 1's apply (the exact top-10 of rows folded from v2's factors and
    the stored events by the plain solve)."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.deploy.foldin import (
        read_entities_ratings, upsert_factor_rows,
    )
    from predictionio_tpu_torch.deploy.warm import EngineInstance
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.obs import profiler
    from predictionio_tpu_torch.obs.slo import SLOSpec
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.utils.server_config import (
        FoldinConfig, ScorerConfig,
    )

    c, f = ML100K, FOLDIN_SLO
    users = [f"fold{n:04d}" for n in range(f["users"])]
    params = default_engine_params("SmokeApp", rank=c["rank"],
                                   num_iterations=c["iters"], reg=c["reg"])
    result = engine().prepare_deploy(params, [m2])
    server = QueryServer(
        engine(), result, EngineInstance(id="foldin-slo"),
        scorer_config=ScorerConfig(mode="exact"),
        slo_spec=SLOSpec.from_dict(f["spec"]),
        foldin_config=FoldinConfig(enabled=True, apply_interval_s=3600.0,
                                   max_pending=256))
    lt = _LoopThread()
    try:
        qc = Client(lt.run(server.start("127.0.0.1", 0)))
        ctl = server._foldin
        check(ctl is not None, "foldin slo: the controller did not arm")
        qc.call("GET", "/slo.json")          # the windows' baseline
        for j in range(f["queries"]):
            status, _, _ = qc.call("POST", "/queries.json", {
                "user": str(m2.user_vocab[j]), "num": 10})
            check(status == 200, f"foldin slo: a query answered {status}")
        _, slo, _ = qc.call("GET", "/slo.json")
        check(slo["breached"], f"foldin slo: the traffic did not breach "
              f"{slo}")
        ctl.offer([Event(event="rate", entity_type="user", entity_id=u,
                         target_entity_type="item",
                         target_entity_id=str(m2.item_vocab[0]),
                         properties=DataMap({"rating": 3.0}))
                   for u in users])
        b1_0 = kernels.counts()["spd_solve"]
        check(ctl.apply_pending() is None
              and ctl.outcomes.get("deferred") == 1
              and ctl.pending_rows() == len(users)
              and kernels.counts()["spd_solve"] == b1_0,
              f"foldin slo: the tick under a breach did not defer "
              f"({ctl.outcomes}, {ctl.pending_rows()} pending)")
        deadline = time.monotonic() + 30
        while slo["breached"]:
            check(time.monotonic() < deadline, "foldin slo: the breach "
                  "did not clear")
            time.sleep(0.2)
            _, slo, _ = qc.call("GET", "/slo.json")
        d0 = profiler.dispatch_calls().get("spd_solve", 0)
        stats = ctl.apply_pending()
        launches = kernels.counts()["spd_solve"] - b1_0
        dispatches = profiler.dispatch_calls().get("spd_solve", 0) - d0
        check(stats is not None and stats["users"] == len(users)
              and launches == dispatches == ctl.solves == 1,
              f"foldin slo: the apply after the breach {stats}, B1 "
              f"{launches} launches, {dispatches} dispatches")
        spec = result.algorithms[0].foldin_spec(m2, params)

        def recompute():
            uv, U = upsert_factor_rows(m2.user_vocab, m2.U, _fold_rows(
                spec, m2.V, m2.item_vocab,
                read_entities_ratings(spec, users)))
            return ALSModel.from_arrays(uv, m2.item_vocab, U, m2.V,
                                        device=DEV)

        want = _plain_solve(recompute)
        err, _ = check_top10(qc, want, users, "foldin slo")
        report = {"deferred": ctl.outcomes.get("deferred"),
                  "applied": ctl.outcomes.get("applied"),
                  "users": len(users), "b1_launches": launches,
                  "spd_solve_dispatches": dispatches,
                  "max_score_abs_err": err}
        log("foldin: slo " + json.dumps(report))
        return report
    finally:
        lt.run(server.close())
        lt.stop()


def foldin_lifecycle_leg(seed, env, variant, key, es_port, port, m2):
    """Leg 1 of the foldin phase: ``deploy`` of v2 with PIO_FOLDIN=1, the
    reference bench's stream of new users over the event server in
    another process (the pull path), more ratings of sampled users, new
    items, the checks against a plain-solve recompute, and ``rollback``."""
    import numpy as np

    from predictionio_tpu_torch.data.bimap import vocab_index
    from predictionio_tpu_torch.deploy.foldin import (
        read_entities_ratings, upsert_factor_rows,
    )
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, default_engine_params,
    )
    from predictionio_tpu_torch.models.als import ALSModel

    c, f = ML100K, FOLDIN
    env_f = dict(env, PIO_FOLDIN="1",
                 PIO_FOLDIN_APPLY_INTERVAL_S=str(f["interval_s"]))
    server = Server(["deploy", "--variant", str(variant), "--port",
                     str(port), "--device", DEV, "--accesskey", key], env_f,
                    tag="foldin")
    try:
        q_port = server.wait_ready(timeout_s=300)
        qc = Client(q_port)
        ec = Client(es_port)
        _, root, _ = qc.call("GET", "/")
        check(root["engineInstance"]["releaseVersion"] == 2
              and root["foldin"]["enabled"], "the fold-in deploy serves "
              f"{root['engineInstance']}, fold-in {root['foldin']}")
        check(root["kernelLaunches"]["spd_solve"] == 0,
              "B1 launched before any event")
        rng = np.random.default_rng(seed + 6)
        pool = rng.choice(len(m2.user_vocab), size=25 + 50, replace=False)
        pool = [str(m2.user_vocab[i]) for i in pool]
        sampled, controls, raters = pool[:20], pool[20:25], pool[25:]
        before = {u: qc.call("POST", "/queries.json",
                             {"user": u, "num": 10}, raw=True)[1]
                  for u in sampled + controls}

        def post(events):
            status, body, _ = ec.call(
                "POST", f"/batch/events.json?accessKey={key}", events)
            check(status == 200 and all(r["status"] == 201 for r in body),
                  f"fold-in events answered {status} {str(body)[:200]}")
            return time.monotonic()

        def rate_rows(user, n):
            its = rng.choice(len(m2.item_vocab), size=n, replace=False)
            return [{"event": "rate", "entityType": "user",
                     "entityId": user, "targetEntityType": "item",
                     "targetEntityId": str(m2.item_vocab[i]),
                     "properties": {"rating": float(rng.integers(1, 6))}}
                    for i in its]

        def probe(user, deadline_s=60.0):
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                _, body, _ = qc.call("POST", "/queries.json",
                                     {"user": user, "num": 10})
                if body["itemScores"]:
                    return time.monotonic()
                time.sleep(0.002)
            check(False, f"fold-in: {user} never reflected")

        # 1. the stream: new users, one a request, a few ms apart; every
        #    4th probed until answered (bench.py:2053-2072)
        warm = [f"foldwarm{w}" for w in range(2)]
        for user in warm:
            post(rate_rows(user, f["events_per_user"]))
            probe(user)
        warm_applies = _wait_quiet(qc, 1, "the warm-up users")["applies"]
        t_stream = time.perf_counter()
        stream = [f"fold{n:04d}" for n in range(f["stream_users"])]
        lat = []
        for n, user in enumerate(stream):
            t_post = post(rate_rows(user, f["events_per_user"]))
            time.sleep(f["gap_s"])
            if n % 4 == 3:
                lat.append(probe(user) - t_post)
        probe(stream[-1])
        stream_s = time.perf_counter() - t_stream
        st_stream = _wait_quiet(qc, 1, "the stream")
        for user in stream:
            _, body, _ = qc.call("POST", "/queries.json",
                                 {"user": user, "num": 10})
            check(len(body["itemScores"]) == 10,
                  f"streamed user {user} not reflected")
        # 2. more ratings of the sampled users (a user's events may
        #    straddle two requests: the settle waits two ticks past them)
        more = [e for u in sampled for e in rate_rows(u, 8)]
        for s0 in range(0, len(more), 50):
            post(more[s0:s0 + 50])
        _wait_quiet(qc, 2, "the sampled users' ratings")
        # 3. new items, each rated by 10 existing users (one request)
        new_items = [f"foldi{j}" for j in range(5)]
        post([{"event": "rate", "entityType": "user", "entityId": u,
               "targetEntityType": "item", "targetEntityId": it,
               "properties": {"rating": float(rng.integers(1, 6))}}
              for j, it in enumerate(new_items)
              for u in raters[10 * j:10 * (j + 1)]])
        st = _wait_quiet(qc, 3, "the new items")
        _, root, _ = qc.call("GET", "/")

        # the plain-solve recompute of every folded row, in the order the
        # controller folds them: the stream and the sampled users against
        # v2's V; the raters against v2's V (known items only), then the
        # new items against U with those rows, then the raters again
        # against V with the new items
        algo = ALSAlgorithm(AlgorithmParams(rank=c["rank"],
                                            num_iterations=c["iters"],
                                            reg=c["reg"]))
        spec = algo.foldin_spec(m2, default_engine_params("SmokeApp"))

        def recompute():
            hist = read_entities_ratings(spec, warm + stream + sampled)
            uv, U = upsert_factor_rows(
                m2.user_vocab, m2.U,
                _fold_rows(spec, m2.V, m2.item_vocab, hist))
            hr = read_entities_ratings(spec, raters)
            uv, U = upsert_factor_rows(
                uv, U, _fold_rows(spec, m2.V, m2.item_vocab, hr))
            iv, V = upsert_factor_rows(
                m2.item_vocab, m2.V,
                _fold_rows(spec, U, uv,
                           read_entities_ratings(spec, new_items, "item")))
            uv, U = upsert_factor_rows(uv, U, _fold_rows(spec, V, iv, hr))
            return ALSModel.from_arrays(uv, iv, U, V, device=DEV)

        want = _plain_solve(recompute)
        check(all(vocab_index(want.item_vocab, it) is not None
                  for it in new_items), "recompute lost a new item")
        err, _ = check_top10(qc, want, warm + stream + sampled + raters,
                             "foldin")
        _, body, _ = qc.call("POST", "/queries.json", {
            "user": stream[0], "num": 10, "whiteList": new_items})
        check(sorted(x["item"] for x in body["itemScores"])
              == sorted(new_items), f"whiteList of the new items served "
              f"{body['itemScores']}")
        # a control's answer is unchanged unless a new item now belongs
        # in its exact top-10 (then it must be that top-10)
        unchanged = 0
        for u in controls:
            now = qc.call("POST", "/queries.json", {"user": u, "num": 10},
                          raw=True)[1]
            ui = want.user_index(u)
            top = np.argsort(-(want.V @ want.U[ui]), kind="stable")[:10]
            if not {str(want.item_vocab[j]) for j in top} & set(new_items):
                check(now == before[u], f"control {u}'s answer changed")
                unchanged += 1
            else:
                check_top10(qc, want, [u], "foldin control")
        check(unchanged >= 1, "no control kept its answer")
        fs = st
        solve_calls = fs["solveCalls"]
        b1 = root["kernelLaunches"]["spd_solve"]
        check(b1 == solve_calls and b1 >= 1, f"the deploy launched B1 {b1} "
              f"times for {solve_calls} fold-in solves")
        check(fs["applies"] >= 1 and fs["appliedUserRows"] >= 140
              and fs["appliedItemRows"] == 5, f"fold-in status {fs}")
        for a in fs["recentApplies"]:
            check(all(s["solve_event_ms"] is not None
                      for s in a["solves"]), "an apply did not solve on "
                  "the card")
        _, listing, _ = qc.call("GET", "/releases.json")
        by_v = {r["version"]: r for r in listing["releases"]}
        drift = [r for r in listing["releases"]
                 if r["batch"] == "foldin drift of v2"]
        check(len(drift) == 1 and drift[0]["status"] == "LIVE"
              and by_v[2]["status"] == "RETIRED", "releases after fold-in: "
              f"{[(r['version'], r['status'], r['batch']) for r in listing['releases']]}")
        _, status, _ = qc.call("GET", "/deploy/status.json")
        check(status["standby"]["releaseVersion"] == 2,
              f"the standby is {status['standby']}, not v2")

        # 4. rollback: the pre-fold-in answers, byte for byte
        t0 = time.perf_counter()
        out = _cli(["rollback", "--port", str(q_port), "--accesskey", key],
                   env)
        rollback_cli_s = time.perf_counter() - t0
        log("foldin: " + out[-1])
        for u in sampled + controls:
            now = qc.call("POST", "/queries.json", {"user": u, "num": 10},
                          raw=True)[1]
            check(now == before[u], f"after rollback {u}'s answer differs "
                  "from its pre-fold-in answer")
        for u in warm + stream:
            _, body, _ = qc.call("POST", "/queries.json",
                                 {"user": u, "num": 10})
            check(body["itemScores"] == [], f"{u} still known after the "
                  "rollback")
        _, listing, _ = qc.call("GET", "/releases.json")
        d = next(r for r in listing["releases"]
                 if r["id"] == drift[0]["id"])
        check(d["status"] == "ROLLED_BACK" and next(
            r for r in listing["releases"] if r["version"] == 2)["status"]
            == "LIVE", f"after rollback the drift is {d['status']}")
        rollback_ms = float(out[-1].rsplit("in ", 1)[1].split(" ms")[0])
        status, _, _ = qc.call("POST", f"/stop?accessKey={key}")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the fold-in deploy did not stop on POST /stop")

        p50, p95 = _percentile_pair(lat)
        stream_applies = st_stream["recentApplies"][
            warm_applies - st_stream["applies"]:]
        max_apply = max(a["apply_s"] for a in stream_applies)
        bound = f["interval_s"] + max_apply + f["p95_slack_s"]
        report = {
            "stream_users": len(stream), "probed": len(lat),
            "p50_event_to_reflected_s": p50,
            "p95_event_to_reflected_s": p95, "p95_bound_s": bound,
            "max_stream_apply_s": max_apply, "stream_s": stream_s,
            "applies": fs["applies"], "solve_calls": solve_calls,
            "b1_launches": b1, "applied_user_rows": fs["appliedUserRows"],
            "applied_item_rows": fs["appliedItemRows"],
            "max_score_abs_err": err, "controls_unchanged": unchanged,
            "rollback_server_ms": rollback_ms,
            "rollback_cli_s": rollback_cli_s,
            "apply_split": _split_summary(fs["recentApplies"])}
        log("foldin: lifecycle " + json.dumps(report))
        check(p95 <= bound, f"fold-in p95 event->reflected {p95:.3f} s "
              f"exceeds the bound {bound:.3f} s")
        return report
    finally:
        server.stop()


def foldin_b1_rows(seed, shapes):
    """B1 at the fold-in applies' shapes ``(K, S)``: the call's ms (CUDA
    events over back-to-back calls: the wrapper's host time where it
    exceeds the kernel's) and the kernel's device ms (a CUDA graph of the
    calls, replayed), on systems built as the kernels phase builds them,
    each held to the plain solve."""
    import torch

    from predictionio_tpu_torch.ops.linalg import (
        cholesky_solve_vec, spd_solve, with_diagonal,
    )

    g = torch.Generator(device=DEV).manual_seed(seed + 9)
    rows = []
    for k, s_ in sorted(set(shapes)):
        gram, lam, b, _ = spd_inputs(s_, k, g)
        x = spd_solve(gram, b, lam, 1e-6)
        plain = cholesky_solve_vec(with_diagonal(gram, lam, 1e-6), b)
        scale = max(1.0, float(plain.abs().max()))
        err = float((x - plain).abs().max())
        check(err <= SPD_TOL * scale, f"B1 at K={k} S={s_}: max |dx| {err}")
        rows.append({
            "K": k, "S": s_, "max_abs_err": err,
            "call_ms": cuda_ms(lambda: spd_solve(gram, b, lam, 1e-6),
                               iters=200, warmup=20),
            "device_ms": graph_ms(lambda: spd_solve(gram, b, lam, 1e-6),
                                  launches=50)})
    log("foldin: b1 " + json.dumps(rows))
    return rows


def _split_summary(applies):
    """Medians and maxima of the applies' splits, and B1's call ms and
    event-to-event ms by the bucketed S it ran at."""
    import numpy as np

    out = {}
    for k in ("read_s", "model_s", "register_s", "warm_s", "swap_s",
              "pull_s", "apply_s"):
        v = [a[k] for a in applies if k in a]
        if v:
            out[k] = {"median": float(np.median(v)), "max": float(max(v))}
    by_s = {}
    for a in applies:
        for sv in a["solves"]:
            by_s.setdefault((sv["K"], sv["S"]), []).append(sv)
    out["b1_by_shape"] = [
        {"K": k, "S": s_, "solves": len(v),
         "call_ms_median": float(np.median([x["solve_call_ms"] for x in v])),
         "event_ms_median": (
             float(np.median([x["solve_event_ms"] for x in v]))
             if v[0]["solve_event_ms"] is not None else None),
         "system_ms_median": float(np.median([x["system_ms"] for x in v]))}
        for (k, s_), v in sorted(by_s.items())]
    return out


# ---------------------------------------------------------------------------
# foldin phase, leg 2: the serve cell's width, in this process
# ---------------------------------------------------------------------------

#: the reference bench's solver measurement (bench.py:1917-1918,
#: :1928-1967): B pending rows x ratings each, reg, and the least speed-up
#: of one batched solve over one solve a row
FOLDIN_SOLVER = dict(batch=256, ratings=8, reg=0.05, min_speedup=5.0)
#: the width leg's item fold: new items, raters of each (users + items
#: stay within one apply's max_pending)
FOLDIN_ITEMS = dict(items=16, raters=24)


def foldin_solver_leg(V_dev, n_items: int):
    """Batched against one-at-a-time fold-in over the 10M x 64 factors on
    the card, explicit then implicit: launch counts, rows/s, B1's call
    and device time at S = 256 and S = 1, and every row held to the plain
    solve."""
    import numpy as np

    from predictionio_tpu_torch.models.als import ALSParams, FoldInSolver
    from predictionio_tpu_torch.ops import kernels

    fs = FOLDIN_SOLVER
    rng = np.random.default_rng(17)
    b, n = fs["batch"], fs["ratings"]
    rated = [rng.choice(n_items, size=n, replace=False) for _ in range(b)]
    values = [np.clip(rng.normal(3.0, 1.0, n), 1, 5).astype(np.float32)
              for _ in range(b)]
    out = {}
    for name, params in (
            ("explicit", ALSParams(rank=V_dev.shape[1], reg=fs["reg"])),
            ("implicit", ALSParams(rank=V_dev.shape[1], reg=fs["reg"],
                                   implicit_prefs=True, alpha=1.0))):
        solver = FoldInSolver(None, params, factors_device=V_dev)
        solver.solve(rated, values)                  # first-use costs
        solver.solve(rated[:1], values[:1])
        gram = solver._gram
        kernels.reset_counts()
        t0 = time.perf_counter()
        x = solver.solve(rated, values)
        batched_s = time.perf_counter() - t0
        at_b = dict(solver.last_solve)
        n_batched = kernels.counts()["spd_solve"]
        kernels.reset_counts()
        t0 = time.perf_counter()
        seq = np.concatenate([solver.solve([r], [v])
                              for r, v in zip(rated, values)])
        seq_s = time.perf_counter() - t0
        at_1 = dict(solver.last_solve)
        n_seq = kernels.counts()["spd_solve"]
        batched_s = min(batched_s, _timed(lambda: solver.solve(rated,
                                                               values)))
        seq_s = min(seq_s, _timed(lambda: [solver.solve([r], [v]) for r, v
                                          in zip(rated, values)]))
        plain = _plain_solve(lambda: solver.solve(rated, values))
        scale = max(1.0, float(np.abs(plain).max()))
        err = max(float(np.abs(x - plain).max()),
                  float(np.abs(seq - plain).max()))
        check(n_batched == 1 and n_seq == b, f"fold-in solver {name}: "
              f"{n_batched} launches batched, {n_seq} one at a time, "
              f"expected 1 and {b}")
        check(err <= FOLDIN_TOL * scale, f"fold-in solver {name}: rows "
              f"differ from the plain solve by {err} > {FOLDIN_TOL} * "
              f"{scale}")
        check(solver._gram is gram and (gram is not None)
              == params.implicit_prefs, f"fold-in solver {name}: the "
              "Gramian was not computed once")
        speedup = seq_s / batched_s
        out[name] = {
            "rows_per_s_batched": b / batched_s,
            "rows_per_s_one_at_a_time": b / seq_s, "speedup": speedup,
            "launches_batched": n_batched, "launches_one_at_a_time": n_seq,
            "max_abs_err": err, "max_abs_x": scale,
            "b1_at_S256": at_b, "b1_at_S1": at_1}
        check(speedup >= fs["min_speedup"], f"fold-in solver {name}: "
              f"batched {speedup:.1f}x over one at a time, under "
              f"{fs['min_speedup']}x")
    log("foldin: solver " + json.dumps(out))
    return out


def card_quantization_matches_numpy(V, scorer, rows: int = 65536) -> bool:
    """The scorer build quantizes on the card: its int8 codes and scales
    for ``rows`` rotated catalog rows (one of them zero) must equal the
    reference's numpy ``rint(v / s)`` bit for bit."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import scoring

    v = np.ascontiguousarray(V[:rows] @ scorer._rotation, np.float32)
    v[1] = 0.0
    s = np.abs(v).max(axis=1) / 127.0
    s = np.where(s == 0, 1.0, s).astype(np.float32)
    q = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
    q_card, s_card = scoring._quantize_int8(torch.from_numpy(v).to(DEV))
    check(q_card.device.type == "cuda", "quantized off the card")
    same = bool(np.array_equal(q_card.cpu().numpy(), q)
                and np.array_equal(s_card.cpu().numpy(), s))
    check(same, "the card's int8 quantization differs from numpy's")
    return same


def _applies_after(ctl, n: int):
    """The controller's logged applies after its n-th."""
    return [a for a in ctl.apply_log.copy() if a["apply"] > n]


def _settled_applies(ctl, n: int, users0: int, timeout_s: float = 10.0):
    """The controller's logged applies after its n-th, once they hold
    every user row applied since ``applied_users`` read ``users0``: an
    apply counts its rows (and its swap is served) before it logs
    itself, so a reader that saw the rows can be ahead of the log."""
    deadline = time.monotonic() + timeout_s
    while True:
        applies = _applies_after(ctl, n)
        if sum(a.get("users", 0) for a in applies) \
                >= ctl.applied_users - users0 \
                or time.monotonic() > deadline:
            return applies
        time.sleep(0.002)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def foldin_width_leg(seed, users, items, U, V):
    """Leg 2 of the foldin phase: the serve cell's model in this process,
    a QueryServer (twostage, shortlist SHORTLIST) with its controller
    started and the write buffer's flush tap armed (the push path), the
    reference bench's stream and probe (bench.py:2005-2091), then one item
    fold. Returns the leg's report."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import UTC, Event
    from predictionio_tpu_torch.data.write_buffer import WriteBuffer
    from predictionio_tpu_torch.deploy.warm import EngineInstance
    from predictionio_tpu_torch.engines.recommendation import (
        Query, default_engine_params, engine,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import kernels, scoring
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import (
        FoldinConfig, ScorerConfig,
    )
    import datetime as dt

    f = FOLDIN
    n_items, rank = V.shape
    work = WORK / "foldin_width"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(work / "pio.db")}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
    server = buf = ctl = None
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0,
                                                         name="WidthApp"))
        Storage.get_events().init_channel(app_id)
        model = ALSModel.from_arrays(users, items, U, V, device=DEV)
        eng = engine()
        result = eng.prepare_deploy(
            default_engine_params("WidthApp", rank=rank), [model])
        server = QueryServer(
            eng, result, EngineInstance(id="foldin-width"),
            scorer_config=ScorerConfig(mode="twostage", tile_items=TILE,
                                       shortlist=SHORTLIST),
            foldin_config=FoldinConfig(
                enabled=True, apply_interval_s=f["interval_s"],
                max_pending=4 * f["stream_users"]))
        t0 = time.perf_counter()
        server.warm()
        build_s = time.perf_counter() - t0
        scorer0 = model._scorer_cache[2]
        check(scorer0.active_mode == "twostage", "the width leg's scorer "
              f"serves {scorer0.active_mode}")
        quant_equal = card_quantization_matches_numpy(V, scorer0)
        t0 = time.perf_counter()
        V_dev = model.V_device                       # the solver's copy
        synchronize()
        upload_s = time.perf_counter() - t0
        solver = foldin_solver_leg(V_dev, n_items)

        server._start_foldin()                       # no loop: tap only
        ctl = server._foldin
        buf = WriteBuffer(Storage.get_events, linger_s=0.001, flush_max=256)
        stop = threading.Event()
        errors = []

        def apply_loop():
            while not stop.is_set():
                try:
                    ctl.apply_pending()
                except Exception as e:      # noqa: BLE001 — reported
                    errors.append(repr(e))
                stop.wait(f["interval_s"])

        applier = threading.Thread(target=apply_loop, daemon=True)
        applier.start()
        rng = np.random.default_rng(seed + 7)
        scored = [0]

        def stream_one(uid):
            when = dt.datetime.now(tz=UTC)
            its = rng.choice(n_items, size=f["events_per_user"],
                             replace=False)
            buf.submit([Event(event="rate", entity_type="user",
                              entity_id=uid, target_entity_type="item",
                              target_entity_id=str(items[j]),
                              properties=DataMap({"rating": 4.0}),
                              event_time=when) for j in its], app_id)
            return time.monotonic()

        def probe_until(uid, deadline_s=60.0):
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                out = server._predict_batch([Query(user=uid, num=10)])[0]
                if out.item_scores:
                    scored[0] += 1
                    return time.monotonic()
                time.sleep(0.002)
            check(False, f"width leg: {uid} never reflected "
                  f"(apply errors {errors[:3]})")

        for w in range(2):                    # the first applies upload V
            stream_one(f"warm{w:04d}")
            probe_until(f"warm{w:04d}")
        a0, u0 = ctl.applies, ctl.applied_users
        kernels.reset_counts()
        scored[0] = 0
        lat = []
        t_stream = time.perf_counter()
        stream = [f"fresh{n:05d}" for n in range(f["stream_users"])]
        for n, uid in enumerate(stream):
            t_post = stream_one(uid)
            time.sleep(f["gap_s"])
            if n % 4 == 3:
                lat.append(probe_until(uid) - t_post)
        probe_until(stream[-1])
        stream_s = time.perf_counter() - t_stream
        for uid in stream:
            probe_until(uid, deadline_s=10.0)
        stream_applies = _settled_applies(ctl, a0, u0)
        launches = kernels.counts()
        check(not errors, f"width leg applies failed: {errors[:3]}")
        unit = server._unit
        m_now = unit.result.models[0]
        check(m_now._scorer_cache[2] is scorer0, "a user-only fold did not "
              "carry the quantized scorer")
        check(launches["shortlist"] >= scored[0], f"{scored[0]} scored "
              f"queries launched the shortlist kernel "
              f"{launches['shortlist']} times")
        check(launches["spd_solve"] == sum(len(a["solves"])
                                           for a in stream_applies),
              f"the stream's applies launched B1 {launches['spd_solve']} "
              "times")
        # recall@10 of the folded users' served answers against the exact
        # top-10 of their folded rows on the card
        hits = total = 0
        for uid in stream:
            got = [s.item for s in server._predict_batch(
                [Query(user=uid, num=10)])[0].item_scores]
            u = torch.from_numpy(m_now.U[m_now.user_index(uid)]).to(DEV)
            top = torch.topk(V_dev @ u, 10).indices.cpu().numpy()
            hits += len({str(items[j]) for j in top} & set(got))
            total += 10
        recall = hits / total
        p50, p95 = _percentile_pair(lat)
        max_apply = max(a["apply_s"] for a in stream_applies)
        bound = f["interval_s"] + max_apply + f["p95_slack_s"]
        report = {
            "card": card_line(), "items": n_items, "rank": rank,
            "scorer_build_s": build_s, "v_upload_s": upload_s,
            "card_quantization_bit_equal": quant_equal,
            "solver": solver, "stream_users": len(stream),
            "probed": len(lat), "p50_event_to_reflected_s": p50,
            "p95_event_to_reflected_s": p95, "p95_bound_s": bound,
            "max_stream_apply_s": max_apply, "stream_s": stream_s,
            "stream_applies": len(stream_applies),
            "stream_launches": launches, "scored_probes": scored[0],
            "recall_at_10": recall,
            "apply_split": _split_summary(stream_applies)}
        log("foldin: width stream " + json.dumps(report))
        check(recall >= 0.99, f"folded users' recall@10 {recall:.4f} < "
              "0.99")
        check(p95 <= bound, f"width leg p95 event->reflected {p95:.3f} s "
              f"exceeds the bound {bound:.3f} s")

        # one item fold: new items rated by existing users; the fold
        # rebuilds the scorer before the swap (warm_s)
        fi = FOLDIN_ITEMS
        new_items = [f"newitem{j:02d}" for j in range(fi["items"])]
        raters = rng.choice(len(users), size=fi["items"] * fi["raters"],
                            replace=False)
        a1 = ctl.applies
        buf.submit([Event(event="rate", entity_type="user",
                          entity_id=str(users[r]), target_entity_type="item",
                          target_entity_id=new_items[k // fi["raters"]],
                          properties=DataMap({"rating": 5.0}))
                    for k, r in enumerate(raters)], app_id).result(60)
        deadline = time.monotonic() + 120
        while (ctl.applied_items < fi["items"] or ctl.pending_rows()) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        applier.join(timeout=60)
        check(not errors, f"the item fold failed: {errors[:3]}")
        check(ctl.applied_items == fi["items"], f"{ctl.applied_items} of "
              f"{fi['items']} new items folded")
        fold_applies = _applies_after(ctl, a1)
        grown = server._unit.result.models[0]
        rebuilt = grown._scorer_cache[2]
        check(rebuilt is not scorer0
              and rebuilt.n_items == n_items + fi["items"],
              "the item fold did not rebuild the scorer")
        # a user aligned with a new item gets it first, through what the
        # rebuilt scorer's parity gate left serving: twostage (B2), or
        # the exact scorer if the gate demoted it
        first = 0
        b2_before = kernels.counts()["shortlist"]
        for it in new_items:
            row = grown.V[grown.item_index(it)]
            aligned = ALSModel(user_vocab=np.asarray(["q"], dtype=object),
                               item_vocab=grown.item_vocab, U=row[None, :],
                               V=grown.V, device=DEV)
            for attr in ("_scorer_cache", "_resident"):
                setattr(aligned, attr, getattr(grown, attr, None))
            top = aligned.recommend_batch([("q", 1, (), None)])[0]
            first += top[0][0] == it
        b2_aligned = kernels.counts()["shortlist"] - b2_before
        check(first == len(new_items), f"{first} of {len(new_items)} new "
              "items came first for a user aligned with them")
        check((b2_aligned == len(new_items)) == rebuilt.active,
              f"aligned queries launched B2 {b2_aligned} times on a "
              f"{rebuilt.active_mode} scorer")
        report.update({
            "item_fold": {
                "items": fi["items"], "raters": len(raters),
                "applies": len(fold_applies),
                "scorer_rebuild_s": max(a["warm_s"] for a in fold_applies),
                "rebuilt_mode": rebuilt.active_mode,
                "rebuilt_probe_recall": rebuilt.recall_probe,
                "aligned_b2_launches": b2_aligned,
                "apply_split": _split_summary(fold_applies)},
            "aligned_first": first})
        log("foldin: width item fold " + json.dumps(report["item_fold"]))
        return report
    finally:
        if ctl is not None:
            ctl.stop_tap()
        if buf is not None:
            buf.stop()
        if server is not None:
            server._predict_executor.shutdown(wait=False)
            server._deploy_executor.shutdown(wait=True)
        scoring.set_process_scorer_config(None)
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# canary phase: staged rollouts at the serve cell's width, in this process
# ---------------------------------------------------------------------------

#: the first leg's ``POST /deploy.json``: a canary of v2 at one query in
#: five, promoted after 100 clean samples
CANARY_BODY = {"version": 2, "canaryFraction": 0.2, "canaryWindow": 200,
               "canaryMinSamples": 20, "canaryPromoteAfter": 100}
#: the shadow leg's body, and the queries it mirrors. The server's own
#: promote count (DeployConfig) is set far above them, so the shadow ends
#: by the operator's abort, not by a promote
SHADOW_BODY = {"version": 3, "shadow": True}
SHADOW_QUERIES = 200
SHADOW_PROMOTE_AFTER = 100_000
#: the fold-in held by the canary: new users x ratings, streamed through
#: the push tap while the canary is judged; the apply interval
CANARY_FOLDIN = dict(users=8, ratings=8, interval_s=1.0)
#: a served top-10 against its arm's exact one: ids equal up to ties,
#: scores within this (relative above 1)
ARM_TOL = 1e-4


class _LoopThread:
    """An asyncio loop on a daemon thread, for an in-process server."""

    def __init__(self):
        import asyncio

        self.loop = asyncio.new_event_loop()
        # pio: ignore[PIO003]: a bare loop thread; requests open traces on it
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 600):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)


def _arm_match(body, sc) -> bool:
    """Does a served answer equal the exact f32 top-10 of one arm's
    scores ``sc`` (a card tensor over the catalog)?"""
    import numpy as np
    import torch

    got = body["itemScores"]
    vals, idx = torch.topk(sc, 10)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    if len(got) != 10:
        return False
    got_ids = np.array([int(s["item"][1:]) for s in got])
    got_sc = np.array([s["score"] for s in got])
    exact_sc = sc[torch.as_tensor(got_ids, device=DEV)].cpu().numpy()
    tol = ARM_TOL * np.maximum(1.0, np.abs(exact_sc))
    if not (np.abs(got_sc - exact_sc) <= tol).all():
        return False
    # the same ids, up to ties of the exact scores
    return all(a == b_ or abs(float(s) - float(v)) <= ARM_TOL * max(
        1.0, abs(float(v))) for a, b_, v, s in zip(got_ids, idx, vals,
                                                  exact_sc))


def _lat(ms):
    import numpy as np

    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))} if ms else {"n": 0}


def canary_phase(seed, users, items, U, V):
    """Staged rollouts at the serve cell's width, through the deploy API
    of a ``QueryServer`` in this process (served over HTTP on a loop
    thread): a canary of v2 promoted, fold-in held by it, a shadow of v3
    aborted. Returns the phase's report (``main`` prints it as the
    ``canary`` line, with the CLI leg's figures)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.write_buffer import WriteBuffer
    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import kernels, scoring
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.storage.base import App, EngineInstance, Model
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import (
        DeployConfig, FoldinConfig, ScorerConfig,
    )
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    n_items, rank = V.shape
    n_users = len(users)
    work = WORK / "canary"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(work / "pio.db")},
                    "FS": {"TYPE": "localfs", "PATH": str(work / "models")}},
        "repositories": {
            "METADATA": {"NAME": "pio", "SOURCE": "DB"},
            "EVENTDATA": {"NAME": "pio", "SOURCE": "DB"},
            "MODELDATA": {"NAME": "pio", "SOURCE": "FS"}}})
    server = lt = buf = None
    arms_dev = {}
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0,
                                                         name="CanaryApp"))
        Storage.get_events().init_channel(app_id)

        def instance(n):
            inst = EngineInstance(
                id=f"canary-v{n}", status="COMPLETED",
                engine_id="canary-engine", engine_version="1",
                engine_variant="default",
                data_source_params=json.dumps({"appName": "CanaryApp"}),
                algorithms_params=json.dumps(
                    [{"name": "als", "params": {"rank": rank}}]))
            Storage.get_meta_data_engine_instances().insert(inst)
            return inst

        # v1: the serve cell's model, served from this process; v2 and v3
        # drawn on the card from seed + 1 and seed + 2, stored as blobs
        inst1 = instance(1)
        rel1 = record_release(inst1, 0.0)
        factors = {1: (U, V)}
        t0 = time.perf_counter()
        for n in (2, 3):
            Un, Vn = card_factors(seed + n - 1, n_items, n_users, rank)
            blob = serialize_models([ALSModel.from_arrays(
                users, items, Un, Vn, device="cpu")])
            inst = instance(n)
            Storage.get_model_data_models().insert(Model(id=inst.id,
                                                         models=blob))
            check(record_release(inst, 0.0, blob).version == n,
                  f"v{n} did not register as release {n}")
            blob_mb = len(blob) / 1e6
            del blob
            factors[n] = (Un, Vn)
        setup_s = time.perf_counter() - t0
        log(f"canary: v2 and v3 built and stored ({blob_mb:.0f} MB blobs) "
            f"in {setup_s:.3f} s")

        model = ALSModel.from_arrays(users, items, U, V, device=DEV)
        eng = engine()
        result = eng.prepare_deploy(
            default_engine_params("CanaryApp", rank=rank), [model])
        cf = CANARY_FOLDIN
        server = QueryServer(
            eng, result, inst1, release=rel1,
            scorer_config=ScorerConfig(mode="twostage", tile_items=TILE,
                                       shortlist=SHORTLIST),
            foldin_config=FoldinConfig(enabled=True,
                                       apply_interval_s=cf["interval_s"],
                                       max_pending=64),
            deploy_config=DeployConfig(
                canary_promote_after=SHADOW_PROMOTE_AFTER))
        t0 = time.perf_counter()
        server.warm()
        warm_s = time.perf_counter() - t0
        check(model._scorer_cache[2].active, "v1's scorer was demoted")
        lt = _LoopThread()
        port = lt.run(server.start("127.0.0.1", 0))
        client = Client(port)
        ctl = server._foldin
        check(ctl is not None, "fold-in did not arm")

        def exact(n, ui):
            Un, _ = factors[n]
            if n not in arms_dev:
                arms_dev[n] = torch.from_numpy(factors[n][1]).to(DEV)
            return arms_dev[n] @ torch.from_numpy(Un[ui]).to(DEV)

        def prepare_split(out):
            prep = out["prepare"]
            scorer = prep["scorer"]
            check(len(scorer) == 1, f"candidate scorers: {scorer}")
            scorer = scorer[0]
            check(scorer["activeMode"] == "twostage", "the candidate's "
                  f"scorer was gated to {scorer['activeMode']} (probe "
                  f"recall {scorer['recallProbe']}): B2 would be off an arm")
            return {"load_s": prep["loadS"],
                    "scorer_build_s": scorer["buildSeconds"]
                    - scorer["gateSeconds"],
                    "parity_gate_s": scorer["gateSeconds"],
                    "parity_recall": scorer["recallProbe"],
                    "warmup_s": prep["warmupS"] - scorer["buildSeconds"],
                    "verify_s": prep["verifyS"],
                    "prepare_s": out["seconds"]}

        rng = np.random.default_rng(seed + 11)

        # 1. canary v2 ------------------------------------------------------
        status, out, dt = client.call("POST", "/deploy.json", CANARY_BODY)
        check(status == 200 and out.get("message") == "Canary started",
              f"canary deploy answered {status}: {out}")
        prepare2 = prepare_split(out)
        prepare2["http_s"] = dt
        log("canary: v2 prepared " + json.dumps(prepare2))
        _, rels, _ = client.call("GET", "/releases.json")
        check({r["version"]: r["status"] for r in rels["releases"]}.get(2)
              == "CANARY", f"releases after the canary deploy: "
              f"{rels['releases']}")

        # 2. the fold-in it holds: 8 new users x 8 ratings, push tap -----
        buf = WriteBuffer(Storage.get_events, linger_s=0.001)
        fresh = [f"canaryfresh{j}" for j in range(cf["users"])]
        buf.submit([Event(event="rate", entity_type="user", entity_id=uid,
                          target_entity_type="item",
                          target_entity_id=str(items[j]),
                          properties=DataMap({"rating": 4.0}))
                    for uid in fresh
                    for j in rng.choice(n_items, cf["ratings"],
                                        replace=False)], app_id).result(60)
        deadline = time.monotonic() + 30
        while ctl.pending_rows() < cf["users"] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        check(ctl.pending_rows() == cf["users"], f"{ctl.pending_rows()} "
              f"rows pending of {cf['users']} streamed users")
        applies0 = ctl.applies
        # the held fold-in may land at the first tick after the verdict:
        # a tick between the verdict and the registry read straight after
        # it skips (the next one applies), so that read sees the promote
        # and not a drift over it (a tick never waits: the deploy
        # executor it runs on also writes the release statuses)
        read_gate = threading.Event()
        tick = ctl.apply_pending

        def gated_tick():
            if read_gate.is_set() or ctl.server._canary is not None:
                return tick()
            return None

        ctl.apply_pending = gated_tick

        # 3. sequential single queries until the verdict -----------------
        kernels.reset_counts()
        arms, lat = [], {1: [], 2: []}
        b2 = {1: 0, 2: 0}
        t_phase = time.perf_counter()
        verdict_st = None
        while time.perf_counter() - t_phase < 300:
            ui = int(rng.integers(n_users))
            before = kernels.counts()["shortlist"]
            status, body, dt = client.call(
                "POST", "/queries.json", {"user": str(users[ui]),
                                          "num": 10})
            check(status == 200, f"canary query answered {status}: {body}")
            launched = kernels.counts()["shortlist"] - before
            served = [n for n in (1, 2) if _arm_match(body, exact(n, ui))]
            check(len(served) == 1, f"query {len(arms)} for {users[ui]}: "
                  f"its top-10 is the exact top-10 of arms {served}")
            arm = served[0]
            check(launched == 1, f"query {len(arms)} launched B2 "
                  f"{launched} times")
            arms.append(arm)
            lat[arm].append(dt * 1e3)
            b2[arm] += launched
            _, st, _ = client.call("GET", "/deploy/status.json")
            if st["canary"] is None or st["canary"]["decided"]:
                verdict_st = st
                break
        check(verdict_st is not None, "no verdict within 300 s")
        held = {"applies": ctl.applies - applies0,
                "pending": ctl.pending_rows(),
                "held_ticks": ctl.outcomes.get("held", 0)}
        while verdict_st["canary"] is not None:
            _, verdict_st, _ = client.call("GET", "/deploy/status.json")
        t_verdict = time.perf_counter()
        _, rels, _ = client.call("GET", "/releases.json")
        statuses = {r["version"]: r["status"] for r in rels["releases"]}
        read_gate.set()
        ctl.apply_pending = tick
        check(statuses.get(2) == "LIVE" and statuses.get(1) == "RETIRED",
              f"straight after the verdict the registry reads {statuses}")
        events = verdict_st["deploy"]["recentEvents"]
        verdict = next(e for e in events if e["kind"] == "canary_verdict")
        check(verdict["decision"] == "promote", f"verdict {verdict}")
        check(held["applies"] == 0 and held["pending"] == cf["users"],
              f"fold-in ran during the canary: {held}")
        n_routed = max(i for i, a in enumerate(arms) if a == 2) + 1
        n_canary = arms[:n_routed].count(2)
        check(abs(n_canary - round(n_routed * CANARY_BODY["canaryFraction"]))
              <= 1, f"{n_canary} of {n_routed} queries went to the canary")
        check(b2[1] + b2[2] == len(arms), "B2 launches differ from the "
              "scored queries")

        # 4. the held fold-in lands after the verdict -------------------
        spd0 = kernels.counts()["spd_solve"]
        deadline = time.monotonic() + 30
        while ctl.applied_users < cf["users"] \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        applied_s = time.perf_counter() - t_verdict
        check(ctl.applied_users == cf["users"], f"{ctl.applied_users} of "
              f"{cf['users']} held users folded after the verdict")
        applies = _settled_applies(ctl, applies0, 0)
        solves = [sv for a in applies for sv in a["solves"]]
        b1 = kernels.counts()["spd_solve"] - spd0
        check(b1 >= 1 and b1 == len(solves)
              and all(sv["K"] == rank for sv in solves),
              f"the held fold-in launched B1 {b1} times for {solves}")
        bound = cf["interval_s"] + max(a["apply_s"] for a in applies) + 0.5
        check(applied_s <= bound, f"held users applied {applied_s:.3f} s "
              f"after the verdict, over {bound:.3f} s")
        for uid in fresh:
            status, body, _ = client.call("POST", "/queries.json",
                                          {"user": uid, "num": 10})
            check(status == 200 and len(body["itemScores"]) == 10,
                  f"folded {uid} answered {status} {body}")

        # 5. shadow v3, then the operator's abort -------------------------
        picks = rng.choice(n_users, SHADOW_QUERIES, replace=False)

        def drive(tag):
            ms = []
            for ui in picks:
                status, body, dt = client.call(
                    "POST", "/queries.json", {"user": str(users[ui]),
                                              "num": 10})
                check(status == 200 and _arm_match(body, exact(2, int(ui))),
                      f"{tag}: {users[ui]} was not served v2's top-10")
                ms.append(dt * 1e3)
            return ms

        kernels.reset_counts()
        plain_ms = drive("before the shadow")
        plain_b2 = kernels.counts()["shortlist"]
        status, out, dt = client.call("POST", "/deploy.json", SHADOW_BODY)
        check(status == 200 and out.get("message") == "Canary started"
              and out["canary"]["shadow"] is True,
              f"shadow deploy answered {status}: {out}")
        prepare3 = prepare_split(out)
        log("canary: v3 prepared " + json.dumps(prepare3))
        kernels.reset_counts()
        shadow_ms = drive("under the shadow")
        deadline = time.monotonic() + 30
        while True:
            _, st, _ = client.call("GET", "/deploy/status.json")
            mirrored = st["canary"]["canary"]["total"]
            if mirrored >= SHADOW_QUERIES or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        shadow_b2 = kernels.counts()["shortlist"]
        check(mirrored == SHADOW_QUERIES and st["canary"]["decided"] is None,
              f"the shadow judged {mirrored} of {SHADOW_QUERIES}: "
              f"{st['canary']}")
        check(shadow_b2 == 2 * SHADOW_QUERIES and plain_b2 == SHADOW_QUERIES,
              f"B2 launched {plain_b2} times for {SHADOW_QUERIES} plain "
              f"queries and {shadow_b2} under the shadow")
        status, out, abort_dt = client.call("POST", "/rollback.json")
        check(status == 200 and out["message"] == "Canary aborted",
              f"the abort answered {status}: {out}")
        _, rels, _ = client.call("GET", "/releases.json")
        statuses3 = {r["version"]: r["status"] for r in rels["releases"]}
        check(statuses3.get(3) == "ROLLED_BACK",
              f"straight after the abort the registry reads {statuses3}")

        report = {
            "card": card_line(), "items": n_items, "rank": rank,
            "users": n_users, "v1_warm_s": warm_s, "blob_mb": blob_mb,
            "candidates_built_and_stored_s": setup_s,
            "prepare_v2": prepare2, "prepare_v3": prepare3,
            "queries": len(arms), "routed": n_routed,
            "canary_queries": n_canary,
            "realized_fraction": n_canary / n_routed,
            "incumbent_http": _lat(lat[1]), "canary_http": _lat(lat[2]),
            "verdict": verdict["decision"], "verdict_reason":
            verdict["reason"], "promote_swap_ms": verdict["seconds"] * 1e3,
            "b2_launches": {"incumbent": b2[1], "canary": b2[2],
                            "shadow_leg_plain": plain_b2,
                            "shadow_leg_mirrored": shadow_b2},
            "releases_after_verdict": statuses,
            "held_foldin": {**held, "applied_s_after_verdict": applied_s,
                            "bound_s": bound, "b1_launches": b1,
                            "apply_split": _split_summary(applies)},
            "shadow": {"queries": SHADOW_QUERIES,
                       "incumbent_before": _lat(plain_ms),
                       "incumbent_with_shadow": _lat(shadow_ms),
                       "p50_delta_ms": float(np.percentile(shadow_ms, 50)
                                             - np.percentile(plain_ms, 50)),
                       "shadow_judged": st["canary"]["canary"]},
            "abort_ms": out["seconds"] * 1e3, "abort_http_ms": abort_dt * 1e3,
            "releases_after_abort": statuses3,
            "deploy_counts": {k: v for k, v in st["deploy"].items()
                              if k != "recentEvents"},
        }
        return report
    finally:
        if buf is not None:
            buf.stop()
        if lt is not None:
            if server is not None:
                lt.run(server.close(), timeout=120)
            lt.stop()
        elif server is not None:
            server._predict_executor.shutdown(wait=False)
            server._deploy_executor.shutdown(wait=True)
        arms_dev.clear()
        scoring.set_process_scorer_config(None)
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def item_ids(n: int, width: int = 8):
    """'i' + zero-padded decimal ids, built without a Python loop."""
    import numpy as np

    digits = (np.arange(n, dtype=np.int64)[:, None]
              // (10 ** np.arange(width - 1, -1, -1, dtype=np.int64))) % 10
    chars = np.empty((n, width + 1), np.uint32)
    chars[:, 0] = ord("i")
    chars[:, 1:] = ord("0") + digits
    return chars.view(f"<U{width + 1}").reshape(n)


def build_model(seed: int, n_items: int, n_users: int, rank: int):
    """Factors with the geometrically decaying spectrum of the reference
    bench's top-k scoring config (trained ALS factor Gramians decay),
    drawn on the card (``card_factors``), and their ids."""
    import numpy as np

    U, V = card_factors(seed, n_items, n_users, rank)
    users = np.array([f"u{i:06d}" for i in range(n_users)])
    return users, item_ids(n_items), U, V


def card_factors(seed: int, n_items: int, n_users: int, rank: int):
    """(U, V): standard normal rows under a geometrically decaying
    spectrum, drawn on the card from ``seed`` and brought to the host:
    numpy takes seconds for a 10M-row draw, the card milliseconds."""
    import numpy as np
    import torch

    spec = torch.from_numpy(np.power(
        10.0, -1.5 * np.arange(rank) / max(1, rank - 1)).astype(
            np.float32)).to(DEV)
    g = torch.Generator(device=DEV).manual_seed(seed)
    V = (torch.randn((n_items, rank), generator=g, device=DEV) * spec).cpu()
    U = (torch.randn((n_users, rank), generator=g, device=DEV) * spec).cpu()
    return U.numpy(), V.numpy()


def model_layer_p50_ms(users, items, U, V, rows) -> float:
    """Median wall time of ``ALSModel.recommend_batch`` for one plain
    query, in this process and without HTTP: the model layer's share of
    a served query (rotation, uploads, kernel, download, exact rescore,
    result assembly). The scorer build before the clock is set-up."""
    import numpy as np

    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import scoring
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    scoring.set_process_scorer_config(ScorerConfig(
        mode="twostage", tile_items=TILE, shortlist=SHORTLIST))
    model = ALSModel.from_arrays(users, items, U, V)
    model.recommend_batch([(str(users[rows[0]]), 10, (), None)])
    check(model._scorer_cache[2].active, "in-process scorer was demoted")
    times = []
    for ui in rows:
        t0 = time.perf_counter()
        model.recommend_batch([(str(users[ui]), 10, (), None)])
        times.append((time.perf_counter() - t0) * 1e3)
    del model
    return float(np.median(times))


class Server:
    """A server command of the port's CLI (``deploy``, ``eventserver``)
    in a subprocess; its stdout lines are relayed until it listens."""

    def __init__(self, args, env: dict, tag: str = "serve",
                 checked: bool = False):
        self.tag = tag
        # checked: through _CHECKED_CLI, whose last line names the
        # forbidden modules the process held (read by forbidden_modules)
        launcher = (["-c", _CHECKED_CLI] if checked
                    else ["-m", "predictionio_tpu_torch.cli.main"])
        self.proc = subprocess.Popen(
            [sys.executable, *launcher, *args], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, text=True)
        self.lines: "queue.Queue[str]" = queue.Queue()
        #: every line so far (a router's carries its replicas' lines)
        self.history: list = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.history.append(line)
            self.lines.put(line)
        self.lines.put("")

    def wait_ready(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            check(left > 0, f"{self.tag}: server did not come up in time")
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                continue
            check(line != "", f"{self.tag}: server exited (rc "
                  f"{self.proc.poll()})")
            log(f"{self.tag}: [server] " + line.rstrip())
            if "listening on" in line:
                return int(line.rsplit(":", 1)[1])

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


class Client:
    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("localhost", port, timeout=300)

    def call(self, method: str, path: str, body=None, raw: bool = False):
        """(status, JSON body, or its bytes with ``raw``, seconds)."""
        data = json.dumps(body).encode() if body is not None else None
        t0 = time.perf_counter()
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        payload = resp.read()
        if not raw:
            payload = json.loads(payload)
        return resp.status, payload, time.perf_counter() - t0


#: the serve cell's model: rank and users (bench.py:2658-2668)
SERVE_RANK, SERVE_USERS = 64, 138_493


def serve_phase(seed: int, n_items: int, port: int, shape: dict,
                users, items, U, V):
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.workflow.serialization import save_model

    rank, n_users = V.shape[1], len(users)
    t0 = time.perf_counter()
    WORK.mkdir(parents=True, exist_ok=True)
    model_path = WORK / "als_model.npz"
    save_model(model_path, ALSModel.from_arrays(users, items, U, V))
    log(f"serve: model {n_items} items x rank {rank}, {n_users} users, "
        f"saved in {time.perf_counter() - t0:.3f} s")

    env = dict(os.environ, PIO_SCORER_MODE="twostage",
               PIO_SCORER_TILE_ITEMS=str(TILE),
               PIO_SCORER_SHORTLIST=str(SHORTLIST))
    server = Server(["deploy", "--model", str(model_path), "--port",
                     str(port), "--device", DEV], env)
    try:
        t1 = time.perf_counter()
        bound_port = server.wait_ready(timeout_s=600)
        log(f"serve: deploy (load + scorer build + parity gate + warm-up) "
            f"took {time.perf_counter() - t1:.3f} s")
        client = Client(bound_port)
        status, root, _ = client.call("GET", "/")
        check(status == 200, f"GET / answered {status}")
        scorer = root["scorer"]
        check(len(scorer) == 1, f"expected one built scorer, got {scorer}")
        scorer = scorer[0]
        log("serve: scorer " + json.dumps(scorer))
        check(scorer["activeMode"] == "twostage",
              f"scorer serves {scorer['activeMode']!r}: the parity gate "
              f"demoted it (probe recall {scorer['recallProbe']})")
        # the kernels phase checked the kernel at the shapes served here
        from predictionio_tpu_torch.ops.scoring import twostage_cand
        got_shape = (scorer["scanRank"], scorer["tileItems"],
                     scorer["tiles"])
        check(got_shape == (shape["R"], shape["T"], shape["nt"]),
              f"served (scan rank, tile, tiles) {got_shape} is not the "
              f"shape the kernels phase checked")
        per_tile = scorer["shortlist"] // scorer["tiles"]
        for kind, (num, masked) in QUERY_KINDS.items():
            c = twostage_cand(per_tile, scorer["tiles"],
                              scorer["tileItems"], num, masked)
            check(c == shape["c"][kind], f"{kind} queries run the kernel "
                  f"at c={c}, the kernels phase checked {shape['c'][kind]}")
        # the server zeroes its counts once warm, just before it takes
        # traffic: the main path's launches are the counts read after
        warm_launches = root["warmupKernelLaunches"]["shortlist"]
        check(all(v == 0 for v in root["kernelLaunches"].values()),
              f"launch counts not zero before the queries: "
              f"{root['kernelLaunches']}")

        # queries --------------------------------------------------------
        rng = np.random.default_rng(seed + 1)
        picks = rng.choice(n_users, size=34, replace=False)
        V_dev = torch.from_numpy(V).cuda()

        def exact_top(ui: int, k: int, allow=None, block=()):
            u = torch.from_numpy(U[ui]).cuda()
            sc = V_dev @ u
            if allow is not None:
                keep = torch.zeros(n_items, dtype=torch.bool, device="cuda")
                keep[torch.as_tensor(allow, device="cuda")] = True
                sc = sc.masked_fill(~keep, float("-inf"))
            if len(block):
                sc[torch.as_tensor(block, device="cuda")] = float("-inf")
            vals, idx = torch.topk(sc, k)
            fin = torch.isfinite(vals)
            return idx[fin].cpu().numpy(), sc

        queries = []
        def num(kind):
            return QUERY_KINDS[kind][0]

        for ui in picks[:24]:
            queries.append(("plain", int(ui), {"num": num("plain")},
                            None, ()))
        for ui in picks[24:28]:
            top, _ = exact_top(int(ui), 3)
            queries.append(("blackList", int(ui),
                            {"num": num("blackList"),
                             "blackList": [str(items[i]) for i in top]},
                            None, tuple(int(i) for i in top)))
        for ui in picks[28:32]:
            allow = np.sort(rng.choice(n_items, size=500, replace=False))
            queries.append(("whiteList", int(ui),
                            {"num": num("whiteList"),
                             "whiteList": [str(items[i]) for i in allow]},
                            allow, ()))
        for ui in picks[32:34]:
            queries.append(("num>shortlist", int(ui),
                            {"num": num("num>shortlist")}, None, ()))
        queries.append(("unknown", -1, {"num": 10}, None, ()))
        queries.append(("unknown", -2, {"num": 10}, None, ()))

        hits = total = 0
        lat = []
        plain_answers = {}
        max_score_err = 0.0
        last = 0
        for kind, ui, extra, allow, block in queries:
            user = users[ui] if ui >= 0 else f"nobody{-ui}"
            status, body, dt = client.call(
                "POST", "/queries.json", dict(user=str(user), **extra))
            check(status == 200, f"{kind} query answered {status}: {body}")
            got = body["itemScores"]
            _, root, _ = client.call("GET", "/")
            now = root["kernelLaunches"]["shortlist"]
            if ui < 0:
                check(got == [], f"unknown user got {got}")
                check(now == last, "an unknown user's query launched the "
                      "kernel")
                continue
            lat.append((kind, dt))
            if kind == "plain":
                plain_answers[str(user)] = got
            check(now > last, f"{kind} query did not launch the shortlist "
                  "kernel")
            last = now
            num = extra["num"]
            check(len(got) == num, f"{kind}: {len(got)} items, asked {num}")
            got_ids = np.array([int(s["item"][1:]) for s in got])
            got_sc = np.array([s["score"] for s in got])
            check(not set(got_ids) & set(block),
                  f"{kind}: blacklisted item served")
            if allow is not None:
                check(set(got_ids) <= set(allow.tolist()),
                      f"{kind}: item outside the whitelist served")
            top, sc = exact_top(ui, 10, allow, block)
            hits += len(set(top.tolist()) & set(got_ids[:10].tolist()))
            total += len(top)
            exact_sc = sc[torch.as_tensor(got_ids, device="cuda")].cpu().numpy()
            err = np.abs(got_sc - exact_sc)
            max_score_err = max(max_score_err, float(err.max()))
            check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(exact_sc))).all()),
                  f"{kind}: served scores differ from exact f32 by "
                  f"{float(err.max())}")
        recall = hits / total
        launches = last
        lat_ms = np.array([dt for _, dt in lat]) * 1e3
        by_kind = {}
        for kind, dt in lat:
            by_kind.setdefault(kind, []).append(dt * 1e3)
        serve = {
            "card": card_line(),
            "scored_queries": len(lat),
            "recall_at_10": recall,
            "max_score_abs_err": max_score_err,
            "query_p50_ms": float(np.percentile(lat_ms, 50)),
            "query_p99_ms": float(np.percentile(lat_ms, 99)),
            "query_max_ms": float(lat_ms.max()),
            "p50_ms_by_kind": {k: float(np.median(v))
                               for k, v in by_kind.items()},
            "model_layer_p50_ms": model_layer_p50_ms(
                users, items, U, V, [ui for k, ui, *_ in queries
                                     if k == "plain"]),
            "factor_bytes": scorer["factorBytes"],
            "exact_bytes": scorer["exactBytes"],
            "scan_rank": scorer["scanRank"],
            "tiles": scorer["tiles"],
            "shortlist": scorer["shortlist"],
            "recall_probe": scorer["recallProbe"],
            "warmup_launches": warm_launches,
            "shortlist_launches": launches,
            "reduced": None if n_items == 10_000_000 else
            f"items {n_items} instead of 10000000",
        }
        log("serve: " + json.dumps(serve))
        check(recall >= 0.99, f"recall@10 {recall:.4f} < 0.99 vs exact")
        check(launches > 0, "the shortlist kernel never launched while "
              "serving")
        # the distributed phase's sharded deploy answers the same queries
        serve["plain_answers"] = plain_answers
        return serve
    finally:
        # the model file stays for the obs phase; main removes WORK
        server.stop()


# ---------------------------------------------------------------------------
# obs phase: the serving observability plane on the serve cell's model
# ---------------------------------------------------------------------------

#: the phase's traffic: 34 queries from one client (the serve phase's
#: count), then 384 from 8 clients (cfg_telemetry's per_level and
#: n_clients, bench.py:2502-2503); leg 2's protocol (bench.py:1198-1238,
#: :2538-2591): alternating best-of-3 p99, cut to best-of-2 for the time
#: limit, a 50 ms scrape; the store
#: legs at the bench's sizes (:2596-2640); live device bytes beyond the
#: serving unit's tensors a capacity read may find (small tensors)
OBS = dict(serial=34, clients=8, per_level=384, repeats=2, scrape_s=0.05,
           interval_s=1.0, profile_s=2.0, store_series=10_000,
           store_ticks=12, canary_items=4096, canary_queries=23,
           slack_bytes=64 << 20)
#: a latency objective at a histogram bucket edge (0.5 ms x 2^5), so the
#: burn read back is exact; the reference's default windows
OBS_SLO = {"objectives": [
    {"name": "p99", "kind": "latency", "thresholdS": 0.016, "budget": 0.01},
    {"name": "errors", "kind": "errors", "budget": 0.01}],
    "windows": [{"seconds": 300, "burnThreshold": 14.4},
                {"seconds": 3600, "burnThreshold": 6.0}],
    "evalIntervalS": 1.0}
#: the reference's limit on the plane's p99 cost (bench.py:1233-1238)
OBS_LIMIT_PCT, OBS_LIMIT_ABS_MS = 5.0, 0.3


def _metric(doc: dict, name: str):
    return doc.get(name, {}).get("samples", [])


def _clients_run(port: int, users, n: int, clients: int, seed: int,
                 failures: list, until: threading.Event = None):
    """``n`` plain queries of num 10 from ``clients`` threads, each on
    its own keep-alive connection (with ``until``: each client goes on
    through its share again until the event is set); returns the
    latencies in seconds (of 200s; anything else lands in
    ``failures``)."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(users), size=n)
    per = -(-n // clients)
    lat, lock = [], threading.Lock()

    def run(lo):
        c = Client(port)
        share = picks[lo:lo + per]
        for k, ui in enumerate(share if until is None
                               else itertools.cycle(share)):
            if until is not None and k >= len(share) and until.is_set():
                return
            try:
                status, body, dt = c.call("POST", "/queries.json", {
                    "user": str(users[ui]), "num": 10})
            except Exception as e:          # noqa: BLE001 — reported
                failures.append(repr(e))
                return
            with lock:
                if status == 200:
                    lat.append(dt)
                else:
                    failures.append(f"{status} {str(body)[:200]}")

    threads = [threading.Thread(target=run, args=(lo,))
               for lo in range(0, n, per)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "obs: clients hung")
    return lat


def dispatch_s(metrics_json: dict) -> float:
    """The ``shortlist`` family's dispatch seconds in a /metrics.json."""
    return next((s["value"] for s in _metric(
        metrics_json, "pio_device_dispatch_seconds_total")
        if s["labels"]["family"] == "shortlist"), 0.0)


def _stage_split(traces, ids, label: str):
    """Per request of ``ids``: its wall stages, the middleware's own
    stage around the handler, their sum and the middleware's wall;
    prints each request's gap (wall - the stages' sum: the largest, its
    request, the p99) and the middleware stage (the largest, its
    request, the p99), then checks that the stages tile the wall."""
    import numpy as np

    from predictionio_tpu_torch.obs.anatomy import (
        MIDDLEWARE_STAGE, SERVING_WALL_STAGES, TRACE_STAGE_PREFIX,
    )

    stages = SERVING_WALL_STAGES + (MIDDLEWARE_STAGE,)
    by_id = {t["traceId"]: t for t in traces
             if t["name"] == "query_server POST /queries.json"}
    missing = [i for i in ids if i not in by_id]
    check(not missing, f"obs: {len(missing)} requests have no trace")
    rows = []
    for rid in ids:
        t = by_id[rid]
        st = {s: t["spans"].get(TRACE_STAGE_PREFIX + s) for s in stages}
        check(None not in st.values(), f"obs: request {rid} lacks stages "
              f"{[s for s, v in st.items() if v is None]}")
        wall = t["durationSec"]
        rows.append((st, wall, wall - sum(st.values()), rid))
    gaps_ms = np.array([r[2] for r in rows]) * 1e3
    worst = rows[int(np.abs(gaps_ms).argmax())]
    mw_ms = np.array([r[0][MIDDLEWARE_STAGE] for r in rows]) * 1e3
    mw_worst = rows[int(mw_ms.argmax())]
    log(f"obs: {label} gap (wall - stages) over {len(rows)} requests: "
        f"largest {worst[2] * 1e3:.6f} ms (request {worst[3]}, wall "
        f"{worst[1] * 1e3:.3f} ms, stages "
        f"{ {s: round(v * 1e3, 3) for s, v in worst[0].items()} }), p99 "
        f"{float(np.percentile(np.abs(gaps_ms), 99)):.6f} ms, median "
        f"{float(np.median(gaps_ms)):.6f} ms")
    log(f"obs: {label} middleware stage: largest {float(mw_ms.max()):.6f}"
        f" ms (request {mw_worst[3]}, wall {mw_worst[1] * 1e3:.3f} ms), "
        f"p99 {float(np.percentile(mw_ms, 99)):.6f} ms, median "
        f"{float(np.median(mw_ms)):.6f} ms")
    for st, wall, gap, rid in rows:
        check(abs(gap) <= max(0.1 * wall, 0.0005),
              f"obs: request {rid}'s stages sum to {sum(st.values())} s "
              f"against its wall {wall} s")
    out = {s: {"p50_ms": float(np.percentile([r[0][s] for r in rows], 50))
               * 1e3,
               "p99_ms": float(np.percentile([r[0][s] for r in rows], 99))
               * 1e3} for s in stages}
    walls = np.array([r[1] for r in rows]) * 1e3
    out["wall"] = {"p50_ms": float(np.percentile(walls, 50)),
                   "p99_ms": float(np.percentile(walls, 99))}
    out["unattributed_max_ms"] = float(np.abs(gaps_ms).max())
    out["unattributed_p99_ms"] = float(np.percentile(np.abs(gaps_ms), 99))
    out["unattributed_max_request"] = worst[3]
    out["middleware_max_ms"] = float(mw_ms.max())
    out["middleware_max_request"] = mw_worst[3]
    return out


def obs_server_leg(seed: int, users, shape: dict):
    """Legs 1, 3 (history, SLO, capacity) and 4 on a ``deploy`` of the
    serve cell's model (saved by the serve phase) with tracing, the
    anatomy, an SLO spec and telemetry at a 1 s interval under a fresh
    PIO_HOME."""
    import numpy as np

    from predictionio_tpu_torch.obs.anatomy import STAGE_HISTOGRAM

    o = OBS
    home = WORK / "obs" / "home"
    shutil.rmtree(home, ignore_errors=True)
    (home / "conf").mkdir(parents=True)
    (home / "conf" / "server.json").write_text(json.dumps({"slo": OBS_SLO}))
    env = dict(os.environ, PIO_HOME=str(home), PIO_SCORER_MODE="twostage",
               PIO_SCORER_TILE_ITEMS=str(TILE),
               PIO_SCORER_SHORTLIST=str(SHORTLIST),
               PIO_TELEMETRY_INTERVAL_S=str(o["interval_s"]),
               PIO_TRACE_CAPACITY="4096")
    server = Server(["deploy", "--model", str(WORK / "als_model.npz"),
                     "--port", "0", "--device", DEV], env, tag="obs")
    try:
        t0 = time.perf_counter()
        port = server.wait_ready(timeout_s=600)
        deploy_s = time.perf_counter() - t0
        client = Client(port)
        _, root0, _ = client.call("GET", "/")
        scorer = root0["scorer"][0]
        check(scorer["activeMode"] == "twostage"
              and (scorer["scanRank"], scorer["tileItems"],
                   scorer["tiles"]) == (shape["R"], shape["T"],
                                        shape["nt"]),
              f"obs: the deploy serves {scorer}")
        status, slo0, _ = client.call("GET", "/slo.json")  # the baseline
        check(status == 200 and slo0["enabled"], f"obs: /slo.json {slo0}")
        _, mj0, _ = client.call("GET", "/metrics.json")

        # leg 1: 34 queries from one client, 384 from 8 ----------------------
        rng = np.random.default_rng(seed + 11)
        ids, serial_lat = [], []
        for ui in rng.integers(0, len(users), size=o["serial"]):
            client.conn.request("POST", "/queries.json", body=json.dumps(
                {"user": str(users[ui]), "num": 10}))
            t_q = time.perf_counter()
            resp = client.conn.getresponse()
            body = resp.read()
            serial_lat.append(time.perf_counter() - t_q)
            check(resp.status == 200, f"obs: a query answered {resp.status}"
                  f" {body[:200]}")
            ids.append(resp.getheader("X-Request-ID"))
        failures = []
        conc_lat = _clients_run(port, users, o["per_level"], o["clients"],
                                seed + 12, failures)
        check(not failures, f"obs: {len(failures)} queries failed at 8 "
              f"clients, first {failures[:3]}")
        _, tr, _ = client.call("GET", "/debug/traces.json?limit=4096")
        traces = tr["traces"]
        serial_split = _stage_split(traces, ids, "serial")
        conc_ids = [t["traceId"] for t in traces
                    if t["name"] == "query_server POST /queries.json"
                    and t["traceId"] not in set(ids)]
        check(len(conc_ids) == o["per_level"], f"obs: {len(conc_ids)} "
              f"traced requests at 8 clients of {o['per_level']}")
        conc_split = _stage_split(traces, conc_ids, "clients8")
        _, root1, _ = client.call("GET", "/")
        _, mj, _ = client.call("GET", "/metrics.json")
        launches = root1["kernelLaunches"]["shortlist"]
        batches = root1["microBatches"]["batches"] - \
            root0["microBatches"]["batches"]
        scored = sum(s["value"] for s in _metric(
            mj, "pio_scoring_batches_total")
            if s["labels"]["mode"] == "twostage")
        dispatch = root1["dispatchCalls"].get("shortlist", 0) - \
            root0["dispatchCalls"].get("shortlist", 0)
        check(launches == batches == dispatch,
              f"obs: B2 launched {launches} times for {batches} batches, "
              f"{dispatch} shortlist dispatches")
        n_sent = o["serial"] + o["per_level"]
        stage_counts = {s["labels"]["stage"]: s["count"] for s in _metric(
            mj, STAGE_HISTOGRAM) if s["labels"]["path"] == "serving"}
        check(all(v == n_sent for v in stage_counts.values())
              and len(stage_counts) == 8,
              f"obs: pio_anatomy_stage_seconds counts {stage_counts}")
        leg1 = {
            "serial": dict(serial_split, http=_lat(
                [x * 1e3 for x in serial_lat])),
            "clients8": dict(conc_split, http=_lat(
                [x * 1e3 for x in conc_lat])),
            "b2_launches": launches, "batches": batches,
            "scoring_batches_total": scored,
            "shortlist_dispatches": dispatch,
            "dispatch_launch_ms_mean": 1e3 * (
                dispatch_s(mj) - dispatch_s(mj0)) / max(1, dispatch),
            "batch_sizes": root1["microBatches"]["sizes"]}
        log("obs: leg 1 " + json.dumps(leg1))

        # leg 4: a 2 s profile while 8 clients run --------------------------
        prof_dir = WORK / "obs" / "profile"
        answers = {}

        def capture(key, delay):
            time.sleep(delay)
            c = Client(port)
            answers[key] = c.call("POST", "/debug/profile", {
                "seconds": o["profile_s"], "dir": str(prof_dir)})

        grabs = [threading.Thread(target=capture, args=(k, d))
                 for k, d in (("first", 0.0), ("second", 0.5))]
        for g in grabs:
            g.start()
        # the clients run until the capture has answered: a process's
        # first capture spends seconds starting the profiler (CUPTI)
        # before its window opens
        captured = threading.Event()
        watcher = threading.Thread(target=lambda: (
            grabs[0].join(timeout=300), captured.set()))
        watcher.start()
        failures = []
        prof_lat = _clients_run(port, users, o["per_level"], o["clients"],
                                seed + 13, failures, until=captured)
        watcher.join(timeout=300)
        for g in grabs:
            g.join(timeout=120)
        check(not failures, f"obs: {len(failures)} queries failed during "
              f"the capture, first {failures[:3]}")
        status, out, _ = answers["first"]
        check(status == 200, f"obs: POST /debug/profile answered {status} "
              f"{out}")
        check(answers["second"][0] == 409, "obs: a second capture answered "
              f"{answers['second'][0]}, not 409")
        trace_path = pathlib.Path(out["traceDir"]) / "trace.json"
        text = trace_path.read_text()
        check("shortlist_kernel" in text, "obs: the profile's trace does "
              "not name shortlist_kernel")
        leg4 = {"capture_s": out["seconds"],
                "capture_request_s": answers["first"][2],
                "queries_during": len(prof_lat),
                "trace_mb": trace_path.stat().st_size / 1e6,
                "kernel_events": text.count("shortlist_kernel"),
                "dispatch_table": out["dispatch"],
                "http_during_capture": _lat([x * 1e3 for x in prof_lat])}
        log("obs: leg 4 " + json.dumps(leg4))

        # leg 3: history, SLO and capacity ----------------------------------
        n_ok = n_sent + len(prof_lat)
        time.sleep(2.5 * o["interval_s"])        # a scrape past the last
        _, hist, _ = client.call(
            "GET", "/history/range.json?name=pio_query_duration_seconds")
        points = hist["series"][0]["points"] if hist["series"] else []
        check(points and points[-1][1] == n_ok, "obs: the history's last "
              f"pio_query_duration_seconds point counts "
              f"{points[-1][1] if points else None}, sent {n_ok}")
        _, slo, _ = client.call("GET", "/slo.json")
        _, mj, _ = client.call("GET", "/metrics.json")
        qd = _metric(mj, "pio_query_duration_seconds")[0]
        bad = qd["count"] - qd["buckets"]["0.016"]
        lat_obj = next(x for x in slo["objectives"] if x["name"] == "p99")
        w = lat_obj["windows"][0]
        want_burn = (bad / qd["count"]) / 0.01
        check(w["total"] == n_ok and w["bad"] == bad
              and abs(w["burn"] - want_burn) <= 1e-3,
              f"obs: /slo.json latency window {w}, served {n_ok} with "
              f"{bad} above 16 ms")
        _, cap, _ = client.call("GET", "/capacity.json")
        unit = cap["units"][0]
        dev_bytes = cap["process"]["deviceBytes"]
        check(unit["scorerBytes"] == scorer["factorBytes"] > 0
              and dev_bytes >= unit["residentBytes"] >= unit["scorerBytes"]
              and dev_bytes - unit["residentBytes"] <= OBS["slack_bytes"],
              f"obs: capacity {unit['scorerBytes']} scorer / "
              f"{unit['residentBytes']} resident / {dev_bytes} on the card, "
              f"the scorer's status {scorer['factorBytes']}")
        leg3 = {"history_points": len(points),
                "slo": {x["name"]: x["windows"][0] for x in
                        slo["objectives"]},
                "above_16ms": bad, "served": n_ok,
                "capacity": {"scorer_bytes": unit["scorerBytes"],
                             "resident_bytes": unit["residentBytes"],
                             "device_bytes": dev_bytes,
                             "untracked_bytes": dev_bytes
                             - unit["residentBytes"],
                             "watermark_bytes":
                                 cap["process"]["deviceWatermarkBytes"],
                             "host_rss_bytes":
                                 cap["process"]["hostRssBytes"]}}
        _, root2, _ = client.call("GET", "/")
        b2 = root2["kernelLaunches"]["shortlist"]
        log("obs: leg 3 (server) " + json.dumps(leg3))
        return {"deploy_s": deploy_s, "leg1": leg1, "leg3": leg3,
                "leg4": leg4, "b2_launches": b2}
    finally:
        server.stop()


def obs_overhead_leg(seed, users, eng, result):
    """Leg 2: the plane's p99 cost at 8 clients, alternating best-of-N
    (``OBS["repeats"]``; the reference bench's best-of-3,
    bench.py:1140-1238, :2538-2591), each
    sweep a fresh server in this process: tracing plus an SLO engine
    evaluating every 50 ms against ``PIO_TRACING=0`` without one; the
    anatomy against ``PIO_ANATOMY=0`` (tracing on both); telemetry at a
    50 ms scrape against none."""
    import tempfile

    import numpy as np

    from predictionio_tpu_torch.deploy.warm import EngineInstance
    from predictionio_tpu_torch.obs.slo import (
        SLOObjective, SLOSpec, SLOWindow,
    )
    from predictionio_tpu_torch.obs.telemetry import TelemetryRecorder
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.utils.server_config import (
        ScorerConfig, TelemetryConfig,
    )

    o = OBS
    scfg = ScorerConfig(mode="twostage", tile_items=TILE,
                        shortlist=SHORTLIST)
    # the reference's: full evaluation work, a threshold it never flips
    slo = SLOSpec(objectives=[
        SLOObjective("latency", "latency", threshold_s=0.256, budget=0.01),
        SLOObjective("errors", "errors", budget=0.01)],
        windows=[SLOWindow(2.0, 1e12)], eval_interval_s=0.05)

    def sweep(env, telemetry=None, slo_spec=None):
        os.environ.update(env)
        server = QueryServer(eng, result, EngineInstance(id="obs-leg2"),
                             scorer_config=scfg, telemetry=telemetry,
                             slo_spec=slo_spec)
        lt = _LoopThread()
        try:
            port = lt.run(server.start("127.0.0.1", 0))
            failures = []
            _clients_run(port, users, o["per_level"], o["clients"],
                         seed + 21, failures)                # warm-up
            lat = np.array(_clients_run(
                port, users, o["per_level"], o["clients"], seed + 22,
                failures)) * 1e3
            check(not failures, f"obs: leg 2 failures {failures[:3]}")
            return (float(np.percentile(lat, 50)),
                    float(np.percentile(lat, 99)))
        finally:
            lt.run(server.close())
            lt.stop()

    def telemetry():
        root = tempfile.mkdtemp(prefix="obs-telemetry-",
                                dir=str(WORK / "obs"))
        return TelemetryRecorder("query_server", TelemetryConfig(
            dir=root, interval_s=o["scrape_s"])).start(restore=False)

    on = {"PIO_TRACING": "1", "PIO_ANATOMY": "1"}
    legs = {
        "tracing_slo": (dict(on, PIO_TRACING="0"), {},
                        on, {"slo_spec": slo}),
        "anatomy": (dict(on, PIO_ANATOMY="0"), {}, on, {}),
        "telemetry": (on, {}, on, {"telemetry": True})}
    saved = {k: os.environ.get(k) for k in on}
    out = {}
    try:
        for name, (off_env, off_kw, on_env, on_kw) in legs.items():
            runs = {"on": [], "off": []}
            for _ in range(o["repeats"]):
                runs["off"].append(sweep(off_env, **off_kw))
                kw = dict(on_kw)
                if kw.pop("telemetry", False):
                    kw["telemetry"] = telemetry()
                runs["on"].append(sweep(on_env, **kw))
            p99_on = min(r[1] for r in runs["on"])
            p99_off = min(r[1] for r in runs["off"])
            limit = p99_off * (1 + OBS_LIMIT_PCT / 100.0) + OBS_LIMIT_ABS_MS
            out[name] = {
                "p99_on_ms": p99_on, "p99_off_ms": p99_off,
                "overhead_pct": 100.0 * (p99_on - p99_off) / p99_off,
                "limit_ms": limit, "within_limit": p99_on <= limit,
                "p50_on_ms": min(r[0] for r in runs["on"]),
                "p50_off_ms": min(r[0] for r in runs["off"]),
                "runs_on": runs["on"], "runs_off": runs["off"]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def obs_restart_leg(seed, users, items, U, eng, result, rel1, inst1):
    """Leg 3's restart, in this process: a server with an SLO spec and
    telemetry (1 s) into a fresh store runs a canary of v2 at 0.2 and is
    stopped mid-rollout; a second server on the same store rehydrates
    the SLO engine and resumes the canary's split from the last
    persisted accumulator. A second live writer gets TSDBLocked."""
    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.obs.slo import SLOSpec
    from predictionio_tpu_torch.obs.telemetry import TelemetryRecorder
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.utils.server_config import (
        DeployConfig, FoldinConfig, ScorerConfig, TelemetryConfig,
    )

    o = OBS
    tel_root = WORK / "obs" / "restart"
    shutil.rmtree(tel_root, ignore_errors=True)
    cfg = TelemetryConfig(dir=str(tel_root), interval_s=o["interval_s"])
    spec = SLOSpec.from_dict(OBS_SLO)
    body = {"version": 2, "canaryFraction": 0.2,
            "canaryMinSamples": 10 ** 6, "canaryPromoteAfter": 10 ** 6}

    def make():
        reg = MetricsRegistry()
        rec = TelemetryRecorder("query_server-obs", cfg,
                                registries=[reg]).start()
        return QueryServer(
            eng, result, inst1, release=rel1, registry=reg, telemetry=rec,
            slo_spec=spec,
            scorer_config=ScorerConfig(mode="twostage", tile_items=TILE,
                                       shortlist=SHORTLIST),
            foldin_config=FoldinConfig(enabled=False),
            deploy_config=DeployConfig(warmup=True))

    import numpy as np

    from predictionio_tpu_torch.obs.slo import history_cumulative_pairs
    from predictionio_tpu_torch.obs.tsdb import TSDBReader

    rng = np.random.default_rng(seed + 31)
    lt = _LoopThread()
    server = make()
    try:
        c = Client(lt.run(server.start("127.0.0.1", 0)))
        c.call("GET", "/slo.json")
        for ui in rng.integers(0, len(users), size=o["serial"]):
            status, _, _ = c.call("POST", "/queries.json",
                                  {"user": str(users[ui]), "num": 10})
            check(status == 200, f"obs: restart leg query {status}")
        time.sleep(1.5 * o["interval_s"])        # a scrape of these
        t0 = time.perf_counter()
        status, out, _ = c.call("POST", "/deploy.json", body)
        prepare_s = time.perf_counter() - t0
        check(status == 200 and "canary" in out, f"obs: canary {out}")
        for ui in rng.integers(0, len(users), size=o["canary_queries"]):
            status, _, _ = c.call("POST", "/queries.json",
                                  {"user": str(users[ui]), "num": 10})
            check(status == 200, f"obs: canary query {status}")
        acc = server._canary.controller.splitter.state()
        _, slo_a, _ = c.call("GET", "/slo.json")
        time.sleep(1.5 * o["interval_s"])
        # a second live writer on the store: refused
        probe = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "from predictionio_tpu_torch.obs.tsdb import TSDB, TSDBLocked\n"
             "try:\n    TSDB(sys.argv[1])\nexcept TSDBLocked:\n"
             "    sys.exit(3)\n",
             str(server._telemetry.db.dir)], cwd=str(ROOT),
            capture_output=True, text=True, timeout=120)
        check(probe.returncode == 3, "obs: a second writer was not refused "
              f"(rc {probe.returncode}) {probe.stderr[-500:]}")
        lt.run(server.close())                   # stopped mid-rollout
        # the history begins at the first scrape that saw a query: the
        # restarted engine's windows span from there to the last one
        reader = TSDBReader([str(tel_root / "query_server-obs")])
        first = {o_.name: history_cumulative_pairs(reader, o_, 0)[0]
                 for o_ in spec.objectives}
        server = make()
        restored = sum(len(r) for r in server._slo._rings.values())
        c = Client(lt.run(server.start("127.0.0.1", 0)))
        _, slo_b, _ = c.call("GET", "/slo.json")
        for name in ("p99", "errors"):
            wa = next(x for x in slo_a["objectives"]
                      if x["name"] == name)["windows"][0]
            wb = next(x for x in slo_b["objectives"]
                      if x["name"] == name)["windows"][0]
            _, bad0, total0 = first[name]
            check((wb["bad"], wb["total"]) == (wa["bad"] - bad0,
                                                wa["total"] - total0)
                  and wb["total"] > 0,
                  f"obs: SLO {name} before the restart {wa}, after {wb}, "
                  f"the history's first point {first[name]}")
        status, out, _ = c.call("POST", "/deploy.json", body)
        check(status == 200, f"obs: the second canary answered {status}")
        acc_b = server._canary.controller.splitter.state()
        check(acc_b == acc, f"obs: the splitter resumed at {acc_b}, was "
              f"{acc}")
        c.call("POST", "/rollback.json")
        return {"canary_prepare_s": prepare_s, "splitter_acc": acc,
                "slo_rehydrated_samples": restored,
                "slo_before_restart": {x["name"]: x["windows"][0]
                                       for x in slo_a["objectives"]},
                "slo_after_restart": {x["name"]: x["windows"][0]
                                      for x in slo_b["objectives"]}}
    finally:
        lt.run(server.close())
        lt.stop()


def obs_store_leg():
    """The reference bench's store legs at its own sizes
    (bench.py:2596-2640): a 10,000-series snapshot appended 12 times
    (samples/s), then one metric's range read and a quantile over time
    (ms). Host work: the store never touches the card."""
    import tempfile

    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.obs.tsdb import TSDB, TSDBReader

    n, ticks = OBS["store_series"], OBS["store_ticks"]
    reg = MetricsRegistry()
    wide = reg.counter("pio_bench_wide_total", "bench fanout", ("shard",))
    wide.max_series = n + 8
    lat = reg.histogram("pio_bench_lat_seconds", "bench latency",
                        ("shard",), buckets=(0.01, 0.1, 1.0))
    for i in range(n):
        wide.inc(float(i % 7 + 1), shard=f"s{i:05d}")
    root = tempfile.mkdtemp(prefix="obs-tsdb-", dir=str(WORK / "obs"))
    db = TSDB(os.path.join(root, "bench"))
    t0 = time.perf_counter()
    written = 0
    for tick in range(ticks):
        for i in range(0, n, 97):
            wide.inc(1.0, shard=f"s{i:05d}")
        for i in range(128):
            lat.observe(0.05 * (i % 3 + 1), shard=f"s{i % 64:05d}")
        written += db.append_snapshot(reg.to_snapshot(),
                                      ts_ms=1_700_000_000_000 + 1000 * tick)
    db.flush()
    write_s = time.perf_counter() - t0
    reader = TSDBReader([db.dir])
    t0 = time.perf_counter()
    series = reader.series("pio_bench_lat_seconds")
    range_ms = 1e3 * (time.perf_counter() - t0)
    check(series and len(series[0].points) == ticks, "obs: the store's "
          "range read lost samples")
    t0 = time.perf_counter()
    q99 = reader.quantile_over_time("pio_bench_lat_seconds", 0.99)
    quantile_ms = 1e3 * (time.perf_counter() - t0)
    check(q99 is not None, "obs: no quantile over the store")
    rates = reader.rate("pio_bench_wide_total", labels={"shard": "s00000"})
    check(rates and rates[0]["increase"] > 0, "obs: no rate")
    db.close()
    return {"series": n, "ticks": ticks, "samples": written,
            "samples_per_s": written / write_s, "write_s": write_s,
            "range_ms": range_ms, "quantile_ms": quantile_ms, "q99": q99}


def obs_phase(seed: int, shape: dict, users, items, U, V):
    """The ``obs`` phase: the serve cell's model under the observability
    plane. Returns its report; ``b2_launches`` sums the launches of the
    deploy's legs (its own counts) and of this process's legs (counted
    from zero just before them)."""
    import numpy as np

    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.storage.base import App, EngineInstance, Model
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import ScorerConfig
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    t_phase = time.perf_counter()
    work = WORK / "obs"
    work.mkdir(parents=True, exist_ok=True)
    report = {"card": card_line()}
    report.update(obs_server_leg(seed, users, shape))
    report["store"] = obs_store_leg()
    log("obs: store " + json.dumps(report["store"]))

    n_items, rank = V.shape
    (work / "pio.db").unlink(missing_ok=True)
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(work / "pio.db")}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA",
                                   "MODELDATA")}})
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="ObsApp"))
    Storage.get_events().init_channel(app_id)

    def instance(n):
        inst = EngineInstance(
            id=f"obs-v{n}", status="COMPLETED", engine_id="obs-engine",
            engine_version="1", engine_variant="default",
            data_source_params=json.dumps({"appName": "ObsApp"}),
            algorithms_params=json.dumps(
                [{"name": "als", "params": {"rank": rank}}]))
        Storage.get_meta_data_engine_instances().insert(inst)
        return inst

    inst1 = instance(1)
    rel1 = record_release(inst1, 0.0)
    # v2, the canary: the served users over a 4,096-item catalog (the
    # split under test does not depend on the candidate's width)
    rng = np.random.default_rng(seed + 5)
    V2 = rng.standard_normal((OBS["canary_items"], rank),
                             dtype=np.float32)
    blob = serialize_models([ALSModel.from_arrays(
        users, items[:OBS["canary_items"]], U, V2, device="cpu")])
    inst2 = instance(2)
    Storage.get_model_data_models().insert(Model(id=inst2.id, models=blob))
    check(record_release(inst2, 0.0, blob).version == 2,
          "obs: v2 did not register as release 2")
    del blob
    model = ALSModel.from_arrays(users, items, U, V, device=DEV)
    eng = engine()
    result = eng.prepare_deploy(
        default_engine_params("ObsApp", rank=rank), [model])
    t0 = time.perf_counter()
    QueryServer(eng, result, inst1, scorer_config=ScorerConfig(
        mode="twostage", tile_items=TILE, shortlist=SHORTLIST)).warm()
    report["in_process_build_s"] = time.perf_counter() - t0
    check(model._scorer_cache[2].active, "obs: the scorer was demoted")
    kernels.reset_counts()
    report["leg2"] = obs_overhead_leg(seed, users, eng, result)
    log("obs: leg 2 " + json.dumps(report["leg2"]))
    report["restart"] = obs_restart_leg(seed, users, items, U, eng, result,
                                        rel1, inst1)
    log("obs: leg 3 (restart) " + json.dumps(report["restart"]))
    in_process = kernels.counts()["shortlist"]
    report["b2_launches"] += in_process
    report["b2_launches_in_process"] = in_process
    Storage.reset()
    del model, result
    gc.collect()
    report["phase_s"] = time.perf_counter() - t_phase
    return report


# ---------------------------------------------------------------------------
# engines phase: the other three ALS engines
# ---------------------------------------------------------------------------

#: the width leg's cooccurrence: top-N per item (cfg_cooccurrence's n)
COOC_N = 20
#: items whose top lists are recounted exactly on the host
COOC_SAMPLES = 64
#: planted shared-user counts: a bf16 output rounds 257 to 256 and 5000
#: to 4992; the uniform synthetic data never reaches 256
PLANTED = (255, 256, 257, 300, 5000)
#: H100 SXM dense int8 tensor-core peak (NVIDIA data sheet, 700 W)
INT8_OPS = 1979e12


def _expected_top(row_counts: "np.ndarray", item: int, n: int):
    """The reference's top list of one count row: counts descending,
    equal counts by ascending id, zero counts dropped."""
    import numpy as np

    row = row_counts.astype(np.int64).copy()
    row[item] = 0
    order = np.lexsort((np.arange(len(row)), -row))[:n]
    return [(int(j), int(row[j])) for j in order if row[j] > 0]


def planted_incidence():
    """(users, items, n_users, n_items) where items 2p and 2p+1 share
    the first PLANTED[p] users, beside 6 noise items."""
    import numpy as np

    n_users = max(PLANTED) + 8
    rng = np.random.default_rng(7)
    u, i = [], []
    for p, c in enumerate(PLANTED):
        for it in (2 * p, 2 * p + 1):
            u.append(np.arange(c))
            i.append(np.full(c, it))
    n_items = 2 * len(PLANTED) + 6
    for it in range(2 * len(PLANTED), n_items):
        us = rng.choice(n_users, 700, replace=False)
        u.append(us)
        i.append(np.full(len(us), it))
    return (np.concatenate(u).astype(np.int32),
            np.concatenate(i).astype(np.int32), n_users, n_items)


def cooccurrence_width_leg(seed: int, users, items):
    """``train_cooccurrence`` on the ML-20M arrays' integer codes (n
    ``COOC_N``): the card path and never the host one, its split and
    bound, ``COOC_SAMPLES`` seeded items recounted exactly (int64
    bincount over each item's users, lowest-id ties), and a planted
    incidence with counts a bf16 output would round, exact through the
    same function on the card."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import cooccurrence as co

    c = ML20M
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    top = co.train_cooccurrence(users, items, c["n_users"], c["n_items"],
                                COOC_N, device=DEV, stats=stats)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check(stats.get("path") == "slabs"
          and str(stats.get("device", "")).startswith("cuda"),
          f"cooccurrence at the ML-20M shape took {stats.get('path')} on "
          f"{stats.get('device')}, not the card's slabbed product")

    du, di = co.distinct_pairs(users, items)      # sorted by (user, item)
    offs = np.searchsorted(du, np.arange(c["n_users"] + 1))
    rng = np.random.default_rng(seed + 64)
    sample = rng.choice(c["n_items"], COOC_SAMPLES, replace=False)
    t1 = time.perf_counter()
    for it in sample:
        us = du[di == it]
        row = np.bincount(np.concatenate([di[offs[u]:offs[u + 1]]
                                          for u in us]) if len(us) else
                          np.zeros(0, np.int64), minlength=c["n_items"])
        want = _expected_top(row, int(it), COOC_N)
        check(top.get(int(it), []) == want,
              f"cooccurrence row {it}: {top.get(int(it), [])[:5]} != "
              f"{want[:5]} (exact counts, lowest-id ties)")
    recount_s = time.perf_counter() - t1

    pu, pi, pn_u, pn_i = planted_incidence()
    pv, pidx = co.cooccurrence_topn_slabs(pu, pi, pn_u, pn_i, pn_i - 1,
                                          device=DEV)
    a = np.zeros((pn_u, pn_i), np.int64)
    a[pu, pi] = 1
    full = a.T @ a
    for it in range(pn_i):
        want = _expected_top(full[it], it, pn_i - 1)
        got = [(int(j), int(v)) for j, v in zip(pidx[it], pv[it]) if v > 0]
        check(got == want, f"planted row {it}: {got} != {want}")
    for p, cnt in enumerate(PLANTED):
        check(int(pv[2 * p][list(pidx[2 * p]).index(2 * p + 1)]) == cnt,
              f"planted pair {p}: count {cnt} not exact")

    nu_pad, ni_pad, slab = co.slab_geometry(c["n_users"], c["n_items"])
    ops = 2.0 * nu_pad * ni_pad * ni_pad
    bound_ops_ms = ops / INT8_OPS * 1e3
    bound_bytes_ms = (nu_pad * ni_pad + ni_pad * COOC_N * 12) \
        / HBM_BYTES_PER_S * 1e3
    report = dict(
        stats, wall_s=wall, peak_device_bytes=int(peak),
        recount_items=COOC_SAMPLES, recount_s=recount_s,
        items_with_lists=len(top), planted=list(PLANTED),
        bound_ms=max(bound_ops_ms, bound_bytes_ms),
        bound_by="operations" if bound_ops_ms >= bound_bytes_ms
        else "bytes",
        bound_note=f"2 * {nu_pad} * {ni_pad}^2 = {ops:.4g} int8 "
                   f"multiply-adds at {INT8_OPS:.4g} op/s (the int8 "
                   "tensor-core peak); A read once is "
                   f"{bound_bytes_ms:.4f} ms")
    log("engines: cooccurrence " + json.dumps(report))
    return report


#: the reference's judged e-commerce config (bench.py:741-760,
#: cfg_ecommerce): implicit ratings, r = 1 a view and r = 2 a buy
ECOMM = dict(n_users=2000, n_items=1500, nnz=200_000, seed=4, rank=10,
             iters=10, reg=0.01, categories=4, unavailable=10, known=20,
             new_users=8, new_views=8, buys=5, interval_s=0.5)
#: cfg_cooccurrence's ML-1M widths (bench.py:665-676) under the
#: similar-product engine's three algorithms, at a quarter of its events
#: (250,000 views, 25,000 likes and dislikes): writing the bench's 1.1M
#: events took 63 s, and with the fleet phase the whole smoke came within
#: 26 s of its time limit
SIMILAR = dict(n_users=6040, n_items=3706, nnz=250_000, seed=2,
               likes=25_000, like_seed=3, rank=10, iters=10, n=20,
               categories=4, queries=40, black=10, clients=8,
               shortlist=1024)
#: the deploy's scorer shortlist (engine.json ``scorer``). The reference
#: default, 512, demotes the als catalog at this shape to exact in both
#: packages (scan rank 8 of 10: probe recall 0.9875 on an NVIDIA H100
#: 80GB HBM3, 700 W, 0.9625 on the CPU for the CPU-trained factors;
#: tests/test_torch_engines.py); 1024 keeps both ALS scorers on B2. The
#: phase reports both gates on the stored factors.
#: recommended-user: the reference names no bench shape for it; this
#: one is the smoke's own (ML-1M's users following each other; 100,000
#: follows, cut from 200,000 for the time limit)
FOLLOW = dict(n_users=6040, nnz=100_000, seed=6, rank=10, iters=10,
              queries=20)
#: the width leg's batch sizes of similar-product queries
WIDTH_BATCHES = (1, 8, 64)
#: batches timed at each size (after one untimed)
WIDTH_REPS = 4
#: served answers against the recompute: scores within ENGINE_TOL *
#: max(1, |score|); ids equal, or swapped inside a run of scores within it
ENGINE_TOL = 1e-4
#: the port's package; the reference's is its name without the suffix
PORT_PACKAGE = "predictionio_tpu_torch"


def reference_factory(name: str) -> str:
    """The reference's engineFactory string of an engine, which the
    port's CLI maps to its own engine by name."""
    return "{}.engines.{}:engine".format(
        PORT_PACKAGE.removesuffix("_torch"), name)


def _new_app(name: str) -> int:
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.registry import Storage

    app_id = Storage.get_meta_data_apps().insert(App(id=0, name=name))
    Storage.get_events().init_channel(app_id)
    return app_id


#: event times of the engines phase: milliseconds after this epoch ms
BASE_MS = 1_704_067_200_000      # 2024-01-01T00:00:00Z


def _insert(app_id: int, rows) -> float:
    """Write ``(event, entity type, entity id, target type, target id,
    properties, ms after BASE_MS)`` rows with ``insert_batch``, in
    chunks; returns the seconds it took."""
    import datetime as dt

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.registry import Storage

    base = dt.datetime.fromtimestamp(BASE_MS / 1000, tz=dt.timezone.utc)
    store = Storage.get_events()
    t0 = time.perf_counter()
    for s in range(0, len(rows), 100_000):
        store.insert_batch([
            Event(event=e, entity_type=et, entity_id=eid,
                  target_entity_type=tt, target_entity_id=tid,
                  properties=p or {},
                  event_time=base + dt.timedelta(milliseconds=ms))
            for e, et, eid, tt, tid, p, ms in rows[s:s + 100_000]], app_id)
    return time.perf_counter() - t0


def _engine_train(name, env, variant, want_launches):
    """``train -v variant`` through the CLI; the B1 launches of the
    train's process, counted from zero, must be ``want_launches``."""
    t0 = time.perf_counter()
    line = json.loads(_cli(["train", "--variant", str(variant), "--device",
                            DEV], env, timeout=900)[-1])
    line["wall_s"] = time.perf_counter() - t0
    log(f"engines: {name} train " + json.dumps(line))
    check(line["launches"]["spd_solve"] == want_launches,
          f"{name}: train launched B1 {line['launches']['spd_solve']} "
          f"times, expected {want_launches}")
    return line


def _stored_models(instance_id: str):
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.workflow.serialization import (
        deserialize_models,
    )

    got = Storage.get_model_data_models().get(instance_id)
    check(got is not None, f"no model blob stored for {instance_id}")
    return deserialize_models(got.models, device=DEV)


def _same_answer(got, want, key: str, tag: str) -> float:
    """A served list against a recompute ``(vocab, scores, num)``, the
    scores -inf where an id is not a candidate: as many answers as
    candidates score above 0 (at most num), each a distinct candidate
    whose recomputed score is its served one, and the served scores the
    best ones in order, all within ENGINE_TOL * max(1, |score|): ids
    equal up to ties, the ties at the cut included. Returns the largest
    score error."""
    import numpy as np

    vocab, scores, num = want
    best = np.sort(scores[scores > 0])[::-1][:num].astype(np.float64)
    check(len(got) == len(best), f"{tag}: {len(got)} answers, "
          f"{len(best)} expected")
    if not len(best):
        return 0.0
    served = np.asarray([x["score"] for x in got], np.float64)
    idx = _index(vocab, [x[key] for x in got])
    check(len(idx) == len(got) and len(set(idx.tolist())) == len(got),
          f"{tag}: unknown or repeated ids {[x[key] for x in got]}")
    own = scores[idx].astype(np.float64)
    tol = ENGINE_TOL * np.maximum(1.0, np.abs(best))
    err = np.maximum(np.abs(served - best), np.abs(served - own))
    check(bool(np.isfinite(own).all() and (err <= tol).all()),
          f"{tag}: served {[(x[key], x['score']) for x in got][:5]}, "
          f"best {best[:5].tolist()}")
    return float(err.max())


def _index(vocab, ids):
    from predictionio_tpu_torch.data.bimap import batch_lookup

    idx = batch_lookup(vocab, list(ids))
    return idx[idx >= 0]


def ecomm_recompute(m, q: dict, seen, recent, unavailable, unseen_only):
    """E-commerce's answer from a stored model, in numpy: the candidate
    rules (white list, black list = query's + unavailable + seen when
    ``unseen_only``, categories), then the known user's factors, else
    similarity to the recent views, else popularity; score > 0."""
    import numpy as np

    n = len(m.item_vocab)
    ok = np.ones(n, bool)
    if q.get("whiteList") is not None:
        ok[:] = False
        ok[_index(m.item_vocab, q["whiteList"])] = True
    black = set(unavailable) | set(q.get("blackList") or ())
    if unseen_only:
        black |= seen(q["user"])
    ok[_index(m.item_vocab, black)] = False
    if q.get("categories"):
        wanted = set(q["categories"])
        for j in range(n):
            item = m.items.get(j)
            if not (item and set(item.categories or ()) & wanted):
                ok[j] = False
    ui = m.user_index(q["user"])
    if ui is not None:
        scores = m.V @ m.U[ui]
    else:
        rec = _index(m.item_vocab, recent(q["user"]))
        if len(rec):
            Vn = m.V_normalized
            scores = Vn @ Vn[rec].sum(axis=0)
            ok[rec] = False
        else:
            scores = np.zeros(n)
            for j, c in m.popular_count.items():
                scores[j] = c
    return m.item_vocab, np.where(ok, scores, -np.inf), q["num"]


def ecommerce_leg(seed: int, port: int, work):
    """E-commerce at cfg_ecommerce's shape through the CLI: train,
    deploy, the query paths against a numpy recompute; then a second
    variant with unseenOnly deployed with fold-in, new users and buys
    folded in."""
    import numpy as np

    from predictionio_tpu_torch.deploy.foldin import (
        read_entities_ratings, upsert_factor_rows,
    )
    from predictionio_tpu_torch.engines.ecommerce import (
        ECommAlgorithm, ECommAlgorithmParams,
    )

    c = ECOMM
    env = smoke_store(work)
    app_id = _new_app("EcommApp")
    users, items, ratings = synthetic_ratings(
        c["n_users"], c["n_items"], c["nnz"], seed=c["seed"],
        implicit=True)
    rng = np.random.default_rng(seed + 40)
    unavailable = [f"i{j}" for j in rng.choice(c["n_items"],
                                               c["unavailable"],
                                               replace=False)]
    rows = [("$set", "user", f"u{u}", None, None, {"age": int(u % 60)}, 0)
            for u in range(c["n_users"])]
    rows += [("$set", "item", f"i{i}", None, None,
              {"categories": [f"c{i % c['categories']}"]}, 0)
             for i in range(c["n_items"])]
    rows.append(("$set", "constraint", "unavailableItems", None, None,
                 {"items": unavailable}, 0))
    kinds = np.where(ratings == 2.0, "buy", "view")
    rows += [(str(k), "user", f"u{u}", "item", f"i{i}", None, 1 + j)
             for j, (k, u, i) in enumerate(zip(kinds.tolist(),
                                               users.tolist(),
                                               items.tolist()))]
    insert_s = _insert(app_id, rows)
    seen = {}
    for u, i in zip(users.tolist(), items.tolist()):
        seen.setdefault(f"u{u}", set()).add(f"i{i}")
    recent = {}
    t_end = 1 + len(users)
    # after training: an unknown user with recent views
    newbie = [f"i{j}" for j in rng.choice(c["n_items"], 6, replace=False)]

    def variant(vid, unseen_only):
        path = work / f"{vid}.json"
        path.write_text(json.dumps({
            "id": vid, "engineFactory": reference_factory("ecommerce"),
            "datasource": {"params": {"appName": "EcommApp"}},
            "algorithms": [{"name": "ecomm", "params": {
                "appName": "EcommApp", "unseenOnly": unseen_only,
                "rank": c["rank"], "numIterations": c["iters"],
                "lambda": c["reg"]}}]}))
        return path

    want = 2 * c["iters"]
    v_plain = variant("ecomm", False)
    t_plain = _engine_train("ecommerce", env, v_plain, want)
    m = _stored_models(t_plain["instance"])[0]
    _insert(app_id, [("view", "user", "newbie", "item", it, None,
                      t_end + j) for j, it in enumerate(newbie)])
    recent["newbie"] = set(newbie)
    seen["newbie"] = set(newbie)
    picks = [str(m.user_vocab[j]) for j in rng.choice(
        len(m.user_vocab), c["known"], replace=False)]
    queries = [{"user": u, "num": 10} for u in picks[:10]]
    queries += [
        {"user": picks[10], "num": 10, "categories": ["c1"]},
        {"user": picks[11], "num": 10, "whiteList": [
            f"i{j}" for j in rng.choice(c["n_items"], 50, replace=False)]},
        {"user": picks[12], "num": 10, "blackList": [
            f"i{j}" for j in rng.choice(c["n_items"], 20, replace=False)]},
        {"user": "newbie", "num": 10},
        {"user": "ghost", "num": 10},
        {"user": "ghost", "num": 10, "categories": ["c2", "c3"]}]

    def ask(qc, q, model, unseen_only, tag):
        status, body, dt = qc.call("POST", "/queries.json", q)
        check(status == 200, f"{tag}: {q} answered {status} {body}")
        want_q = ecomm_recompute(
            model, q, lambda u: seen.get(u, set()),
            lambda u: recent.get(u, set()), unavailable, unseen_only)
        check(bool((want_q[1] > 0).any()), f"{tag}: empty recompute for "
              f"{q}")
        return _same_answer(body["itemScores"], want_q, "item",
                            f"{tag} {q['user']}"), dt * 1e3

    server = None
    try:
        server = Server(["deploy", "--variant", str(v_plain), "--port",
                         str(port), "--device", DEV], env, tag="engines")
        qc = Client(server.wait_ready(timeout_s=300))
        errs, lat = zip(*(ask(qc, q, m, False, "ecommerce")
                          for q in queries))
        status, _, _ = qc.call("POST", "/stop")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the e-commerce server did not stop")

        # unseenOnly, and fold-in on the same deploy
        v_unseen = variant("ecomm-unseen", True)
        t_unseen = _engine_train("ecommerce unseenOnly", env, v_unseen,
                                 want)
        m2 = _stored_models(t_unseen["instance"])[0]
        fenv = dict(env, PIO_FOLDIN="1",
                    PIO_FOLDIN_APPLY_INTERVAL_S=str(c["interval_s"]))
        server = Server(["deploy", "--variant", str(v_unseen), "--port",
                         str(port), "--device", DEV], fenv, tag="engines")
        qc = Client(server.wait_ready(timeout_s=300))
        errs2, lat2 = zip(*(ask(qc, q, m2, True, "ecommerce unseenOnly")
                            for q in queries[:10]))
        bought = next(f"i{j}" for j in rng.permutation(c["n_items"])
                      if f"i{j}" not in unavailable)
        pop_q = {"user": "ghost", "num": 1, "whiteList": [bought]}
        _, before, _ = qc.call("POST", "/queries.json", pop_q)
        pop0 = m2.popular_count.get(m2.item_index(bought), 0)
        check([x["score"] for x in before["itemScores"]]
              == ([float(pop0)] if pop0 else []),
              f"popularity of {bought} served {before}, stored {pop0}")
        new_users = [f"fu{j}" for j in range(c["new_users"])]
        fold = []
        # event times past the controller's watermark (its start)
        t = int(time.time() * 1000) - BASE_MS
        for u in new_users:
            for it in rng.choice(c["n_items"], c["new_views"],
                                 replace=False):
                fold.append(("view", "user", u, "item", f"i{it}", None, t))
                seen.setdefault(u, set()).add(f"i{it}")
                t += 1
        for u in new_users[:c["buys"]]:
            fold.append(("buy", "user", u, "item", bought, None, t))
            seen[u].add(bought)
            t += 1
        _insert(app_id, fold)
        st = _wait_quiet(qc, 2, "the e-commerce fold-in")
        _, root, _ = qc.call("GET", "/")
        algo = ECommAlgorithm(ECommAlgorithmParams(
            app_name="EcommApp", rank=c["rank"], reg=c["reg"]))
        spec = algo.foldin_spec(m2, None)
        hist = read_entities_ratings(spec, new_users)
        rows_f = _plain_solve(lambda: _fold_rows(spec, m2.V, m2.item_vocab,
                                                 hist))
        check(sorted(rows_f) == new_users, f"recompute folded "
              f"{sorted(rows_f)}")
        uv, U = upsert_factor_rows(m2.user_vocab, m2.U, rows_f)
        folded = dataclasses.replace(m2, user_vocab=uv, U=U)
        errs3, _ = zip(*(ask(qc, {"user": u, "num": 10}, folded, True,
                             "ecommerce folded") for u in new_users))
        _, after, _ = qc.call("POST", "/queries.json", pop_q)
        check([x["score"] for x in after["itemScores"]]
              == [float(pop0 + c["buys"])],
              f"popularity of {bought} after the fold: {after}, "
              f"expected {pop0 + c['buys']}")
        b1 = root["kernelLaunches"]["spd_solve"]
        check(st["applies"] >= 1 and b1 == st["solveCalls"] >= 1,
              f"fold-in: {st['applies']} applies, B1 {b1} launches for "
              f"{st['solveCalls']} solves")
        for a in st["recentApplies"]:
            check(all(s["solve_event_ms"] is not None
                      for s in a["solves"]), "an apply did not solve on "
                  "the card")
        status, _, _ = qc.call("POST", "/stop")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the e-commerce fold-in server did not stop")
        server = None
        report = {
            "events": len(rows), "insert_s": insert_s,
            "train": t_plain, "train_unseen": t_unseen,
            "queries": len(queries) + 10 + len(new_users) + 2,
            "query_p50_ms": float(np.median(lat + lat2)),
            "max_score_abs_err": max(errs + errs2 + errs3),
            "foldin": {"applies": st["applies"],
                       "solve_calls": st["solveCalls"], "b1_launches": b1,
                       "user_rows": st["appliedUserRows"],
                       "popularity": [pop0, pop0 + c["buys"]],
                       "apply_s": [a["apply_s"] for a in
                                   st["recentApplies"]]}}
        log("engines: ecommerce " + json.dumps(report))
        return report
    finally:
        if server is not None:
            server.stop()


def similar_recompute(m, q: dict):
    """The first algorithm's exact lane on a stored similarity model:
    summed cosine to the query items, each id through the lane's own
    candidate rule (``_candidate_ok``, which ``_score_and_filter``
    applies)."""
    import numpy as np

    from predictionio_tpu_torch.engines.similarproduct import (
        Query, _candidate_ok, _index_set,
    )

    query = Query(items=tuple(q["items"]), num=q["num"],
                  categories=q.get("categories"),
                  white_list=q.get("whiteList"),
                  black_list=q.get("blackList"))
    qi = _index_set(m, query.items)
    scores = np.full(len(m.item_vocab), -np.inf, np.float32)
    if qi:
        white = (_index_set(m, query.white_list)
                 if query.white_list is not None else None)
        black = _index_set(m, query.black_list or ())
        ok = np.fromiter((_candidate_ok(j, m.items, qi, query, white, black)
                          for j in range(len(scores))), bool,
                         count=len(scores))
        scores = np.where(ok, m.V @ m.V[sorted(qi)].sum(axis=0), -np.inf)
    return m.item_vocab, scores, query.num


def similar_leg(seed: int, port: int, work):
    """Similar-product at cfg_cooccurrence's ML-1M shape through the
    CLI: als, likealgo and cooccurrence in one engine; deployed under
    twostage; concurrent plain queries (the fused lane, B2) and the
    exact lane's filters, against the first algorithm's exact recompute;
    B2's launches against the fused batches."""
    import numpy as np

    from predictionio_tpu_torch.ops.scoring import build_scorer
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    c = SIMILAR
    env = smoke_store(work)
    app_id = _new_app("SimilarApp")
    users, items, _ = synthetic_ratings(c["n_users"], c["n_items"],
                                        c["nnz"], seed=c["seed"])
    lu, li, lr = synthetic_ratings(c["n_users"], c["n_items"], c["likes"],
                                   seed=c["like_seed"])
    rows = [("$set", "item", f"i{i}", None, None,
             {"categories": [f"c{i % c['categories']}"]}, 0)
            for i in range(c["n_items"])]
    rows += [("view", "user", f"u{u}", "item", f"i{i}", None, 1 + j)
             for j, (u, i) in enumerate(zip(users.tolist(), items.tolist()))]
    rows += [("like" if r >= 3 else "dislike", "user", f"u{u}", "item",
              f"i{i}", None, 1 + j)
             for j, (u, i, r) in enumerate(zip(lu.tolist(), li.tolist(),
                                                lr.tolist()))]
    insert_s = _insert(app_id, rows)
    variant = work / "similar.json"
    variant.write_text(json.dumps({
        "id": "similar", "engineFactory": reference_factory("similarproduct"),
        "datasource": {"params": {"appName": "SimilarApp"}},
        "algorithms": [
            {"name": "als", "params": {"rank": c["rank"],
                                       "numIterations": c["iters"]}},
            {"name": "likealgo", "params": {"rank": c["rank"],
                                            "numIterations": c["iters"]}},
            {"name": "cooccurrence", "params": {"n": c["n"]}}],
        "scorer": {"shortlist": c["shortlist"]}}))
    trained = _engine_train("similarproduct", env, variant,
                            2 * 2 * c["iters"])
    models = _stored_models(trained["instance"])
    m = models[0]
    gates = {}
    for name, mm in (("als", models[0]), ("likealgo", models[1])):
        for sl in (ScorerConfig().shortlist, c["shortlist"]):
            sc = build_scorer(mm.V, ScorerConfig(mode="twostage",
                                                 shortlist=sl), device=DEV)
            gates[f"{name}/{sl}"] = {"activeMode": sc.active_mode,
                                     "recallProbe": sc.recall_probe,
                                     "scanRank": sc.scan_rank}
            del sc
    log("engines: similarproduct gates " + json.dumps(gates))
    rng = np.random.default_rng(seed + 50)
    queries = []
    for q in range(c["queries"]):
        body = {"items": [f"i{j}" for j in rng.choice(
            c["n_items"], 1 + q % 3, replace=False)], "num": 10}
        if q < c["black"]:
            body["blackList"] = [f"i{j}" for j in rng.choice(
                c["n_items"], 10, replace=False)]
        queries.append(body)
    exact_lane = [
        {"items": ["i1", "i2"], "num": 10, "categories": ["c1"]},
        {"items": ["i3"], "num": 10, "whiteList": [
            f"i{j}" for j in rng.choice(c["n_items"], 60, replace=False)]}]
    server = None
    try:
        senv = dict(env, PIO_SCORER_MODE="twostage")
        server = Server(["deploy", "--variant", str(variant), "--port",
                         str(port), "--device", DEV], senv, tag="engines")
        q_port = server.wait_ready(timeout_s=300)
        answers = [None] * len(queries)

        def client(k):
            cl = Client(q_port)
            for j in range(k, len(queries), c["clients"]):
                answers[j] = cl.call("POST", "/queries.json", queries[j])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(c["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        qc = Client(q_port)
        _, mid, _ = qc.call("GET", "/")
        errs = []
        for q, got in zip(queries + exact_lane, answers + [
                qc.call("POST", "/queries.json", q) for q in exact_lane]):
            check(got is not None and got[0] == 200, f"similar {q}: {got}")
            errs.append(_same_answer(got[1]["itemScores"],
                                     similar_recompute(m, q), "item",
                                     f"similarproduct {q['items']}"))
        _, root, _ = qc.call("GET", "/")
        fused = mid["microBatches"]["batches"]
        b2 = root["kernelLaunches"]["shortlist"]
        scorers = root["scorer"]
        check(len(scorers) == 2 and all(s["activeMode"] == "twostage"
                                        for s in scorers),
              f"similar-product scorers: {scorers}")
        check(root["microBatches"]["batches"] == fused + len(exact_lane),
              f"micro-batches {root['microBatches']}, {fused} before the "
              f"exact lane's {len(exact_lane)}")
        check(b2 == 2 * fused, f"B2 launched {b2} times for {fused} fused "
              "batches of two ALS algorithms")
        status, _, _ = qc.call("POST", "/stop")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the similar-product server did not stop")
        server = None
        report = {"events": len(rows), "insert_s": insert_s,
                  "train": trained, "queries": len(queries),
                  "gates": gates,
                  "exact_lane_queries": len(exact_lane),
                  "micro_batches": mid["microBatches"],
                  "b2_launches": b2,
                  "scorer": [{k: s[k] for k in (
                      "activeMode", "scanRank", "tileItems", "tiles",
                      "shortlist", "recallProbe", "buildSeconds")}
                      for s in scorers],
                  "max_score_abs_err": max(errs)}
        log("engines: similarproduct " + json.dumps(report))
        return report
    finally:
        if server is not None:
            server.stop()


def follow_recompute(m, q: dict):
    """Recommended-user's answer from a stored model, in numpy: summed
    cosine to the query users, score > 0, the query users, black list
    and white list applied."""
    import numpy as np

    qi = _index(m.user_vocab, q["users"])
    if not len(qi):
        return m.user_vocab, np.full(len(m.user_vocab), -np.inf), q["num"]
    ok = np.ones(len(m.user_vocab), bool)
    ok[qi] = False
    ok[_index(m.user_vocab, q.get("blackList") or ())] = False
    if q.get("whiteList") is not None:
        white = np.zeros_like(ok)
        white[_index(m.user_vocab, q["whiteList"])] = True
        ok &= white
    scores = m.V @ m.V[np.sort(qi)].sum(axis=0)
    return m.user_vocab, np.where(ok, scores, -np.inf), q["num"]


def follow_leg(seed: int, port: int, work):
    """Recommended-user through the CLI at the smoke's own shape."""
    import numpy as np

    c = FOLLOW
    env = smoke_store(work)
    app_id = _new_app("FollowApp")
    a, b, _ = synthetic_ratings(c["n_users"], c["n_users"], c["nnz"],
                                seed=c["seed"])
    keep = a != b                               # no self-follows
    rows = [("$set", "user", f"u{u}", None, None, {"n": int(u)}, 0)
            for u in range(c["n_users"])]
    rows += [("follow", "user", f"u{x}", "user", f"u{y}", None, 1 + j)
             for j, (x, y) in enumerate(zip(a[keep].tolist(),
                                            b[keep].tolist()))]
    insert_s = _insert(app_id, rows)
    variant = work / "follow.json"
    variant.write_text(json.dumps({
        "id": "follow", "engineFactory":
            reference_factory("recommended_user"),
        "datasource": {"params": {"appName": "FollowApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": c["rank"], "numIterations": c["iters"]}}]}))
    trained = _engine_train("recommended_user", env, variant,
                            2 * c["iters"])
    m = _stored_models(trained["instance"])[0]
    rng = np.random.default_rng(seed + 60)
    server = None
    try:
        server = Server(["deploy", "--variant", str(variant), "--port",
                         str(port), "--device", DEV], env, tag="engines")
        qc = Client(server.wait_ready(timeout_s=300))
        errs = []
        for q in range(c["queries"]):
            body = {"users": [f"u{j}" for j in rng.choice(
                c["n_users"], 1 + q % 3, replace=False)], "num": 10}
            if q % 4 == 1:
                body["whiteList"] = [f"u{j}" for j in rng.choice(
                    c["n_users"], 200, replace=False)]
            if q % 4 == 2:
                body["blackList"] = [f"u{j}" for j in rng.choice(
                    c["n_users"], 20, replace=False)]
            status, got, _ = qc.call("POST", "/queries.json", body)
            check(status == 200, f"recommended-user {body}: {status}")
            want = follow_recompute(m, body)
            check(bool((want[1] > 0).any()), f"recommended-user: empty "
                  f"recompute for {body['users']}")
            errs.append(_same_answer(got["similarUserScores"], want, "user",
                                     f"recommended_user {body['users']}"))
        status, _, _ = qc.call("POST", "/stop")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "the recommended-user server did not stop")
        server = None
        report = {"events": len(rows), "insert_s": insert_s,
                  "train": trained, "queries": c["queries"],
                  "max_score_abs_err": max(errs)}
        log("engines: recommended_user " + json.dumps(report))
        return report
    finally:
        if server is not None:
            server.stop()


#: the legs that run each in a process of its own (``leg_worker``),
#: beside this process's work: the batchpredict and evlog phases' legs 1
#: (no kernel) during the build; the lifecycle, the engines phase's three
#: CLI legs, the fleet phase's orchestrated cycle and the evlog phase's
#: leg 2 while this process trains.
#: Each has its own store and its own port (``--port`` plus its index
#: here, or 0); they share only the card.
BACKGROUND_LEGS = {
    "lifecycle": lambda seed, port, work: lifecycle_phase(seed, port),
    "ecommerce": ecommerce_leg, "similarproduct": similar_leg,
    "recommended_user": follow_leg,
    "orchestrate": lambda seed, port, work: fleet_orchestrate_leg(seed),
    "bp_bench": lambda seed, port, work: bp_bench_leg(),
    "sessionrec": lambda seed, port, work: sessionrec_cli_leg(seed, port,
                                                              work),
    "loadtest": lambda seed, port, work: loadtest_phase(seed, port, work),
    "distributed": lambda seed, port, work: distributed_legs(seed, port,
                                                             work),
    "evlog_codec": lambda seed, port, work: evlog_codec_leg(seed),
    "evlog": lambda seed, port, work: evlog_leg(seed, port, work),
    "check": lambda seed, port, work: check_leg()}
#: the shapes a background leg reads, passed on in ``CHIP_SMOKE_LEGS``
LEG_SHAPES = ("ECOMM", "SIMILAR", "FOLLOW", "ML100K", "FLEET_ORCH",
              "EVAL_CLI", "BP_CLI", "BP_BENCH", "FOLDIN", "FEEDBACK",
              "SESSIONREC_CLI", "LT_CURVE", "LT_STORM", "ML20M", "DIST",
              "OPERATOR", "EVLOG_CODEC", "EVLOG")


def leg_worker() -> int:
    """One background leg in a process of its own (``python3 -c "import
    chip_smoke; chip_smoke.leg_worker()" NAME SEED PORT``), on the
    parent's device and shapes (``CHIP_SMOKE_LEGS``): the leg's store is
    configured in this process only, and the leg's report, with its
    wall seconds, is the last line."""
    global DEV
    sys.path.insert(0, str(ROOT))
    from predictionio_tpu_torch.storage.registry import Storage

    name, seed, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    parent = json.loads(os.environ["CHIP_SMOKE_LEGS"])
    DEV = parent.pop("device")
    for key, shape in parent.items():
        globals()[key].update(shape)
    t0 = time.perf_counter()
    try:
        report = BACKGROUND_LEGS[name](seed, port, WORK / "legs" / name)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        Storage.reset()
    report["leg_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


def start_legs(names, seed: int, port: int) -> dict:
    """Start the named background legs, each in a process of its own
    with a ``PIO_HOME`` of its own (a server's telemetry store takes one
    writer); their output goes to files until ``finish_legs``."""
    logs = WORK / "legs_logs"
    logs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CHIP_SMOKE_LEGS=json.dumps(
        dict({k: globals()[k] for k in LEG_SHAPES + DIST_SHAPES},
             device=DEV)))
    procs = {}
    try:
        for name in names:
            k = list(BACKGROUND_LEGS).index(name)
            env["PIO_HOME"] = str(WORK / "legs_home" / name)
            # pio: ignore[PIO002]: a worker's stdout log in scratch
            fo = open(logs / f"{name}.out", "w")
            # pio: ignore[PIO002]: a worker's stderr log in scratch
            fe = open(logs / f"{name}.err", "w")
            with fo, fe:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     "sys.exit(chip_smoke.leg_worker())", name, str(seed),
                     str(port + k if port else 0)],
                    cwd=str(ROOT), stdout=fo, stderr=fe,
                    start_new_session=True, env=env)
    except BaseException:
        stop_legs(procs)
        raise
    return procs


def stop_legs(procs: dict) -> None:
    """Kill what is left of these background legs (a leg's servers go
    with it) and remove their stores and logs."""
    for name, proc in procs.items():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(WORK / "legs" / name, ignore_errors=True)
        shutil.rmtree(WORK / "legs_home" / name, ignore_errors=True)
        for ext in ("out", "err"):
            (WORK / "legs_logs" / f"{name}.{ext}").unlink(missing_ok=True)


def finish_legs(procs: dict) -> dict:
    """Wait for these background legs; their output relayed in leg order
    and their reports by name."""
    logs = WORK / "legs_logs"
    out = {}
    try:
        deadline = time.monotonic() + 900
        for name, proc in procs.items():
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                check(False, f"legs: the {name} leg ran past 900 s")
        for name, proc in procs.items():
            lines = (logs / f"{name}.out").read_text().splitlines()
            err = (logs / f"{name}.err").read_text()
            # a leg that failed printed no report: relay every line
            for line in (lines[:-1] if proc.returncode == 0 else lines):
                log(line)
            if err:
                sys.stderr.write(err[-20000:])
            check(proc.returncode == 0 and lines, f"legs: the {name} "
                  f"leg exited {proc.returncode}: {err[-2000:]}")
            out[name] = json.loads(lines[-1])
    finally:
        stop_legs(procs)
    return out


def similar_width_leg(seed: int, data):
    """Similar-product serving at the ML-20M width, in process: implicit
    ALS on the train phase's data (20 B1 launches), V row-normalized as
    a ``SimilarityModel`` over 27,000 ids, ``ALSAlgorithm.batch_predict``
    under twostage at each batch size (B2 at T = 16384, two tiles), every
    answer the exact lane's, one B2 launch a batch."""
    import numpy as np

    from predictionio_tpu_torch.engines.similarproduct import (
        ALSAlgorithm, Query, SimilarityModel, _index_set,
    )
    from predictionio_tpu_torch.models.als import ALSParams, train_als
    from predictionio_tpu_torch.ops import kernels, scoring
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    c = ML20M
    kernels.reset_counts()
    t0 = time.perf_counter()
    _, V = train_als(data, ALSParams(
        rank=c["rank"], num_iterations=SIMILAR["iters"], reg=c["reg"],
        alpha=1.0, implicit_prefs=True, chunk_size=c["chunk"]), device=DEV)
    train_s = time.perf_counter() - t0
    b1 = kernels.counts()["spd_solve"]
    check(b1 == 2 * SIMILAR["iters"], f"width ALS launched B1 {b1} times")
    norms = np.linalg.norm(V, axis=1, keepdims=True)
    V = (V / np.where(norms == 0, 1.0, norms)).astype(np.float32)
    model = SimilarityModel(item_vocab=item_ids(c["n_items"]), V=V,
                            items={}, device=DEV)
    model._scorer_cfg_override = ScorerConfig(mode="twostage")
    t0 = time.perf_counter()
    scorer = scoring.scorer_for(model, model.V)
    build_s = time.perf_counter() - t0
    check(scorer is not None and scorer.active,
          "the width scorer was gated to exact")
    algo = ALSAlgorithm()
    rng = np.random.default_rng(seed + 70)
    rows, max_err, batches = [], 0.0, 0
    kernels.reset_counts()
    for b in WIDTH_BATCHES:
        ms = []
        for rep in range(WIDTH_REPS + 1):
            qs = []
            for j in range(b):
                kw = {}
                if j % 4 == 3:
                    kw["black_list"] = tuple(str(model.item_vocab[x]) for x
                                             in rng.choice(c["n_items"], 10))
                qs.append((j, Query(items=tuple(
                    str(model.item_vocab[x]) for x in rng.choice(
                        c["n_items"], 1 + j % 3, replace=False)),
                    num=10, **kw)))
            t0 = time.perf_counter()
            got = algo.batch_predict(model, qs)
            dt_ms = (time.perf_counter() - t0) * 1e3
            batches += 1
            if rep:
                ms.append(dt_ms)
            for (_, q), (_, res) in zip(qs, got):
                # the exact lane's candidates: no query item, no black
                qi = sorted(_index_set(model, q.items))
                scores = model.V @ model.V[qi].sum(axis=0)
                scores[qi + sorted(_index_set(model, q.black_list
                                              or ()))] = -np.inf
                max_err = max(max_err, _same_answer(
                    res.to_dict()["itemScores"],
                    (model.item_vocab, scores, q.num), "item",
                    f"width B={b}"))
        rows.append({"B": b, "batches": WIDTH_REPS,
                     "batch_ms": ms, "batch_ms_median": float(np.median(ms))})
    launches = kernels.counts()["shortlist"]
    check(launches == batches, f"width: B2 launched {launches} times for "
          f"{batches} batches")
    st = scorer.status()
    report = {"train_s": train_s, "b1_launches": b1,
              "scorer_build_s": build_s, "b2_launches": launches,
              "batches": batches, "rows": rows,
              "max_score_abs_err": max_err,
              "scorer": {k: st[k] for k in (
                  "activeMode", "scanRank", "tileItems", "tiles",
                  "shortlist", "recallProbe")},
              "c": scoring.twostage_cand(scorer.cand_per_tile,
                                         scorer.n_tiles, scorer.tile, 10,
                                         False)}
    log("engines: similar width " + json.dumps(report))
    del model, scorer
    return report


def engines_width_leg(seed: int, held):
    """Leg 2 of the engines phase, on the train phase's ML-20M arrays
    and data (regenerated from the seed if not held)."""
    if held is None:
        import torch

        from predictionio_tpu_torch.models.als import ALSData
        from predictionio_tpu_torch.parallel.mesh import make_mesh

        c = ML20M
        users, items, ratings = synthetic_ratings(
            c["n_users"], c["n_items"], c["nnz"], seed=c["seed"])
        held = {"users": users, "items": items,
                "data": ALSData.build(users, items, ratings, c["n_users"],
                                      c["n_items"]).put(
                    make_mesh(devices=[torch.device(DEV)]))}
    t0 = time.perf_counter()
    cooc = cooccurrence_width_leg(seed, held["users"], held["items"])
    cooc["leg_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    width = similar_width_leg(seed, held["data"])
    width["leg_s"] = time.perf_counter() - t0
    return {"cooccurrence": cooc, "similar_width": width}


#: B2 at the engines' shapes: (n_items, T, c) of similar-product's
#: catalogs (tile 16384 rounded to the catalog, the shortlist spread
#: over the tiles: 512, the default, and the ML-1M deploy's 1024), at
#: the scan ranks rank 10 gives (8 or 10)
ENGINE_B2_SHAPES = [(3706, 4096, 512), (3706, 4096, 1024),
                    (27_000, 16_384, 256)]
ENGINE_B2_RANKS = (8, 10)


def kernels_engine_shapes(seed: int):
    """B2 held against its plain version at the engines' shapes, B in
    {1, 8, 64}, masked and unmasked: each row's ms, plain ms, library
    composite ms and bound, as ``kernels_phase`` does it."""
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import (
        shortlist_topc, shortlist_topc_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rows, max_err = [], 0.0
    for n_items, t, cand in ENGINE_B2_SHAPES:
        nt = -(-n_items // t)
        for r in ENGINE_B2_RANKS:
            tiles = torch.randint(-127, 128, (nt, t, r), generator=g,
                                  device=dev, dtype=torch.int8)
            scales = (0.5 + torch.rand((nt, t), generator=g,
                                       device=dev)) / 127.0
            deq = (tiles.float() * scales[..., None]).reshape(nt * t, r)
            for b in (1, 8, 64):
                u = torch.randn((b, r), generator=g, device=dev)
                mask_all = torch.rand((b, nt * t), generator=g,
                                      device=dev) < 0.3
                for masked in (False, True):
                    mask = mask_all if masked else None
                    kernels.reset_counts()
                    got = shortlist_topc(u, tiles, scales, n_items, mask,
                                         cand)
                    torch.cuda.synchronize()
                    check(kernels.SHORTLIST_LAUNCHES == 1,
                          "shortlist wrapper did not launch its kernel")
                    wide = shortlist_topc_reference(u, tiles, scales,
                                                    n_items, mask, cand + 1)
                    err, problems = compare_shortlist(
                        got, (wide[0].reshape(b, nt, cand + 1),
                              wide[1].reshape(b, nt, cand + 1)), cand)
                    check(not problems, f"shortlist R={r} T={t} B={b} "
                          f"c={cand} masked={masked}: {'; '.join(problems)}")
                    max_err = max(max_err, err)
                    ms = cuda_ms(lambda: shortlist_topc(
                        u, tiles, scales, n_items, mask, cand), iters=10)
                    plain_ms = cuda_ms(lambda: shortlist_topc_reference(
                        u, tiles, scales, n_items, mask, cand), iters=2)

                    def library():
                        sc = torch.matmul(u, deq.T)
                        sc[:, n_items:] = float("-inf")
                        if mask is not None:
                            sc = sc.masked_fill(mask, float("-inf"))
                        return torch.topk(sc.view(b, nt, t), cand, dim=2)

                    library_ms = cuda_ms(library, iters=3)
                    device_ms = graph_ms(lambda: shortlist_topc(
                        u, tiles, scales, n_items, mask, cand), launches=20)
                    plan = kernels.shortlist_plan(b, nt, t, r, cand, masked)
                    bound, bound_by = shortlist_bound_ms(
                        b, n_items, r, cand, nt, masked, plan.tensor_cores)
                    row = {"n_items": n_items, "T": t, "R": r, "B": b,
                           "c": cand, "masked": masked, "ms": ms,
                           "device_ms": device_ms,
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": bound, "bound_by": bound_by,
                           "max_abs_err": err,
                           "plan": plan.as_dict()}
                    rows.append(row)
                    log("kernels: shortlist engines " + json.dumps(row))
            del tiles, scales, deq
    torch.cuda.empty_cache()
    kernels.reset_counts()
    return rows, max_err


#: tie-heavy B2 rows: (n_items, T, R, B, c). Entries in [-2, 2], query
#: rows in [-3, 3] and one scale of 1/128, so every score is a small
#: multiple of 1/128, exact in f32 in any order, and a tile holds only a
#: few dozen distinct values: the kernel must return each tile's top c in
#: the stable order (value desc, id asc), values and ids exactly. One row
#: keeps every score (c 1024, the similar-product deploy's shape), one
#: the queues (c 16, the masked serve queries' c), one the tensor-core
#: product (R 32, 8 rows, c 4).
TIE_B2_SHAPES = [(3706, 4096, 8, 8, 1024), (40_000, 16_384, 32, 8, 16),
                 (40_000, 16_384, 32, 8, 4)]


def kernels_tie_rows(seed: int):
    """B2 on tie-heavy inputs, held exactly to a stable sort of the same
    scores (``torch.sort(stable=True)`` per tile); each row's ms,
    device ms and plan."""
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import shortlist_topc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = []
    for n_items, t, r, b, cand in TIE_B2_SHAPES:
        nt = -(-n_items // t)
        tiles = torch.randint(-2, 3, (nt, t, r), generator=g, device=dev,
                              dtype=torch.int8)
        scales = torch.full((nt, t), 1 / 128, device=dev)
        u = torch.randint(-3, 4, (b, r), generator=g, device=dev).float()
        kernels.reset_counts()
        got_v, got_i = shortlist_topc(u, tiles, scales, n_items, None, cand)
        torch.cuda.synchronize()
        check(kernels.SHORTLIST_LAUNCHES == 1,
              "shortlist wrapper did not launch its kernel")
        sc = (u @ tiles.reshape(nt * t, r).float().T) / 128
        sc[:, n_items:] = float("-inf")
        sv, si = torch.sort(sc.view(b, nt, t), dim=2, descending=True,
                            stable=True)
        want_v = sv[..., :cand].reshape(b, nt * cand)
        want_i = (si[..., :cand] + torch.arange(
            nt, device=dev)[None, :, None] * t).reshape(b, nt * cand)
        fin = torch.isfinite(want_v)
        distinct = int(torch.unique(sc[torch.isfinite(sc)]).numel())
        check(torch.equal(fin, torch.isfinite(got_v)),
              f"tie row T={t} c={cand}: finite pattern differs")
        check(torch.equal(got_v[fin], want_v[fin]),
              f"tie row T={t} c={cand}: values differ from the stable order")
        bad = int((got_i[fin] != want_i[fin].int()).sum())
        check(bad == 0, f"tie row T={t} c={cand}: {bad} ids out of the "
              f"stable order (value desc, id asc)")
        row = {"n_items": n_items, "T": t, "R": r, "B": b, "c": cand,
               "distinct_scores": distinct, "ids_checked": int(fin.sum()),
               "ms": cuda_ms(lambda: shortlist_topc(
                   u, tiles, scales, n_items, None, cand), iters=10),
               "device_ms": graph_ms(lambda: shortlist_topc(
                   u, tiles, scales, n_items, None, cand), launches=20),
               "plan": kernels.shortlist_plan(b, nt, t, r, cand).as_dict()}
        rows.append(row)
        log("kernels: shortlist ties " + json.dumps(row))
        del tiles, scales, sc, sv, si
    torch.cuda.empty_cache()
    kernels.reset_counts()
    return rows


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# batchpredict phase: `pio batchpredict` (workflow/batch_predict.py)
# ---------------------------------------------------------------------------

#: leg 1, the reference bench's cfg_batch_predict (bench.py:2251-2300):
#: catalog, rank, num, queries, chunk, shards, best of
#: one timed round a side (the bench's own took the best of 2; cut to fit
#: the smoke's time limit once the fleet phase came)
BP_BENCH = dict(n_users=5000, n_items=2000, rank=32, num=50,
                queries=40_000, chunk=1024, shards=2, reps=1, seed=11)
#: leg 2, the serve cell's model through B2: unmasked queries (16 full
#: chunks of num 10), masked chunks (1 query in 6 with a one-item
#: blackList), rows held to an exact recompute per part
BP_WIDTH = dict(chunk=1024, queries=16_384, masked_chunks=1, num=10,
                mask_every=6, sample=64)
#: leg 3, the CLI on the lifecycle's store: malformed lines planted at
#: these line numbers, users compared with the deployed query server
BP_CLI = dict(planted=(0, 7, 100, 500, 1000), num=10, compare=60)
#: B2 at a full chunk: rows held to the plain version (the first and
#: the last among them), and the library composite's block of rows
BP_KERNEL = dict(b=1024, rows=16, library_block=128)
#: scores of the same ids in two outputs: f32 sums in another order
BP_RTOL = 1e-5
#: the query server's answers against a batch run's (the reference's
#: `_assert_same_answers`, tests/test_batch_predict.py:609-636)
BP_ANSWER_RTOL, BP_ANSWER_ATOL = 1e-5, 1e-6


def _bp_rows(b: int, n: int):
    """``n`` row indices spread over ``[0, b)``, the first and the last
    among them."""
    import numpy as np

    return sorted({int(x) for x in np.linspace(0, b - 1, n).round()})


def kernels_chunk_rows(seed: int, n_items: int):
    """B2 at a full batch-predict chunk (B = 1,024) at the serving
    shapes, unmasked at the two-stage c of a plain query and masked at
    c 16: the kernel at the full B, a spread of its rows held to the
    plain version run on just those rows (the plain version at the full
    B would need 40 GB of f32 scores); ``plain_ms`` is that subset's,
    ``library_ms`` the library composite over blocks of 128 rows,
    summed."""
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import (
        shortlist_per_tile, shortlist_topc, shortlist_topc_reference,
        twostage_cand,
    )

    dev = torch.device(DEV)
    c = BP_KERNEL
    b, r, t = c["b"], SCAN_RANK, TILE
    nt = -(-n_items // t)
    per_tile = shortlist_per_tile(SHORTLIST, nt, t)
    g = torch.Generator(device=dev).manual_seed(seed + 1024)
    tiles = torch.randint(-127, 128, (nt, t, r), generator=g, device=dev,
                          dtype=torch.int8)
    scales = (0.5 + torch.rand((nt, t), generator=g, device=dev)) / 127.0
    deq = (tiles.float() * scales[..., None]).reshape(nt * t, r)
    u = torch.randn((b, r), generator=g, device=dev)
    rows = _bp_rows(b, c["rows"])
    sel = torch.tensor(rows, device=dev)
    out = []
    max_err = 0.0
    for masked in (False, True):
        cand = twostage_cand(per_tile, nt, t, BP_WIDTH["num"], masked)
        mask = None
        if masked:
            # 30% excluded, as the kernels phase's masked rows; drawn in
            # blocks of rows (a [B, nt*T] f32 draw would need 40 GB)
            mask = torch.empty((b, nt * t), dtype=torch.bool, device=dev)
            for i in range(0, b, 64):
                mask[i:i + 64] = torch.rand((min(64, b - i), nt * t),
                                            generator=g, device=dev) < 0.3
        kernels.reset_counts()
        got = shortlist_topc(u, tiles, scales, n_items, mask, cand)
        synchronize()
        check(kernels.SHORTLIST_LAUNCHES == 1,
              "shortlist wrapper did not launch its kernel at B=1024")
        m_sub = None if mask is None else mask[sel]
        wide = shortlist_topc_reference(u[sel], tiles, scales, n_items,
                                        m_sub, cand + 1)
        k = len(rows)
        err, problems = compare_shortlist(
            (got[0][sel], got[1][sel]),
            (wide[0].reshape(k, nt, cand + 1),
             wide[1].reshape(k, nt, cand + 1)), cand)
        check(not problems, f"shortlist B={b} c={cand} masked={masked} "
              f"(rows {rows}): {'; '.join(problems)}")
        max_err = max(max_err, err)
        del wide
        ms = cuda_ms(lambda: shortlist_topc(u, tiles, scales, n_items,
                                            mask, cand), iters=5)
        device_ms = graph_ms(lambda: shortlist_topc(
            u, tiles, scales, n_items, mask, cand), launches=2, reps=3)
        u_sub = u[sel].contiguous()
        plain_ms = cuda_ms(lambda: shortlist_topc_reference(
            u_sub, tiles, scales, n_items, m_sub, cand), iters=1)

        def library():
            # the two-call composite of the kernels phase, over blocks of
            # rows (a [B, N] f32 score matrix at B=1024 is 40 GB)
            blk = c["library_block"]
            res = []
            for i in range(0, b, blk):
                sc = torch.matmul(u[i:i + blk], deq.T)
                sc[:, n_items:] = float("-inf")
                if mask is not None:
                    sc.masked_fill_(mask[i:i + blk], float("-inf"))
                res.append(torch.topk(sc.view(-1, nt, t), cand, dim=2))
                del sc
            return res

        library_ms = cuda_ms(library, iters=1)
        plan = kernels.shortlist_plan(b, nt, t, r, cand, masked)
        bound, bound_by = shortlist_bound_ms(b, n_items, r, cand, nt,
                                             masked, plan.tensor_cores)
        row = {"B": b, "c": cand, "masked": masked, "ms": ms,
               "device_ms": device_ms, "plain_ms": plain_ms,
               "plain_rows": len(rows), "library_ms": library_ms,
               "library": f"composite in blocks of {c['library_block']} "
                          "rows, summed",
               "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": err, "held_rows": rows,
               "plan": plan.as_dict()}
        out.append(row)
        log("kernels: shortlist chunk " + json.dumps(row))
        del mask, m_sub
        torch.cuda.empty_cache()
    del tiles, scales, deq
    torch.cuda.empty_cache()
    kernels.reset_counts()
    return out, max_err


def bp_bench_result(device, c: dict):
    """The reference bench's synthetic trained recommendation engine
    (``_batchpredict_result``, bench.py:2106-2128) at shape ``c``: seeded
    normal factors, zero-padded ids; the same in every process of a
    fleet."""
    import numpy as np

    from predictionio_tpu_torch.core.engine import TrainResult
    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, RecommendationServing,
    )
    from predictionio_tpu_torch.models.als import ALSModel

    rng = np.random.default_rng(c["seed"])
    model = ALSModel.from_arrays(
        np.asarray([f"u{i:06d}" for i in range(c["n_users"])], dtype=object),
        np.asarray([f"i{i:06d}" for i in range(c["n_items"])], dtype=object),
        rng.normal(size=(c["n_users"], c["rank"])).astype(np.float32),
        rng.normal(size=(c["n_items"], c["rank"])).astype(np.float32),
        device=device)
    return TrainResult(models=[model],
                       algorithms=[ALSAlgorithm(AlgorithmParams())],
                       serving=RecommendationServing(),
                       engine_params=EngineParams())


def _bp_wait(paths, procs, what: str, timeout_s: float = 600):
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(p) for p in paths):
        for p in procs:
            if p.poll() is not None and p.returncode != 0:
                raise SmokeFailure(f"{what}: a shard exited "
                                   f"{p.returncode}: {p.stderr.read()[-2000:]}")
        check(time.monotonic() < deadline, f"{what}: timed out")
        time.sleep(0.005)


def bp_fleet_worker() -> int:
    """One shard of leg 1's fleet (``python3 -c "import chip_smoke;
    chip_smoke.bp_fleet_worker()"`` with ``PIO_PROCESS_ID`` /
    ``PIO_NUM_PROCESSES`` and ``CHIP_SMOKE_BP_{INPUT,OUTPUT,WARM}``, the
    parent's shape and device in ``CHIP_SMOKE_BP_{SHAPE,DEVICE}``): it
    builds the model and warms up, says it is ready, then scores one
    round each time the parent says go (the rendezvous keeps process
    start-up out of the timed window, as the reference bench does)."""
    sys.path.insert(0, str(ROOT))
    from predictionio_tpu_torch.workflow.batch_predict import (
        run_batch_predict,
    )

    c = json.loads(os.environ["CHIP_SMOKE_BP_SHAPE"])
    result = bp_bench_result(os.environ["CHIP_SMOKE_BP_DEVICE"], c)
    out = os.environ["CHIP_SMOKE_BP_OUTPUT"]
    # pio: ignore[PIO006]: a spawned shard reads its own rank wiring
    rank = os.environ["PIO_PROCESS_ID"]
    warm_out = f"{out}.warm-{rank}"
    run_batch_predict(None, None, os.environ["CHIP_SMOKE_BP_WARM"],
                      warm_out, chunk_size=c["chunk"], loaded=(result, None),
                      worker=(0, 1))
    os.unlink(warm_out)
    pathlib.Path(f"{out}.ready-{rank}").write_text("ready")
    for k in range(c["reps"]):
        deadline = time.monotonic() + 600
        while not os.path.exists(f"{out}.go-{k}"):
            if time.monotonic() > deadline:
                return 3
            time.sleep(0.002)
        run_batch_predict(None, None, os.environ["CHIP_SMOKE_BP_INPUT"],
                          f"{out}.{k}", chunk_size=c["chunk"],
                          loaded=(result, None))
        pathlib.Path(f"{out}.done-{k}-{rank}").write_text("done")
    return 0


def _bp_lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def same_predictions(got_path, want_path, what: str,
                     rtol: float = BP_RTOL) -> dict:
    """Two batch-predict outputs hold the same answers: byte-equal files,
    or the same query echo, item ids and order with scores within
    ``rtol``. Returns the line count, whether the files are byte-equal
    and the largest relative score gap."""
    import numpy as np

    if pathlib.Path(got_path).read_bytes() == pathlib.Path(
            want_path).read_bytes():
        return {"lines": len(_bp_lines(want_path)), "byte_equal": True,
                "max_rel_gap": 0.0}
    got, want = _bp_lines(got_path), _bp_lines(want_path)
    check(len(got) == len(want), f"{what}: {len(got)} lines, expected "
          f"{len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g["query"] == w["query"], f"{what}: line {i}'s query differs")
        gs, ws = g["prediction"]["itemScores"], w["prediction"]["itemScores"]
        check([x["item"] for x in gs] == [x["item"] for x in ws],
              f"{what}: line {i}'s items differ")
        a = np.array([x["score"] for x in gs], np.float64)
        b = np.array([x["score"] for x in ws], np.float64)
        if len(a):
            gap = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
            worst = max(worst, gap)
            check(bool(np.allclose(a, b, rtol=rtol, atol=0.0)),
                  f"{what}: line {i}'s scores differ by {gap} relative")
    return {"lines": len(got), "byte_equal": False, "max_rel_gap": worst}


def bp_bench_leg():
    """Leg 1: the reference bench's shape through ``run_batch_predict
    (loaded=...)`` on the card, exact scorer: inline, pipelined and a
    2-process fleet on the one card (manifest merge), ``reps`` timed
    rounds each (the best kept); the three outputs hold the same
    answers. No Pallas kernel runs
    here: it measures the workflow's host side."""
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import kernels, scoring
    from predictionio_tpu_torch.utils.server_config import ScorerConfig
    from predictionio_tpu_torch.workflow.batch_predict import (
        run_batch_predict,
    )

    c = BP_BENCH
    work = WORK / "batchpredict_bench"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    scoring.set_process_scorer_config(ScorerConfig(mode="exact"))
    procs = []
    try:
        inp, warm = work / "queries.jsonl", work / "warm.jsonl"
        lines = [json.dumps({"user": f"u{i % c['n_users']:06d}",
                             "num": c["num"]}) + "\n"
                 for i in range(c["queries"])]
        inp.write_text("".join(lines))
        warm.write_text("".join(lines[:c["chunk"] + 1]))
        # the fleet starts first: its processes build and warm up while
        # this one runs its own sides
        env = dict(os.environ, PIO_NUM_PROCESSES=str(c["shards"]),
                   CHIP_SMOKE_BP_INPUT=str(inp), CHIP_SMOKE_BP_WARM=str(warm),
                   CHIP_SMOKE_BP_OUTPUT=str(work / "fleet.jsonl"),
                   CHIP_SMOKE_BP_SHAPE=json.dumps(c),
                   CHIP_SMOKE_BP_DEVICE=DEV)
        env.pop("PIO_TRACE_CONTEXT", None)
        t_spawn = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.bp_fleet_worker())"],
            cwd=str(ROOT), env=dict(env, PIO_PROCESS_ID=str(p)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for p in range(c["shards"])]
        result = bp_bench_result(DEV, c)
        model = result.models[0]
        paths = {"host": 0, "device": 0}
        use_host = ALSModel._use_host

        def counted(self, n_rows, any_mask):
            host = use_host(self, n_rows, any_mask)
            paths["host" if host else "device"] += 1
            return host

        ALSModel._use_host = counted
        try:
            run_batch_predict(None, None, str(warm), str(work / "w.jsonl"),
                              chunk_size=c["chunk"], loaded=(result, None))
            paths.update(host=0, device=0)
            sides = {}
            kernels.reset_counts()
            for name, pipelined in (("inline", False), ("pipelined", True)):
                best = None
                for k in range(c["reps"]):
                    out = work / f"{name}-{k}.jsonl"
                    t0 = time.perf_counter()
                    rep = run_batch_predict(
                        None, None, str(inp), str(out),
                        chunk_size=c["chunk"], loaded=(result, None),
                        pipelined=pipelined)
                    wall = time.perf_counter() - t0
                    check(rep.written == c["queries"] and rep.invalid == 0
                          and rep.lane_fallbacks == 0,
                          f"batchpredict leg 1 {name}: {rep}")
                    if best is None or wall < best["seconds"]:
                        best = {"seconds": wall, "out": str(out),
                                "chunks": rep.chunks, "lane": rep.lane}
                best["queries_per_s"] = c["queries"] / best["seconds"]
                sides[name] = best
            check(kernels.counts() == {"shortlist": 0, "spd_solve": 0},
                  f"batchpredict leg 1 launched {kernels.counts()}")
        finally:
            ALSModel._use_host = use_host
        # the fleet: both shards ready, then each round timed from the go
        # signal to the last shard's done marker (the merge included)
        fleet = work / "fleet.jsonl"
        _bp_wait([f"{fleet}.ready-{p}" for p in range(c["shards"])], procs,
                 "batchpredict leg 1 fleet set-up")
        spawn_s = time.perf_counter() - t_spawn
        rounds = []
        for k in range(c["reps"]):
            t0 = time.perf_counter()
            pathlib.Path(f"{fleet}.go-{k}").write_text("go")
            _bp_wait([f"{fleet}.done-{k}-{p}" for p in range(c["shards"])],
                     procs, f"batchpredict leg 1 fleet round {k}")
            rounds.append(time.perf_counter() - t0)
        for p in procs:
            check(p.wait(timeout=120) == 0,
                  f"batchpredict leg 1: a shard exited {p.returncode}")
        k = min(range(len(rounds)), key=rounds.__getitem__)
        sides["fleet"] = {"seconds": rounds[k], "out": f"{fleet}.{k}",
                          "rounds_s": rounds, "spawn_s": spawn_s,
                          "queries_per_s": c["queries"] / rounds[k],
                          "shards": c["shards"]}
        held = {name: same_predictions(sides[name]["out"],
                                       sides["inline"]["out"],
                                       f"batchpredict leg 1 {name}")
                for name in ("pipelined", "fleet")}
        report = {"shape": {k2: c[k2] for k2 in ("n_users", "n_items",
                                                 "rank", "num", "queries",
                                                 "chunk")},
                  "scorer": "exact", "scorer_paths": paths,
                  "sides": {n: {k2: v for k2, v in s.items() if k2 != "out"}
                            for n, s in sides.items()},
                  "held_to_inline": held,
                  "model_device": str(model.device)}
        log("batchpredict: leg 1 " + json.dumps(report))
        return report
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        scoring.set_process_scorer_config(None)
        shutil.rmtree(work, ignore_errors=True)


class _StageClock:
    """Leg 2's split of the scorer stage, by wrapping the scorer's own
    steps for the run: the shortlist kernel's device time (CUDA events
    around each call), the exact rescore, the uploads and the whole
    two-stage top-k (host clocks), the file writes."""

    def __init__(self):
        self.events, self.host = [], {}

    def add(self, name, dt):
        self.host[name] = self.host.get(name, 0.0) + dt

    def __enter__(self):
        import torch

        from predictionio_tpu_torch.ops import scoring
        from predictionio_tpu_torch.workflow import batch_predict

        self._saved = [(scoring, "shortlist_topc", scoring.shortlist_topc),
                       (scoring.ItemScorer, "topk", scoring.ItemScorer.topk),
                       (scoring.ItemScorer, "_rescore_exact",
                        scoring.ItemScorer._rescore_exact),
                       (scoring.ItemScorer, "_to_device",
                        scoring.ItemScorer._to_device),
                       (batch_predict._JsonlSink, "write_chunk",
                        batch_predict._JsonlSink.write_chunk)]
        clock = self

        def timed(name, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    clock.add(name, time.perf_counter() - t0)
            return wrapper

        kernel = scoring.shortlist_topc

        def shortlist(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*a, **k)
            end.record()
            clock.events.append((start, end))
            return out

        scoring.shortlist_topc = shortlist
        scoring.ItemScorer.topk = timed("topk_s", self._saved[1][2])
        scoring.ItemScorer._rescore_exact = timed("rescore_s",
                                                  self._saved[2][2])
        scoring.ItemScorer._to_device = timed("upload_s", self._saved[3][2])
        batch_predict._JsonlSink.write_chunk = timed("file_write_s",
                                                     self._saved[4][2])
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False

    def split(self, registry, seconds: float, rows: int) -> dict:
        synchronize()
        spans = registry.get("pio_span_duration_seconds")
        span_s = {s: spans.sum_(span=f"batchpredict_{s}")
                  for s in ("read", "score", "write")}
        b2 = sum(s.elapsed_time(e) for s, e in self.events)
        return {"wall_s": seconds, "rows_per_s": rows / seconds,
                "read_decode_s": span_s["read"],
                "score_s": span_s["score"],
                "b2_device_ms": b2, "b2_calls": len(self.events),
                "twostage_topk_s": self.host.get("topk_s", 0.0),
                "upload_s": self.host.get("upload_s", 0.0),
                "rescore_s": self.host.get("rescore_s", 0.0),
                "model_rest_s": span_s["score"] - self.host.get("topk_s",
                                                                0.0),
                "serialize_s": span_s["write"] - self.host.get(
                    "file_write_s", 0.0),
                "file_write_s": self.host.get("file_write_s", 0.0)}


def bp_width_leg(seed, users, items, U, V):
    """Leg 2: the serve cell's 10M x 64 model through ``run_batch_predict``
    at chunk 1,024 under the two-stage scorer (B2 once a chunk): 16 full
    chunks of plain queries, then ``masked_chunks`` chunks (1: cut from 2
    for the time limit) in which 1 query in 6 carries
    a one-item blackList (a dense [chunk, 10M] mask a chunk). Each part:
    B2 launches equal to its chunks, no lane fallback, a spread of 64
    rows equal to an exact recompute on the card (ids up to ties, scores
    within 1e-4) with recall@10 >= 0.99, the gate still on twostage;
    rows/s and the stage split."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.core.engine import TrainResult
    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, RecommendationServing,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.ops import kernels, scoring
    from predictionio_tpu_torch.utils.server_config import ScorerConfig
    from predictionio_tpu_torch.workflow.batch_predict import (
        run_batch_predict,
    )

    c = BP_WIDTH
    n_items, rank = V.shape
    work = WORK / "batchpredict_width"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    scoring.set_process_scorer_config(ScorerConfig(
        mode="twostage", tile_items=TILE, shortlist=SHORTLIST))
    try:
        model = ALSModel.from_arrays(users, items, U, V, device=DEV)
        t0 = time.perf_counter()
        scorer = scoring.scorer_for(model, model.V)
        build_s = time.perf_counter() - t0
        check(scorer is not None and scorer.active_mode == "twostage"
              and scorer.scan_rank == SCAN_RANK,
              f"batchpredict leg 2: scorer {scorer and scorer.status()}")
        result = TrainResult(models=[model],
                             algorithms=[ALSAlgorithm(AlgorithmParams())],
                             serving=RecommendationServing(),
                             engine_params=EngineParams())
        rng = np.random.default_rng(seed + 10)
        U_dev = torch.from_numpy(U).to(DEV)
        V_dev = model.V_device
        parts = {}
        for part, n_q, masked in (
                ("unmasked", c["queries"], False),
                ("masked", c["masked_chunks"] * c["chunk"], True)):
            picks = rng.integers(0, len(users), n_q)
            black = rng.integers(0, n_items, n_q)
            queries = []
            for j in range(n_q):
                q = {"user": str(users[picks[j]]), "num": c["num"]}
                if masked and j % c["mask_every"] == 0:
                    q["blackList"] = [str(items[black[j]])]
                queries.append(q)
            inp, out = work / f"{part}.jsonl", work / f"{part}-out.jsonl"
            inp.write_text("".join(json.dumps(q) + "\n" for q in queries))
            registry = MetricsRegistry()
            gc.collect()
            kernels.reset_counts()
            with _StageClock() as clock:
                t0 = time.perf_counter()
                rep = run_batch_predict(None, None, str(inp), str(out),
                                        chunk_size=c["chunk"],
                                        loaded=(result, None),
                                        registry=registry)
                wall = time.perf_counter() - t0
            launches = kernels.counts()["shortlist"]
            split = clock.split(registry, wall, rep.written)
            check(rep.written == n_q and rep.invalid == 0,
                  f"batchpredict leg 2 {part}: {rep}")
            check(rep.chunks == n_q // c["chunk"] and launches == rep.chunks,
                  f"batchpredict leg 2 {part}: {launches} B2 launches for "
                  f"{rep.chunks} chunks")
            check(rep.lane == "columnar" and rep.lane_fallbacks == 0,
                  f"batchpredict leg 2 {part}: lane {rep.lane}, "
                  f"{rep.lane_fallbacks} fallbacks")
            check(model._scorer_cache[2] is scorer and scorer.active_mode
                  == "twostage", "batchpredict leg 2: the scorer was "
                  "rebuilt or demoted")
            # a spread of rows against an exact recompute on the card
            lines = _bp_lines(out)
            sample = _bp_rows(n_q, c["sample"])
            if masked:      # and every masked row among the first chunk's
                sample = sorted(set(sample) | {
                    j for j in range(0, c["chunk"], c["mask_every"])})
            hits, max_err = 0, 0.0
            for j in sample:
                q, line = queries[j], lines[j]
                check(line["query"] == q, f"leg 2: line {j} is not query {j}")
                sc = V_dev @ U_dev[int(picks[j])]
                if "blackList" in q:
                    sc[int(black[j])] = float("-inf")
                vals, idx = torch.topk(sc, c["num"])
                vals = vals.cpu().numpy()
                want = [str(items[i]) for i in idx.tolist()]
                got = line["prediction"]["itemScores"]
                check(len(got) == c["num"], f"leg 2: row {j} got {len(got)}")
                got_ids = [x["item"] for x in got]
                err = np.abs(np.array([x["score"] for x in got]) - vals)
                max_err = max(max_err, float(err.max()))
                check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(vals)))
                           .all()), f"leg 2 {part}: row {j}'s scores differ "
                      f"from the exact top-10 by {float(err.max())}")
                for a, b_, v in zip(got_ids, want, vals):
                    tied = np.abs(vals - v) <= 1e-4 * max(1.0, abs(v))
                    check(a == b_ or a in {want[t] for t in
                                           np.flatnonzero(tied)},
                          f"leg 2 {part}: row {j} {got_ids}, exact {want}")
                check("blackList" not in q or q["blackList"][0]
                      not in got_ids, f"leg 2: row {j} served an excluded "
                      "item")
                hits += len(set(got_ids) & set(want))
            recall = hits / (c["num"] * len(sample))
            check(recall >= 0.99, f"batchpredict leg 2 {part}: recall@10 "
                  f"{recall} over {len(sample)} rows")
            b_pad, n_pad = c["chunk"], scorer.n_tiles * scorer.tile
            parts[part] = {
                "queries": n_q, "chunks": rep.chunks, "b2_launches": launches,
                "lane": rep.lane, "lane_fallbacks": rep.lane_fallbacks,
                "held_rows": len(sample), "recall_at_10": recall,
                "max_score_abs_err": max_err, **split,
                "cand_per_tile": scoring.twostage_cand(
                    scorer.cand_per_tile, scorer.n_tiles, scorer.tile,
                    c["num"], masked),
                "mask_bytes_per_chunk": ({
                    "host_rows": c["chunk"] * n_items,
                    "host_padded": b_pad * n_pad,
                    "device": b_pad * n_pad} if masked else None),
                "rescore_gather_bytes_per_chunk": c["chunk"] * scoring.
                twostage_cand(scorer.cand_per_tile, scorer.n_tiles,
                              scorer.tile, c["num"], masked)
                * scorer.n_tiles * rank * 4}
            log(f"batchpredict: leg 2 {part} " + json.dumps(parts[part]))
            out.unlink()
        report = {"scorer": scorer.status(), "scorer_build_s": build_s,
                  "parts": parts,
                  "launches": sum(p["b2_launches"] for p in parts.values())}
        del model, result, U_dev
        return report
    finally:
        scoring.set_process_scorer_config(None)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        import torch

        torch.cuda.empty_cache()


def batchpredict_cli_leg(env, work, variant, key: str, port: int):
    """Leg 3, inside the lifecycle on its store: ``batchpredict`` through
    the CLI on the variant's latest instance, one query per user and 5
    planted malformed lines; then a 2-shard CLI run (``PIO_PROCESS_ID`` /
    ``PIO_NUM_PROCESSES``) into the same output name; then a query server
    deployed from the same instance answers a sample of the users as
    the batch run did."""
    import numpy as np

    c = BP_CLI
    bp = work / "batchpredict"
    bp.mkdir(parents=True, exist_ok=True)
    users = [f"u{u}" for u in range(ML100K["n_users"] + 100)]
    lines = [json.dumps({"user": u, "num": c["num"]}) for u in users]
    planted = []
    for j, at in enumerate(c["planted"]):
        lines.insert(at, "{not json" if j % 2 == 0
                     else json.dumps({"wrongField": j}))
        planted.append(at)
    inp, out = bp / "queries.jsonl", bp / "preds.jsonl"
    inp.write_text("\n".join(lines) + "\n")
    args = ["batchpredict", "--variant", str(variant), "--input", str(inp),
            "--output", str(out), "--device", DEV]
    t0 = time.perf_counter()
    single = json.loads(_cli(args, env)[-1])
    single["wall_s"] = time.perf_counter() - t0
    log("lifecycle: batchpredict " + json.dumps(single))
    check(single["written"] == len(users) and single["invalid"]
          == len(planted) and single["lane_fallbacks"] == 0,
          f"batchpredict CLI: {single}")
    errors = _bp_lines(f"{out}.errors.jsonl")
    check([e["row"] for e in errors] == planted,
          f"batchpredict CLI: sidecar rows {[e['row'] for e in errors]}, "
          f"planted {planted}")
    first = bp / "single.jsonl"
    os.replace(out, first)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
        cwd=str(ROOT), env=dict(env, PIO_PROCESS_ID=str(r),
                                PIO_NUM_PROCESSES="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    shards = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        check(p.returncode == 0, f"batchpredict CLI shard failed: {se[-2000:]}")
        shards.append(json.loads(so.strip().splitlines()[-1]))
    shard_s = time.perf_counter() - t0
    check(sum(s["merged"] for s in shards) == 1
          and sum(s["written"] for s in shards) == len(users),
          f"batchpredict CLI shards: {shards}")
    held = same_predictions(out, first, "batchpredict CLI 2-shard merge")
    check(len(_bp_lines(f"{out}.errors.jsonl")) == len(planted),
          "batchpredict CLI: the merged sidecar lost rows")
    # the same queries to a query server deployed from the same instance
    server = Server(["deploy", "--variant", str(variant), "--port",
                     str(port), "--device", DEV, "--accesskey", key], env,
                    tag="lifecycle")
    try:
        qc = Client(server.wait_ready(timeout_s=300))
        _, root, _ = qc.call("GET", "/")
        check(root["engineInstance"]["id"] == single["instance"],
              f"deploy serves {root['engineInstance']['id']}, batchpredict "
              f"scored {single['instance']}")
        by_user = {ln["query"]["user"]: ln["prediction"]
                   for ln in _bp_lines(first)}
        picks = np.random.default_rng(7).choice(len(users), c["compare"],
                                                replace=False)
        worst = 0.0
        for j in picks.tolist():
            status, body, _ = qc.call("POST", "/queries.json",
                                      {"user": users[j], "num": c["num"]})
            check(status == 200, f"query for {users[j]} answered {status}")
            want = by_user[users[j]]["itemScores"]
            got = body["itemScores"]
            check([x["item"] for x in got] == [x["item"] for x in want],
                  f"batchpredict CLI: {users[j]} served {got}, batch {want}")
            for a, b_ in zip(got, want):
                worst = max(worst, abs(a["score"] - b_["score"]))
                check(math.isclose(a["score"], b_["score"],
                                   rel_tol=BP_ANSWER_RTOL,
                                   abs_tol=BP_ANSWER_ATOL),
                      f"batchpredict CLI: {users[j]} scores {got} vs {want}")
        status, _, _ = qc.call("POST", f"/stop?accessKey={key}")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "batchpredict CLI: the query server did not stop")
    finally:
        server.stop()
    report = {"single": single, "shards": shards, "shard_wall_s": shard_s,
              "merge_held": held, "planted": len(planted),
              "compared_users": int(len(picks)),
              "max_score_abs_gap_vs_server": worst,
              "b2_launches": single["launches"]["shortlist"]
              + sum(s["launches"]["shortlist"] for s in shards)}
    log("lifecycle: batchpredict CLI " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# fleet phase: the router tier, a fleet of replicas, the orchestrator
# ---------------------------------------------------------------------------

#: leg 1: the reference bench's fleet_scaling leg 1 (bench.py:2805-2958):
#: 20 ms injected service time, 1 slot, 3 clients a replica; 2 s stages
#: (about 100 queries a replica), cut from the bench's 4 s for the time
#: limit
FLEET_STUB = dict(service_ms=20.0, slots=1, clients_per=3, stage_s=2.0,
                  stages=(1, 2, 4), min_scaling=3.0, p99_ratio=2.0,
                  p99_slack_ms=5.0)
#: leg 2: the serve cell's model behind ``router --replicas 2``; the
#: obs cell's traffic (384 queries at 8 clients); an SLO the load
#: breaches (every query above 2 ms, a 1 s window) for the autoscaler
FLEET = dict(replicas=2, queries=384, clients=8, serial=100,
             health_interval_s=0.25, burn_sustain_s=6.0, idle_qps=30.0,
             idle_sustain_s=2.0, cooldown_s=1.0, trickle_s=0.1,
             cut_users=24, kill_after_s=1.0, kill_s=3.0,
             slo={"objectives": [{"name": "p99", "kind": "latency",
                                  "thresholdS": 0.002, "budget": 0.01}],
                  "windows": [{"seconds": 1, "burnThreshold": 1.0}],
                  "evalIntervalS": 0.1})
#: leg 3: fresh events past the ingest trigger's 500, the smoke's query
#: file, and a canary the server judges on a few dozen samples
FLEET_ORCH = dict(fresh_events=600, smoke_queries=64, canary_clients=4,
                  canary_promote_after=30, canary_min_samples=10,
                  compare_users=20)
RECOMMENDATION = PORT_PACKAGE + ".engines.recommendation:engine"


def fleet_router_leg() -> dict:
    """Leg 1: the router tier alone over stub replicas (the port's own
    ``HttpServer``, an injected service time behind a semaphore), 4 s
    stages at 1, 2 and 4 replicas: qps and p99 through the router, zero
    dropped queries, each replica's share within +-1 of an exact spread,
    qps(4)/qps(1) >= 3 and p99(4) <= 2 p99(1) + 5 ms. No kernel runs
    here: it measures the router, not a model."""
    import asyncio

    import numpy as np

    from predictionio_tpu_torch.server.http import HttpServer
    from predictionio_tpu_torch.server.http_client import HttpClient
    from predictionio_tpu_torch.server.router import Router
    from predictionio_tpu_torch.utils.server_config import RouterConfig

    s = FLEET_STUB

    async def start_replica():
        sem = asyncio.Semaphore(s["slots"])

        async def queries(_req):
            async with sem:
                await asyncio.sleep(s["service_ms"] / 1000.0)
            return 200, {"itemScores": []}

        async def slo(_req):
            return 200, {"breached": False}

        async def status(_req):
            return 200, {"active": {"releaseVersion": 1}}

        srv = HttpServer([("POST", "/queries.json", queries),
                          ("GET", "/slo.json", slo),
                          ("GET", "/deploy/status.json", status)])
        return srv, f"http://127.0.0.1:{await srv.start('127.0.0.1', 0)}"

    async def stage(n):
        reps = [await start_replica() for _ in range(n)]
        router = Router(RouterConfig(health_interval_s=0.2,
                                     health_fail_after=2, proxy_retries=1),
                        replica_urls=[u for _, u in reps])
        port = await router.start("127.0.0.1", 0)
        client = HttpClient()
        try:
            for rank in list(router.replicas):
                check(await router.wait_replica_healthy(rank, timeout_s=10),
                      f"fleet leg 1: stub replica {rank} never healthy")
            url = f"http://127.0.0.1:{port}/queries.json"
            lat, bad = [], []
            deadline = time.perf_counter() + s["stage_s"]

            async def one():
                while time.perf_counter() < deadline:
                    t0 = time.perf_counter()
                    resp = await client.request("POST", url,
                                                json_body={"user": "u1"})
                    if resp.status != 200:
                        bad.append(resp.status)
                    lat.append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            await asyncio.gather(*[one() for _ in range(
                s["clients_per"] * n)])
            elapsed = time.perf_counter() - t0
            dropped = sum(v for _, v in router._dropped.samples())
            spread = {lb["replica"]: v for lb, v in
                      router._requests.samples() if lb["status"] == "200"}
            return {"replicas": n, "queries": len(lat),
                    "qps": len(lat) / elapsed,
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                    "dropped": dropped, "failed": len(bad),
                    "spread": spread}
        finally:
            await client.close()
            await router.close()
            for srv, _ in reps:
                await srv.close()

    stages = {}
    for n in s["stages"]:
        st = asyncio.run(stage(n))
        log("fleet: leg 1 " + json.dumps(st))
        check(st["dropped"] == 0 and st["failed"] == 0,
              f"fleet leg 1: {st['dropped']} dropped, {st['failed']} "
              f"failed at {n} replicas")
        total = sum(st["spread"].values())
        check(all(abs(v - total / n) <= 1.0 for v in st["spread"].values()),
              f"fleet leg 1: spread {st['spread']} at {n} replicas is not "
              "exact")
        stages[n] = st
    scaling = stages[4]["qps"] / stages[1]["qps"]
    check(scaling >= s["min_scaling"], f"fleet leg 1: qps(4)/qps(1) "
          f"{scaling:.2f} under {s['min_scaling']}")
    bound = stages[1]["p99_ms"] * s["p99_ratio"] + s["p99_slack_ms"]
    check(stages[4]["p99_ms"] <= bound, f"fleet leg 1: p99(4) "
          f"{stages[4]['p99_ms']:.2f} ms over {bound:.2f} ms")
    return {"stages": stages, "scaling_4": scaling, "p99_bound_ms": bound,
            **{k: v for k, v in s.items() if k != "stages"}}


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive free local ports."""
    import random
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20_000, 40_000)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise SmokeFailure("no run of free ports")


def _spawned(router: "Server") -> dict:
    """rank -> pid of each replica the router says it spawned."""
    out = {}
    for line in list(router.history):
        if "Spawned replica" in line:
            out[int(line.split("replica ")[1].split()[0])] = int(
                line.split("(pid ")[1].split(")")[0])
    return out


def _gpu_pids() -> tuple:
    """(pids with a CUDA context, how they were read): ``nvidia-smi
    --query-compute-apps=pid``; where that lists none of this host's
    processes (another pid namespace), the processes with the CUDA
    user-space library mapped (``/proc/<pid>/maps``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    listed = {int(x) for x in out.split() if x.strip().isdigit()}
    if os.getpid() in listed:
        return listed, "nvidia-smi"
    mapped = set()
    for d in pathlib.Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            if "libcuda.so" in (d / "maps").read_text():
                mapped.add(int(d.name))
        except OSError:
            continue
    return mapped, "proc-maps"


def _rss_mb(pid: int) -> float:
    for line in pathlib.Path(f"/proc/{pid}/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024.0
    return float("nan")


def _fleet_query(port: int, user: str, num: int = 10, headers=None):
    c = Client(port)
    try:
        data = json.dumps({"user": user, "num": num}).encode()
        t0 = time.perf_counter()
        c.conn.request("POST", "/queries.json", body=data, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = c.conn.getresponse()
        return resp.status, json.loads(resp.read()), \
            time.perf_counter() - t0
    finally:
        c.conn.close()


def _fleet_drive(port: int, users, n: int, clients: int, seed: int,
                 until: threading.Event = None, pause_s: float = 0.0):
    """``n`` queries of num 10 from ``clients`` threads on keep-alive
    connections (with ``until``: each client loops over its share until
    the event is set); returns ([(user, status, body, seconds)],
    [failures])."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    picks = [str(users[i]) for i in rng.integers(0, len(users), size=n)]
    per = -(-n // clients)
    out, failures, lock = [], [], threading.Lock()

    def run(lo):
        c = Client(port)
        share = picks[lo:lo + per]
        for k, user in enumerate(share if until is None
                                 else itertools.cycle(share)):
            if until is not None and until.is_set():
                return
            try:
                status, body, dt = c.call("POST", "/queries.json",
                                          {"user": user, "num": 10})
            except Exception as e:          # noqa: BLE001 — reported
                with lock:
                    failures.append(repr(e))
                c = Client(port)
                continue
            with lock:
                out.append((user, status, body, dt))
                if status != 200:
                    failures.append(f"{status} {str(body)[:200]}")
            if pause_s:
                time.sleep(pause_s)

    threads = [threading.Thread(target=run, args=(lo,), daemon=True)
               for lo in range(0, n, per)]
    for t in threads:
        t.start()
    return threads, out, failures


def _join(threads, what: str, timeout_s: float = 600):
    for t in threads:
        t.join(timeout=timeout_s)
    check(not any(t.is_alive() for t in threads), f"{what}: clients hung")


def _together(*fns):
    """Call each of ``fns`` in a thread of its own, all at once; their
    results in order. The first failure is raised once every call has
    ended."""
    out, errors = [None] * len(fns), []

    def run(j, fn):
        try:
            out[j] = fn()
        except BaseException as e:      # re-raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j, fn), daemon=True)
               for j, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _exact_answers(U, V_dev, index, answers, tag: str) -> dict:
    """(user, status, body) answers of a twostage scorer against the
    exact f32 scores on the card, the serve phase's rule: every served
    item's score equal to its exact score within 1e-4, recall@10 >= 0.99
    against the exact top-10 over all the answers."""
    import numpy as np
    import torch

    max_err, hits, total = 0.0, 0, 0
    for lo in range(0, len(answers), 32):
        chunk = answers[lo:lo + 32]
        rows = torch.from_numpy(U[[index[u] for u, *_ in chunk]]).to(DEV)
        top = torch.topk(rows @ V_dev.T, 10, dim=1).indices.cpu().numpy()
        for k, ((user, status, body, *_), want) in enumerate(
                zip(chunk, top)):
            check(status == 200, f"{tag}: {user} answered {status}")
            got = body["itemScores"]
            check(len(got) == 10, f"{tag}: {user} got {len(got)} items")
            ids = [int(x["item"][1:]) for x in got]
            exact = (V_dev[torch.as_tensor(ids, device=V_dev.device)]
                     @ rows[k]).cpu().numpy()
            err = np.abs(np.array([x["score"] for x in got]) - exact)
            max_err = max(max_err, float(err.max()))
            check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(exact)))
                       .all()), f"{tag}: {user}'s served scores off the "
                  f"exact scores of those items by {float(err.max())}")
            hits += len(set(ids) & set(want.tolist()))
            total += 10
    recall = hits / total
    check(recall >= 0.99, f"{tag}: recall@10 {recall:.4f} < 0.99 against "
          "the exact top-10")
    return {"max_score_abs_err": max_err, "recall_at_10": recall}


def _same_answers(got, want, tag: str) -> None:
    """check_top10's rule between two answers of one user: ids equal up
    to ties within 1e-4, scores within 1e-4."""
    import numpy as np

    a, b = got["itemScores"], want["itemScores"]
    check(len(a) == len(b), f"{tag}: {len(a)} items against {len(b)}")
    va = np.array([x["score"] for x in a])
    vb = np.array([x["score"] for x in b])
    check(bool((np.abs(va - vb) <= 1e-4 * np.maximum(1.0, np.abs(vb)))
               .all()), f"{tag}: scores {va} against {vb}")
    ids_b = [x["item"] for x in b]
    for x, v in zip(a, vb):
        tied = np.abs(vb - v) <= 1e-4 * max(1.0, abs(v))
        check(x["item"] in {ids_b[t] for t in np.flatnonzero(tied)},
              f"{tag}: {[y['item'] for y in a]} against {ids_b}")


def _metric_samples(port: int, name: str) -> list:
    _, mj, _ = Client(port).call("GET", "/metrics.json")
    return _metric(mj, name)


def _router_requests(port: int) -> dict:
    return {s["labels"]["replica"]: s["value"]
            for s in _metric_samples(port, "pio_router_requests_total")
            if s["labels"]["status"] == "200"}


def _wait(pred, what: str, timeout_s: float, step_s: float = 0.1):
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        check(time.monotonic() < deadline, f"{what} (waited {timeout_s} s)")
        time.sleep(step_s)


def fleet_replicas_leg(seed: int, users, items, U, V, blob: bytes) -> dict:
    """Leg 2: the serve cell's model behind ``router --replicas 2``
    through the CLI, the replicas on the card (module docstring)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.obs.trace_context import (
        TRACE_HEADER, TraceContext,
    )
    from predictionio_tpu_torch.storage.base import App, EngineInstance, Model
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    from predictionio_tpu_torch.server.router import SPAWN_HEALTHY_TIMEOUT_S

    f = FLEET
    n_items, rank = V.shape
    work = WORK / "fleet"
    env = smoke_store(work)
    home = work / "home"
    (home / "conf").mkdir(parents=True)
    (home / "conf" / "server.json").write_text(json.dumps({"slo": f["slo"]}))
    base_port = _free_ports(4)
    env.update({
        "PIO_HOME": str(home), "PIO_SCORER_MODE": "twostage",
        "PIO_SCORER_TILE_ITEMS": str(TILE),
        "PIO_SCORER_SHORTLIST": str(SHORTLIST),
        "PIO_ROUTER_BASE_PORT": str(base_port),
        "PIO_ROUTER_HEALTH_INTERVAL_S": str(f["health_interval_s"]),
        "PIO_FLEET_AUTOSCALE": "1",
        "PIO_FLEET_MIN_REPLICAS": str(f["replicas"]),
        "PIO_FLEET_MAX_REPLICAS": str(f["replicas"] + 1),
        "PIO_FLEET_BURN_SUSTAIN_S": str(f["burn_sustain_s"]),
        "PIO_FLEET_IDLE_QPS": str(f["idle_qps"]),
        "PIO_FLEET_IDLE_SUSTAIN_S": str(f["idle_sustain_s"]),
        "PIO_FLEET_COOLDOWN_S": str(f["cooldown_s"]),
        "PIO_FLEET_STATE_DIR": str(work / "fleet_state")})
    report = {"card": card_line(), "items": n_items, "rank": rank,
              "users": len(users)}
    index = {str(u): i for i, u in enumerate(users)}
    t0 = time.perf_counter()
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="FleetApp"))
    Storage.get_events().init_channel(app_id)

    def instance(n):
        inst = EngineInstance(
            id=f"fleet-v{n}", status="COMPLETED",
            engine_id=RECOMMENDATION, engine_version="1",
            engine_variant="default",
            data_source_params=json.dumps({"appName": "FleetApp"}),
            algorithms_params=json.dumps(
                [{"name": "als", "params": {"rank": rank}}]))
        Storage.get_meta_data_engine_instances().insert(inst)
        return inst

    inst1 = instance(1)
    Storage.get_model_data_models().insert(Model(id=inst1.id, models=blob))
    rel1 = record_release(inst1, 0.0, blob)
    Storage.get_meta_data_releases().set_status(rel1.id, "LIVE", "fleet v1")
    report["v1_stored_s"] = time.perf_counter() - t0
    variant = work / "engine.json"
    variant.write_text(json.dumps({
        "id": "default", "engineFactory": RECOMMENDATION,
        "datasource": {"params": {"appName": "FleetApp"}},
        "algorithms": [{"name": "als", "params": {"rank": rank}}]}))

    router = None
    stoppers = []
    try:
        t0 = time.perf_counter()
        router = Server(["router", "--variant", str(variant), "--ip",
                         "127.0.0.1", "--port", "0", "--replicas",
                         str(f["replicas"]), "--device", DEV], env,
                        tag="fleet")
        r_port = router.wait_ready(timeout_s=120)
        rc = Client(r_port)

        def fleet_status():
            return rc.call("GET", "/fleet/status.json")[1]

        def healthy(n):
            reps = fleet_status()["replicas"]
            return len(reps) == n and all(r["healthy"] for r in reps)

        # v2 (V perturbed from the seed) is built while the replicas
        # come up, and registered only before the cutover: a replica
        # deploys the newest COMPLETED instance
        rng = np.random.default_rng(seed + 21)
        spec = np.abs(V[:4096]).mean(axis=0).astype(np.float32)
        V2 = V + 0.5 * spec * rng.standard_normal(V.shape, dtype=np.float32)
        blob2 = serialize_models([ALSModel.from_arrays(users, items, U, V2,
                                                       device="cpu")])
        report["v2_built_s"] = time.perf_counter() - t0
        _wait(lambda: healthy(f["replicas"]), "fleet: the replicas did not "
              "come up", timeout_s=300, step_s=0.25)
        report["fleet_up_s"] = time.perf_counter() - t0
        spawned = _spawned(router)
        check(sorted(spawned) == list(range(f["replicas"])),
              f"fleet: spawned {spawned}")
        rep_port = {r_: base_port + r_ for r_ in spawned}
        quiet = _fleet_quiet(rc)

        # 1. steady traffic, through the router and direct ---------------
        V_dev = torch.from_numpy(V).to(DEV)
        roots0 = {r_: Client(p).call("GET", "/")[1]
                  for r_, p in rep_port.items()}
        for r_, root in roots0.items():
            sc = root["scorer"][0]
            check(sc["activeMode"] == "twostage", f"fleet: replica {r_} "
                  f"serves {sc['activeMode']} (probe recall "
                  f"{sc['recallProbe']})")
        req0 = _router_requests(r_port)
        threads, answers, failures = _fleet_drive(
            r_port, users, f["queries"], f["clients"], seed + 22)
        _join(threads, "fleet steady")
        check(not failures, f"fleet: {len(failures)} queries failed at 8 "
              f"clients through the router: {failures[:3]}")
        req1 = _router_requests(r_port)
        roots1 = {r_: Client(p).call("GET", "/")[1]
                  for r_, p in rep_port.items()}
        exact = _exact_answers(U, V_dev, index, answers, "fleet steady")
        quiet()
        direct = Client(rep_port[0])
        for user, _, body, _ in answers:
            _same_answers(body, direct.call("POST", "/queries.json", {
                "user": user, "num": 10})[1], f"fleet steady {user}")
        share = {r_: req1.get(str(r_), 0) - req0.get(str(r_), 0)
                 for r_ in rep_port}
        check(all(abs(v - f["queries"] / len(share)) <= 1
                  for v in share.values()),
              f"fleet: the replicas' shares {share} are not within +-1 "
              "of half")
        b2 = {r_: roots1[r_]["kernelLaunches"]["shortlist"]
              - roots0[r_]["kernelLaunches"]["shortlist"] for r_ in rep_port}
        batches = {r_: roots1[r_]["microBatches"]["batches"]
                   - roots0[r_]["microBatches"]["batches"]
                   for r_ in rep_port}
        check(sum(b2.values()) == sum(batches.values()) > 0,
              f"fleet: B2 launched {b2} for micro-batches {batches}")
        # one query's trace id in the router's recorder and the serving
        # replica's
        ctx = TraceContext.root()
        trace_id = ctx.trace_id
        status, _, _ = _fleet_query(r_port, str(users[0]),
                                    headers={TRACE_HEADER: ctx.encode()})
        check(status == 200, f"fleet: the traced query answered {status}")
        in_router = Client(r_port).call(
            "GET", f"/debug/traces.json?traceId={trace_id}")[1]["traces"]
        in_reps = {r_: Client(p).call(
            "GET", f"/debug/traces.json?traceId={trace_id}")[1]["traces"]
            for r_, p in rep_port.items()}
        check(in_router and sum(1 for v in in_reps.values() if v) == 1,
              f"fleet: trace {trace_id} in the router {len(in_router)} "
              f"times, in the replicas {[len(v) for v in in_reps.values()]}")
        # HTTP latency: through the router against direct to replica 0
        lat = {}
        for name, p in (("router", r_port), ("direct", rep_port[0])):
            quiet()
            one = [_fleet_query(p, str(users[i]))[2] for i in
                   np.random.default_rng(seed + 23).integers(
                       0, len(users), f["serial"])]
            quiet()
            threads, got, fails = _fleet_drive(p, users, f["queries"],
                                               f["clients"], seed + 24)
            _join(threads, f"fleet {name} latency")
            check(not fails, f"fleet: {name} latency run failed {fails[:3]}")
            lat[name] = {"clients1": _lat([x * 1e3 for x in one]),
                         "clients8": _lat([x[3] * 1e3 for x in got])}
        gpu, how = _gpu_pids()
        router_pid = router.proc.pid
        check(router_pid not in gpu and all(p in gpu for p in
                                            spawned.values()),
              f"fleet: CUDA contexts ({how}) {sorted(gpu)}; router "
              f"{router_pid}, replicas {spawned}")
        report["steady"] = {
            "queries": f["queries"], "clients": f["clients"],
            "shares": share, "b2_launches": b2, "micro_batches": batches,
            **exact, "trace_in_router": len(in_router),
            "trace_replica": [r_ for r_, v in in_reps.items() if v],
            "http_ms": lat, "cuda_pids": how,
            "router_cuda_context": router_pid in gpu}
        log("fleet: leg 2 steady " + json.dumps(report["steady"]))

        # 3. autoscaling: a sustained breach grows, idleness drains ------
        quiet()
        stop_heavy, stop_trickle = threading.Event(), threading.Event()
        t_burn = time.perf_counter()
        heavy, heavy_out, heavy_fail = _fleet_drive(
            r_port, users, 4096, f["clients"], seed + 25, until=stop_heavy)
        stoppers.append(stop_heavy)
        doc = _wait(lambda: (lambda d: d if (d.get("autoscaler") or {})
                             .get("activeAction") else None)(fleet_status()),
                    "fleet: the sustained breach did not scale up",
                    timeout_s=120, step_s=0.2)
        action = doc["autoscaler"]["activeAction"]
        t_action = time.perf_counter()
        check(action["action"] == "scale_up" and action["to_replicas"]
              == f["replicas"] + 1, f"fleet: first action {action}")
        stop_heavy.set()
        _join(heavy, "fleet heavy load")
        trickle, trickle_out, trickle_fail = _fleet_drive(
            r_port, users, 64, 1, seed + 26, until=stop_trickle,
            pause_s=f["trickle_s"])
        stoppers.append(stop_trickle)
        _wait(lambda: healthy(f["replicas"] + 1), "fleet: the third replica "
              "was not healthy in time",
              timeout_s=SPAWN_HEALTHY_TIMEOUT_S + 30,
              step_s=0.2)
        grow_s = time.perf_counter() - t_action
        check(grow_s <= SPAWN_HEALTHY_TIMEOUT_S, f"fleet: the third "
              f"replica took {grow_s:.1f} s, over {SPAWN_HEALTHY_TIMEOUT_S} s")
        spawned = _spawned(router)
        third = max(spawned)
        gpu3, how3 = _gpu_pids()
        check(router_pid not in gpu3 and all(p in gpu3 for p in
                                             spawned.values()),
              f"fleet: CUDA contexts at 3 replicas {sorted(gpu3)}")
        rss = {r_: _rss_mb(p) for r_, p in spawned.items()}
        _wait(lambda: len(fleet_status()["replicas"]) == f["replicas"],
              "fleet: idleness did not drain the fleet back", timeout_s=120,
              step_s=0.2)
        drain_s = time.perf_counter() - t_action - grow_s
        history = work / "fleet_state" / "history"
        docs = _wait(lambda: (lambda d: d if len(d) == 2 else None)(
            [json.loads(p.read_text()) for p in history.glob("*.json")]),
            "fleet: the two actions were not archived", timeout_s=60)
        stop_trickle.set()
        _join(trickle, "fleet trickle")
        check(not heavy_fail and not trickle_fail,
              f"fleet: queries failed while scaling: {heavy_fail[:3]} "
              f"{trickle_fail[:3]}")
        check(sorted((d["action"], d["outcome"]) for d in docs)
              == [("scale_down", "done"), ("scale_up", "done")],
              f"fleet: archived actions {docs}")
        check(not (work / "fleet_state" / "action.json").exists(),
              "fleet: an action is still active")
        check(_wait(lambda: _gone(spawned[third]), "fleet: the drained "
                    "replica did not exit", timeout_s=30),
              "fleet: drained replica alive")
        report["autoscale"] = {
            "burn_to_action_s": t_action - t_burn,
            "grow_to_healthy_s": grow_s, "drain_s": drain_s,
            "heavy_queries": len(heavy_out),
            "trickle_queries": len(trickle_out), "failed": 0,
            "rss_mb_at_peak": rss, "cuda_pids": how3,
            "actions": [{k: d[k] for k in ("action", "outcome", "detail",
                                           "reason", "from_replicas",
                                           "to_replicas")} for d in docs]}
        del spawned[third]
        log("fleet: leg 2 autoscale " + json.dumps(report["autoscale"]))

        # 2. a fleet-sequenced cutover to v2, then a rollback -------------
        quiet()
        t0 = time.perf_counter()
        inst2 = instance(2)
        Storage.get_model_data_models().insert(Model(id=inst2.id,
                                                     models=blob2))
        rel2 = record_release(inst2, 0.0, blob2)
        del blob2
        report["v2_stored_s"] = time.perf_counter() - t0
        probes = _Prober(rep_port, r_port)
        status, out, cut_dt = rc.call("POST", "/deploy.json",
                                      {"releaseId": rel2.id})
        probes.stop()
        check(status == 200 and out["aborted"] is False
              and [r["replica"] for r in out["results"]]
              == sorted(rep_port), f"fleet: the cutover answered {status} "
              f"{str(out)[:500]}")
        V2_dev = torch.from_numpy(V2).to(DEV)
        picks = [str(users[i]) for i in np.random.default_rng(
            seed + 27).choice(len(users), f["cut_users"], replace=False)]
        for r_, p in rep_port.items():
            root = Client(p).call("GET", "/")[1]
            check(root["engineInstance"]["releaseVersion"] == 2,
                  f"fleet: replica {r_} serves {root['engineInstance']}")
        got = [(u, *_fleet_query(r_port, u)) for u in picks]
        exact2 = _exact_answers(U, V2_dev, index, got, "fleet v2")
        for r_, p in rep_port.items():
            for u, _, body, _ in got:
                _same_answers(body, _fleet_query(p, u)[1],
                              f"fleet v2 replica {r_} {u}")
        status, back, back_dt = rc.call("POST", "/rollback.json", {})
        check(status == 200 and back["aborted"] is False,
              f"fleet: the rollback answered {status} {str(back)[:500]}")
        for r_, p in rep_port.items():
            root = Client(p).call("GET", "/")[1]
            check(root["engineInstance"]["releaseVersion"] == 1,
                  f"fleet: replica {r_} serves {root['engineInstance']} "
                  "after the rollback")
        got = [(u, *_fleet_query(r_port, u)) for u in picks]
        exact1 = _exact_answers(U, V_dev, index, got, "fleet v1 again")
        del V2, V2_dev
        report["cutover"] = {
            "deploy_s": cut_dt, "rollback_s": back_dt,
            "prepare_s": {r["replica"]: r["response"].get("seconds")
                          for r in out["results"]},
            "prepare_split": {r["replica"]: r["response"].get("prepare")
                              for r in out["results"]},
            "v2": exact2, "v1_again": exact1, **probes.report()}
        log("fleet: leg 2 cutover " + json.dumps(report["cutover"]))

        # 4. a replica killed under traffic ------------------------------
        quiet()
        stop_kill = threading.Event()
        threads, kill_out, kill_fail = _fleet_drive(
            r_port, users, 4096, f["clients"], seed + 28, until=stop_kill)
        stoppers.append(stop_kill)
        time.sleep(f["kill_after_s"])
        victim = max(spawned)
        os.kill(spawned[victim], 9)
        t_kill = time.perf_counter()
        time.sleep(f["kill_s"])
        stop_kill.set()
        _join(threads, "fleet kill")
        check(not kill_fail, f"fleet: {len(kill_fail)} queries failed "
              f"across the kill: {kill_fail[:3]}")
        ejected = _wait(lambda: any(
            s["labels"]["replica"] == str(victim) and s["value"] == 0.0
            for s in _metric_samples(r_port, "pio_router_replica_healthy")),
            "fleet: the killed replica was not ejected", timeout_s=30)
        report["kill"] = {
            "replica": victim, "queries": len(kill_out), "failed": 0,
            "ejected": bool(ejected),
            "retries": sum(s["value"] for s in _metric_samples(
                r_port, "pio_router_retries_total")),
            "traffic_after_kill_s": f["kill_s"],
            "since_kill_s": time.perf_counter() - t_kill}
        log("fleet: leg 2 kill " + json.dumps(report["kill"]))
        report["b2_launches"] = sum(b2.values())
        router.stop()
        check(router.proc.returncode == 0, f"fleet: the router exited "
              f"{router.proc.returncode}")
        for r_, p in spawned.items():
            check(_wait(lambda p=p: _gone(p), f"fleet: replica {r_} "
                        "outlived the router", timeout_s=30), "")
        return report
    finally:
        for ev in stoppers:
            ev.set()
        if router is not None:
            router.stop()
            for line in router.history[-60:]:
                log("fleet: [router] " + line.rstrip())
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        return "State:\tZ" in pathlib.Path(
            f"/proc/{pid}/status").read_text()
    except OSError:
        return True


def _fleet_quiet(rc: "Client"):
    """A wait until no replica reports a burn (the SLO window has no
    traffic in it), so the autoscaler's sustain clock restarts between
    the leg's traffic bursts."""
    def quiet():
        time.sleep(FLEET["health_interval_s"])
        _wait(lambda: not rc.call("GET", "/slo.json")[1]["breached"],
              "fleet: the replicas' SLO burn did not clear", timeout_s=30,
              step_s=0.25)
    return quiet


class _Prober:
    """Probes each replica's ``/slo.json`` and ``/deploy/status.json``
    (the router's readiness surfaces) back to back on a thread, and the
    router's view of their health, while a cutover runs."""

    def __init__(self, rep_port: dict, r_port: int):
        self.times = {r_: [] for r_ in rep_port}
        self.unhealthy = set()
        self._stop = threading.Event()

        def probe(r_, p):
            c = Client(p)
            while not self._stop.is_set():
                for path in ("/slo.json", "/deploy/status.json"):
                    t0 = time.perf_counter()
                    try:
                        c.call("GET", path)
                    except Exception:   # noqa: BLE001 — timed as failed
                        c = Client(p)
                    self.times[r_].append(time.perf_counter() - t0)
                time.sleep(0.05)

        def watch():
            c = Client(r_port)
            while not self._stop.is_set():
                for r in c.call("GET", "/fleet/status.json")[1]["replicas"]:
                    if not r["healthy"]:
                        self.unhealthy.add(r["rank"])
                time.sleep(0.1)

        self._threads = [threading.Thread(target=probe, args=(r_, p),
                                          daemon=True)
                         for r_, p in rep_port.items()]
        self._threads.append(threading.Thread(target=watch, daemon=True))
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)

    def report(self) -> dict:
        import numpy as np

        return {"probe_max_ms": {r_: max(v) * 1e3 for r_, v in
                                 self.times.items() if v},
                "probe_p50_ms": {r_: float(np.median(v)) * 1e3 for r_, v in
                                 self.times.items() if v},
                "probes": {r_: len(v) for r_, v in self.times.items()},
                "probes_over_5s": sum(1 for v in self.times.values()
                                      for x in v if x > 5.0),
                "replicas_ejected_during_cutover": sorted(self.unhealthy)}


def orch_cli_worker() -> int:
    """``orchestrate`` through the port's CLI (``python3 -c "import
    chip_smoke; chip_smoke.orch_cli_worker()" orchestrate ...``), with
    the process's flight recorder and its kernel launch counts at each
    phase boundary written to ``CHIP_SMOKE_ORCH_DUMP`` on exit (the
    cycle's events live in this process only)."""
    sys.path.insert(0, str(ROOT))
    from predictionio_tpu_torch.cli.main import main as cli_main
    from predictionio_tpu_torch.obs import trace_context
    from predictionio_tpu_torch.ops import kernels

    rec = trace_context.recorder()
    marks = []
    record = rec.record_event

    def record_event(kind, detail=None, trace_id=None):
        out = record(kind, detail, trace_id)
        if kind == "orch_phase":
            marks.append({"phase": detail["phase"],
                          "status": detail["status"], "ts": out["ts"],
                          "launches": kernels.counts()})
        return out

    rec.record_event = record_event
    rc, raised = None, None
    try:
        rc = cli_main(sys.argv[1:])
        return rc
    except BaseException as e:
        raised = type(e).__name__
        raise
    finally:
        # temp-write + rename: the parent never reads a torn dump
        dump = os.environ["CHIP_SMOKE_ORCH_DUMP"]
        with open(dump + ".tmp", "w") as f:
            json.dump({"rc": rc, "raised": raised, "marks": marks,
                       "events": rec.events(), "traces": rec.traces()}, f)
        os.replace(dump + ".tmp", dump)


def _orchestrate(env, args, dump: pathlib.Path):
    """One ``orchestrate`` run through the CLI; (rc, stdout lines, the
    process's dump, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.orch_cli_worker())", "orchestrate", *args],
        cwd=str(ROOT), env=dict(env, CHIP_SMOKE_ORCH_DUMP=str(dump)),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log("fleet: [orchestrate] " + line)
    check(dump.exists(), f"fleet: orchestrate left no dump (rc "
          f"{proc.returncode}): {proc.stderr[-2000:]}")
    return proc.returncode, lines, json.loads(dump.read_text()), wall, \
        proc.stderr


def _phase_split(dump: dict) -> dict:
    """Each phase's wall and launches from the phase boundary marks."""
    out, start = {}, {}
    for m in dump["marks"]:
        if m["status"] == "start":
            start[m["phase"]] = m
        elif m["phase"] in start:
            s = start[m["phase"]]
            out[m["phase"]] = {
                "s": m["ts"] - s["ts"], "status": m["status"],
                "launches": {k: m["launches"][k] - s["launches"].get(k, 0)
                             for k in m["launches"]}}
    return out


def fleet_orchestrate_leg(seed: int) -> dict:
    """Leg 3: one orchestrated cycle through the CLI at the ML-100k
    shape, then a cycle killed at ``orch:canary:armed`` and the restart
    that converges (module docstring)."""
    import numpy as np

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.base import AccessKey, App
    from predictionio_tpu_torch.storage.registry import Storage

    c, o = ML100K, FLEET_ORCH
    work = WORK / "fleet_orch"
    env = smoke_store(work)
    env.update({
        "PIO_HOME": str(work / "home"), "PIO_SCORER_MODE": "twostage",
        "PIO_SCORER_SHORTLIST": str(SHORTLIST),
        "PIO_CANARY_PROMOTE_AFTER": str(o["canary_promote_after"]),
        "PIO_CANARY_MIN_SAMPLES": str(o["canary_min_samples"]),
        "PIO_CANARY_P99_RATIO": "20", "PIO_CANARY_LATENCY_SLACK_S": "1.0",
        "PIO_ORCH_CANARY_VERDICT_TIMEOUT_S": "180",
        "PIO_ORCH_PHASE_RETRIES": "0", "PIO_ORCH_COOLDOWN_S": "0",
        "PYTHONPATH": os.pathsep.join(
            [str(work)] + [p for p in [os.environ.get("PYTHONPATH")] if p])})
    report = {"card": card_line()}
    servers = []
    t_leg = time.perf_counter()
    try:
        t0 = time.perf_counter()
        app_id = Storage.get_meta_data_apps().insert(App(id=0,
                                                         name="OrchApp"))
        Storage.get_events().init_channel(app_id)
        key = Storage.get_meta_data_access_keys().insert(
            AccessKey(key="", appid=app_id, events=[]))
        users, items, ratings = synthetic_ratings(
            c["n_users"], c["n_items"], c["nnz"], seed=seed + 30)
        Storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": float(r)})
            for u, i, r in zip(users.tolist(), items.tolist(),
                               ratings.tolist())], app_id)
        report["events_written_s"] = time.perf_counter() - t0
        variant = work / "engine.json"
        variant.write_text(json.dumps({
            "id": "default", "engineFactory": RECOMMENDATION,
            "datasource": {"params": {"appName": "OrchApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": c["rank"], "numIterations": c["iters"],
                "lambda": c["reg"]}}]}))
        cl = EVAL_CLI
        (work / "smoke_eval.py").write_text(
            f"BEST = {str(work / 'best.json')!r}\nAPP = 'OrchApp'\n"
            f"FOLDS = {cl['folds']}\nITERS = {cl['iters']}\n" + _EVAL_MODULE)
        queries = work / "smoke_queries.jsonl"
        queries.write_text("".join(
            json.dumps({"user": f"u{u}", "num": 10}) + "\n"
            for u in range(o["smoke_queries"])))
        env["PIO_ORCH_SMOKE_QUERIES"] = str(queries)

        # the baseline: a train and a deploy through the CLI; the event
        # server for the fresh events comes up meanwhile
        events_srv = Server(["eventserver", "--ip", "127.0.0.1", "--port",
                             "0"], env, tag="fleet")
        servers.append(events_srv)
        t0 = time.perf_counter()
        line = json.loads(_cli(["train", "--variant", str(variant),
                                "--device", DEV], env)[-1])
        check(line["launches"]["spd_solve"] == 2 * c["iters"]
              and line["release"] == 1, f"fleet: baseline train {line}")
        rels = Storage.get_meta_data_releases()
        rel1 = rels.get_by_version(RECOMMENDATION, "1", "default", 1)
        rels.set_status(rel1.id, "LIVE", "baseline deploy")
        deploy = Server(["deploy", "--variant", str(variant), "--ip",
                         "127.0.0.1", "--port", "0", "--device", DEV], env,
                        tag="fleet")
        servers.append(deploy)
        q_port = deploy.wait_ready(timeout_s=300)
        es_port = events_srv.wait_ready(timeout_s=120)
        report["baseline_s"] = time.perf_counter() - t0
        qc = Client(q_port)
        sc = qc.call("GET", "/")[1]["scorer"][0]
        check(sc["activeMode"] == "twostage", f"fleet: the baseline "
              f"serves {sc['activeMode']}")
        state = work / "orch_state"
        common = ["--variant", str(variant), "--state-dir", str(state),
                  "--device", DEV]
        # the orchestrator's first look: no trigger, the watermark set
        rc, lines, _, wall0, err = _orchestrate(
            env, ["--once", *common], work / "dump0.json")
        check(rc == 0 and any("No trigger fired" in x for x in lines),
              f"fleet: the first orchestrate run (rc {rc}): {err[-1500:]}")

        # fresh events over REST past the ingest threshold
        rng = np.random.default_rng(seed + 31)
        fresh = _wire(rng.integers(0, c["n_users"], o["fresh_events"])
                      .tolist(), rng.integers(0, c["n_items"],
                                              o["fresh_events"]).tolist(),
                      rng.integers(1, 6, o["fresh_events"]).astype(float)
                      .tolist(), ["rate"] * o["fresh_events"])
        ids, _, _ = ingest(es_port, key, fresh)
        check(len(set(ids)) == o["fresh_events"], "fleet: fresh events lost")

        # the cycle: queries drive the canary once the server runs one
        canary = {}
        stop_q = threading.Event()

        def canary_traffic():
            sc_ = Client(q_port)
            while not stop_q.is_set():
                st = sc_.call("GET", "/deploy/status.json")[1]
                if st.get("canary"):
                    break
                time.sleep(0.05)
            if stop_q.is_set():
                return
            canary["root0"] = sc_.call("GET", "/")[1]
            canary["mj0"] = sc_.call("GET", "/metrics.json")[1]
            threads, out, fails = _fleet_drive(
                q_port, [f"u{u}" for u in range(c["n_users"])], 4096,
                o["canary_clients"], seed + 32, until=stop_q)
            while not stop_q.is_set():
                st = sc_.call("GET", "/deploy/status.json")[1]
                if not st.get("canary"):
                    canary["verdict_status"] = st
                    break
                canary["last_canary"] = st["canary"]
                time.sleep(0.05)
            stop_q.set()
            _join(threads, "fleet canary traffic")
            canary.update(queries=len(out), failures=fails,
                          root1=sc_.call("GET", "/")[1],
                          mj1=sc_.call("GET", "/metrics.json")[1])

        tq = threading.Thread(target=canary_traffic, daemon=True)
        tq.start()
        rc, lines, dump, wall1, err = _orchestrate(
            env, ["--once", "--server", f"127.0.0.1:{q_port}",
                  "--eval-class", "smoke_eval:evaluation", *common],
            work / "dump1.json")
        stop_q.set()
        tq.join(timeout=120)
        check(rc == 0 and any("(ingest_volume): promoted" in x
                              for x in lines),
              f"fleet: the cycle did not promote (rc {rc}): {lines[-5:]} "
              f"{err[-1500:]}")
        hist = [json.loads(p.read_text())
                for p in (state / "history").glob("*.json")]
        check(len(hist) == 1 and hist[0]["outcome"] == "promoted",
              f"fleet: cycle documents {hist}")
        doc = hist[0]
        trace_id = doc["trace"].split(":")[0]
        orch_events = [e for e in dump["events"]
                       if e["kind"].startswith("orch_")]
        check(orch_events and all(e.get("cycleId") == doc["cycle_id"]
                                  and e.get("traceId") == trace_id
                                  for e in orch_events),
              f"fleet: the cycle's orch_* events carry trace ids "
              f"{sorted({e.get('traceId') for e in orch_events})}")
        joined = {e["kind"] for e in dump["events"]
                  if e["kind"] in ("train_completed", "eval_completed")
                  and e.get("traceId") == trace_id}
        check(joined == {"train_completed", "eval_completed"},
              f"fleet: train/eval outside the cycle's trace: {joined}")
        split = _phase_split(dump)
        check(split["train"]["launches"].get("spd_solve") == 2 * c["iters"],
              f"fleet: the cycle's train launched B1 "
              f"{split['train']['launches']}")
        check(split["eval"]["launches"].get("spd_solve", 0) > 0,
              f"fleet: the eval gate launched B1 "
              f"{split['eval']['launches']}")
        check(split["smoke"]["launches"].get("shortlist", 0) > 0,
              f"fleet: the smoke scored without B2 "
              f"{split['smoke']['launches']}")
        check(not canary.get("failures") and "root1" in canary,
              f"fleet: canary traffic {canary.get('failures')}")

        def scored(mj):
            return sum(s["value"] for s in _metric(
                mj, "pio_scoring_batches_total")
                if s["labels"]["mode"] == "twostage")

        canary_b2 = canary["root1"]["kernelLaunches"]["shortlist"] \
            - canary["root0"]["kernelLaunches"]["shortlist"]
        canary_batches = scored(canary["mj1"]) - scored(canary["mj0"])
        check(canary_b2 == canary_batches > 0,
              f"fleet: the canary arms launched B2 {canary_b2} times for "
              f"{canary_batches} scored batches")
        cand = rels.get(doc["candidate_release_id"])
        check(cand.status == "LIVE" and rels.get(rel1.id).status
              == "RETIRED", f"fleet: after the promote v"
              f"{cand.version} {cand.status}, v1 {rels.get(rel1.id).status}")
        m2 = _stored_model(cand.instance_id)
        picks = [f"u{u}" for u in range(o["compare_users"])]
        err2, _ = check_top10(qc, m2, picks, "fleet promoted")
        report["cycle"] = {
            "cycle_id": doc["cycle_id"], "trigger": doc["trigger"],
            "outcome": doc["outcome"], "wall_s": wall1,
            "first_run_wall_s": wall0, "phases": split,
            "eval_score": doc["eval_score"], "smoke": doc["smoke"],
            "canary_reason": doc["canary_reason"],
            "canary_queries": canary["queries"],
            "canary_last": canary.get("last_canary"),
            "canary_b2_launches": canary_b2,
            "canary_scored_batches": canary_batches,
            "orch_events": len(orch_events), "trace_id": trace_id,
            "max_score_abs_err": err2}
        log("fleet: leg 3 cycle " + json.dumps(report["cycle"]))

        # the crash: a forced cycle killed once its canary is armed (the
        # registry plane), then a plain restart converges
        before = [qc.call("POST", "/queries.json", {"user": u, "num": 10})[1]
                  for u in picks]
        rc_kill, lines, dump2, wall2, err = _orchestrate(
            dict(env, PIO_FAULT_KILL="orch:canary:armed"),
            ["--once", "--force", *common], work / "dump2.json")
        check(rc_kill != 0 and dump2["raised"] == "CrashError",
              f"fleet: the killed cycle exited {rc_kill} "
              f"({dump2['raised']})")
        crashed = json.loads((state / "cycle.json").read_text())
        crashed_cand = rels.get(crashed["candidate_release_id"])
        check(crashed["phase"] == "canary" and crashed_cand.status
              == "CANARY", f"fleet: the killed cycle left {crashed['phase']}"
              f"/{crashed['phase_status']}, candidate {crashed_cand.status}")
        rc, lines, dump3, wall3, err = _orchestrate(
            env, ["--once", *common], work / "dump3.json")
        check(rc == 0 and any("Recovery: unwound" in x for x in lines),
              f"fleet: the restart did not unwind (rc {rc}): {lines[-5:]} "
              f"{err[-1500:]}")
        listing = rels.get_for_variant(RECOMMENDATION, "1", "default")
        statuses = {r.version: r.status for r in listing}
        check(sum(1 for s in statuses.values() if s == "LIVE") == 1
              and "CANARY" not in statuses.values()
              and statuses[cand.version] == "LIVE"
              and statuses[crashed_cand.version] == "ROLLED_BACK",
              f"fleet: after the restart the registry reads {statuses}")
        check(not (state / "cycle.json").exists(),
              "fleet: the crashed cycle is still active")
        after = [qc.call("POST", "/queries.json", {"user": u, "num": 10})[1]
                 for u in picks]
        check(after == before, "fleet: the served answers changed across "
              "the crashed cycle")
        report["crash"] = {
            "killed_at": "orch:canary:armed", "killed_rc": rc_kill,
            "killed_wall_s": wall2, "restart_wall_s": wall3,
            "killed_phases": _phase_split(dump2),
            "statuses": statuses, "answers_unchanged": True}
        log("fleet: leg 3 crash " + json.dumps(report["crash"]))
        report["b1_launches"] = split["train"]["launches"]["spd_solve"] \
            + split["eval"]["launches"]["spd_solve"]
        report["b2_launches"] = split["smoke"]["launches"]["shortlist"] \
            + canary_b2
        report["leg_s"] = time.perf_counter() - t_leg
        return report
    finally:
        for s in servers:
            s.stop()
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def served_blob(users, items, U, V) -> bytes:
    """The serve cell's model as a stored blob, serialized once for the
    phases that store it (fleet leg 2's v1, multitenant leg 2's
    tenants)."""
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    t0 = time.perf_counter()
    blob = serialize_models([ALSModel.from_arrays(users, items, U, V,
                                                  device="cpu")])
    log(f"fleet: the serve cell's model serialized once "
        f"({len(blob) / 1e6:.0f} MB) in {time.perf_counter() - t0:.3f} s")
    return blob


def fleet_phase(seed: int, users, items, U, V, blob: bytes,
                orchestrate: dict | None = None) -> dict:
    """The ``fleet`` phase: leg 2 on the serve cell's model, then leg 1,
    then leg 3 unless its report is given (the whole smoke runs it as a
    background leg)."""
    t0 = time.perf_counter()
    report = {"replicas": fleet_replicas_leg(seed, users, items, U, V,
                                             blob)}
    report["replicas"]["leg_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    report["router"] = fleet_router_leg()
    report["router"]["leg_s"] = time.perf_counter() - t1
    report["orchestrate"] = orchestrate or fleet_orchestrate_leg(seed)
    report["phase_s"] = time.perf_counter() - t0
    return report


#: leg 1 of the ``multitenant`` phase: the reference bench's
#: cfg_multitenant (bench.py:3139-3465), its widths, seed and protocol
MT_BENCH = dict(n_items=20_000, n_users=400, rank=64, seed=23, queries=300,
                passes=2, warm=16, baseline_warm=32, budget_fraction=0.8,
                p99_slack=1.15, batch_max=32, drain_s=10.0)
#: leg 2: two tenants over the serve cell's factors, alternating blocks
#: of ``block`` queries, the budget 1.2x the larger tenant's bytes
MT_WIDTH = dict(block=64, blocks=2, num=10, budget_factor=1.2,
                reload_wait_s=120.0)
#: an eviction frees the tenant's ledger bytes less this (the allocator
#: rounds each block up, and a freed tensor's block may be shared)
MT_FREE_SLACK = 1 << 20


def _mt_drive(client, path: str, mk_query, n: int, base: int = 0,
              lat=None, answers=None) -> None:
    """``n`` queries ``mk_query(base + i)`` one after another; each must
    answer 200."""
    for i in range(n):
        query = mk_query(base + i)
        status, body, dt = client.call("POST", path, query)
        check(status == 200, f"multitenant: {path} answered {status} "
              f"{body}")
        if lat is not None:
            lat.append(dt * 1e3)
        if answers is not None:
            answers.append((query, body))


def mt_bench_leg() -> dict:
    """Leg 1: the reference bench's three engine families, each first
    served alone, then consolidated behind one host under a budget of
    0.8x the standalone residencies' sum (module docstring)."""
    import numpy as np

    from predictionio_tpu_torch.core.engine import TrainResult
    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.engines import recommendation as rec_mod
    from predictionio_tpu_torch.engines import recommended_user as ru_mod
    from predictionio_tpu_torch.engines import similarproduct as sp_mod
    from predictionio_tpu_torch.engines.common import Item
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.server.multitenant import (
        MultiTenantServer, TenantSpec,
    )
    from predictionio_tpu_torch.server.query_server import QueryServer
    from predictionio_tpu_torch.storage.base import EngineInstance, Model
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import (
        DeployConfig, MultiTenantConfig, ScorerConfig,
    )
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    c = MT_BENCH
    n_items, n_users, rank = c["n_items"], c["n_users"], c["rank"]
    rng = np.random.default_rng(c["seed"])

    def ids(prefix, n):
        return np.sort(np.asarray([f"{prefix}{i:06d}" for i in range(n)],
                                  dtype=object))

    def unit_rows(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    # the bench's draws, in its order
    rec_model = ALSModel.from_arrays(
        ids("u", n_users), ids("i", n_items),
        rng.normal(size=(n_users, rank)).astype(np.float32),
        rng.normal(size=(n_items, rank)).astype(np.float32), device=DEV)
    sp_model = sp_mod.SimilarityModel(
        item_vocab=ids("i", n_items),
        V=unit_rows(rng.normal(size=(n_items, rank)).astype(np.float32)),
        items={i: Item(categories=None) for i in range(n_items)},
        device=DEV)
    ru_model = ru_mod.RecommendedUserModel(
        user_vocab=ids("u", n_items),
        V=unit_rows(rng.normal(size=(n_items, rank)).astype(np.float32)),
        users={}, device=DEV)
    tenants = [
        ("rec", rec_mod, rec_model,
         rec_mod.ALSAlgorithm(rec_mod.AlgorithmParams(rank=rank)),
         rec_mod.RecommendationServing(), ScorerConfig(mode="fused_int8"),
         lambda i: {"user": f"u{i % n_users:06d}", "num": 10}),
        ("sim", sp_mod, sp_model, sp_mod.ALSAlgorithm(),
         sp_mod.SimilarProductServing(), ScorerConfig(mode="fused_bf16"),
         lambda i: {"items": [f"i{i % n_items:06d}"], "num": 10}),
        ("social", ru_mod, ru_model, ru_mod.ALSAlgorithm(),
         ru_mod.RecommendedUserServing(), None,
         lambda i: {"users": [f"u{i % n_items:06d}"], "num": 10}),
    ]
    work = WORK / "multitenant_bench"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(work / "mt.db")}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"} for r in (
            "METADATA", "EVENTDATA", "MODELDATA")}})
    deploy_cfg = DeployConfig(warmup=False, drain_timeout_s=c["drain_s"])
    specs = {}
    for name, mod, model, algo, serving, scorer, _ in tenants:
        inst = EngineInstance(
            id=f"bench-mt-{name}", status="COMPLETED",
            engine_id="bench-multitenant", engine_version="1",
            engine_variant=name,
            data_source_params=json.dumps({"appName": f"{name}App"}),
            algorithms_params=json.dumps(
                [{"name": "als", "params": {"rank": rank}}]))
        Storage.get_meta_data_engine_instances().insert(inst)
        blob = serialize_models([model])
        Storage.get_model_data_models().insert(Model(id=inst.id,
                                                     models=blob))
        specs[name] = TenantSpec(
            name=name, engine=mod.engine(),
            train_result=TrainResult(models=[model], algorithms=[algo],
                                     serving=serving,
                                     engine_params=EngineParams()),
            instance=inst, release=record_release(inst, 0.0, blob),
            scorer_config=scorer, deploy_config=deploy_cfg,
            max_batch=c["batch_max"], linger_s=0.0)
    del rec_model, sp_model, ru_model
    report = {"card": card_line(), "items": n_items, "rank": rank,
              "users": n_users, "queries_per_tenant": c["queries"],
              "p99_slack": c["p99_slack"]}
    lt = _LoopThread()
    try:
        # standalone baselines: one tenant's server at a time (its own
        # config stamped on its holders, as a tenant's is)
        base_p50, base_p99, standalone = {}, {}, {}
        for name, *_, mk in tenants:
            spec = specs[name]
            server = QueryServer(
                spec.engine, spec.train_result, spec.instance,
                scorer_config=spec.scorer_config, release=spec.release,
                deploy_config=deploy_cfg, max_batch=c["batch_max"],
                linger_s=0.0, pin_process_scorer=False)
            client = Client(lt.run(server.start("127.0.0.1", 0)))
            try:
                _mt_drive(client, "/queries.json", mk, c["baseline_warm"])
                lat = []
                gc.collect()
                gc.disable()
                try:
                    _mt_drive(client, "/queries.json", mk, c["queries"],
                              base=c["baseline_warm"], lat=lat)
                finally:
                    gc.enable()
                base_p50[name] = float(np.percentile(lat, 50))
                base_p99[name] = float(np.percentile(lat, 99))
                standalone[name] = server.warm_bytes
            finally:
                lt.run(server.close())
        total = sum(standalone.values())
        check(total > 0, f"multitenant: no standalone residency "
              f"{standalone}")
        budget = int(c["budget_fraction"] * total)
        host = MultiTenantServer(list(specs.values()), config=(
            MultiTenantConfig(budget_bytes=budget, reload_wait_s=30.0,
                              sweep_interval_s=3600.0, min_resident=1,
                              admission=False)))
        client = Client(lt.run(host.start("127.0.0.1", 0)))
        lat = {t[0]: [] for t in tenants}
        try:
            for p in range(c["passes"]):
                for name, *_, mk in tenants:
                    path = f"/t/{name}/queries.json"
                    # untimed: the first is the miss that reloads
                    _mt_drive(client, path, mk, c["warm"],
                              base=100_000 + p * c["warm"])
                    gc.collect()
                    gc.disable()
                    try:
                        _mt_drive(client, path, mk, c["queries"],
                                  base=p * c["queries"], lat=lat[name])
                    finally:
                        gc.enable()
                    lt.run(host.enforce_budget())
                    check(host.resident_bytes() <= budget,
                          f"multitenant: {host.resident_bytes()} resident "
                          f"bytes over the budget {budget}")
            any_server = next(iter(host.tenants.values())).server
            report.update({
                "standalone_resident_bytes": standalone,
                "standalone_total": total, "budget_bytes": budget,
                "evictions": int(any_server._evict_total.value(
                    reason="budget")),
                "warm_reloads": int(any_server._reload_total.value(
                    status="warm_reload")),
                "resident_bytes_end": host.resident_bytes(),
                "resident_tenants_end": sorted(
                    t.name for t in host.tenants.values()
                    if t.server.resident),
                "baseline_p50_ms": base_p50, "baseline_p99_ms": base_p99,
                "consolidated_p50_ms": {
                    k: float(np.percentile(v, 50)) for k, v in lat.items()},
                "consolidated_p99_ms": {
                    k: float(np.percentile(v, 99)) for k, v in lat.items()}})
        finally:
            lt.run(host.close())
        # the bench's gates 1 and 2; its p99 parity (gate 3) is reported
        check(report["evictions"] > 0 and report["warm_reloads"] > 0,
              f"multitenant: the cycle did not turn: {report['evictions']} "
              f"evictions, {report['warm_reloads']} warm reloads")
        check(report["resident_bytes_end"] <= budget < total,
              f"multitenant: end residency {report['resident_bytes_end']}"
              f", budget {budget}, standalone sum {total}")
        report["p99_ratio"] = {
            k: report["consolidated_p99_ms"][k] / base_p99[k]
            for k in base_p99}
        return report
    finally:
        lt.stop()
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def mt_width_leg(seed: int, users, items, U, V, blob: bytes) -> dict:
    """Leg 2: two tenants over the serve cell's 10M x 64 factors, one
    through B2 (twostage) and one fused int8, under a budget that holds
    one of them (module docstring)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.server.multitenant import (
        MultiTenantServer, TenantSpec,
    )
    from predictionio_tpu_torch.storage.base import EngineInstance, Model
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import (
        DeployConfig, MultiTenantConfig, ScorerConfig,
    )

    w = MT_WIDTH
    n_items, rank = V.shape
    work = WORK / "multitenant"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(work / "pio.db")},
                    "FS": {"TYPE": "localfs", "PATH": str(work / "models")}},
        "repositories": {
            "METADATA": {"NAME": "pio", "SOURCE": "DB"},
            "EVENTDATA": {"NAME": "pio", "SOURCE": "DB"},
            "MODELDATA": {"NAME": "pio", "SOURCE": "FS"}}})
    scorers = {
        "rec": ScorerConfig(mode="twostage", tile_items=TILE,
                            shortlist=SHORTLIST),
        "rec8": ScorerConfig(mode="fused_int8", tile_items=TILE)}
    report = {"card": card_line(), "items": n_items, "rank": rank,
              "users": len(users), "block": w["block"],
              "scorers": {k: v.mode for k, v in scorers.items()}}
    t0 = time.perf_counter()
    # one stored instance and release, served by both tenants (as two
    # --tenant flags naming one variant are)
    inst = EngineInstance(
        id="mt-serve", status="COMPLETED", engine_id=RECOMMENDATION,
        engine_version="1", engine_variant="multitenant",
        data_source_params=json.dumps({"appName": "MTApp"}),
        algorithms_params=json.dumps(
            [{"name": "als", "params": {"rank": rank}}]))
    Storage.get_meta_data_engine_instances().insert(inst)
    Storage.get_model_data_models().insert(Model(id=inst.id, models=blob))
    release = record_release(inst, 0.0, blob)
    eng = engine()
    specs = [TenantSpec(
        name=name, engine=eng,
        train_result=eng.prepare_deploy(
            default_engine_params("MTApp", rank=rank),
            [ALSModel.from_arrays(users, items, U, V, device=DEV)]),
        instance=inst, release=release, scorer_config=cfg,
        deploy_config=DeployConfig(warmup=False, drain_timeout_s=10.0))
        for name, cfg in scorers.items()]
    report["stored_s"] = time.perf_counter() - t0
    host = MultiTenantServer(specs, config=MultiTenantConfig(
        budget_bytes=0, reload_wait_s=w["reload_wait_s"],
        sweep_interval_s=3600.0, min_resident=1, admission=False))
    del specs
    evictions, reloads = [], []
    pre_evict_bytes = {}

    def watch(name):
        """Measure each eviction of tenant ``name`` wherever the host
        makes it: the allocator's live bytes before and after, beside
        the ledger's bytes of what it evicts."""
        server = host.tenants[name].server
        evict = server.evict_to_warm

        async def measured(reason="budget"):
            ledger = server.warm_bytes
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t_e = time.perf_counter()
            ok = await evict(reason)
            ms = (time.perf_counter() - t_e) * 1e3
            torch.cuda.synchronize()
            freed = before - torch.cuda.memory_allocated()
            if ok:
                pre_evict_bytes[name] = ledger
                evictions.append({"tenant": name, "reason": reason,
                                  "ledger_bytes": ledger,
                                  "freed_bytes": freed, "ms": ms})
                check(freed >= ledger - MT_FREE_SLACK,
                      f"multitenant: evicting {name} freed {freed} bytes "
                      f"of the card, its ledger says {ledger}")
            return ok

        server.evict_to_warm = measured

    for name in scorers:
        watch(name)
    lt = _LoopThread()
    client = Client(lt.run(host.start("127.0.0.1", 0)))
    rng = np.random.default_rng(seed + 13)
    picks = [str(users[i]) for i in rng.choice(len(users), w["block"],
                                                replace=False)]
    answers = {name: [] for name in scorers}
    steady = {name: [] for name in scorers}
    blocks = []

    def resident_total() -> float:
        _, mj, _ = client.call("GET", "/metrics.json")
        return _metric(mj, "pio_mt_resident_bytes_total")[0]["value"]

    def block(name: str, b: int) -> None:
        server = host.tenants[name].server
        was_resident = server.resident
        n_evicted = len(evictions)
        c0 = kernels.counts()["shortlist"]
        path = f"/t/{name}/queries.json"
        status, first, first_dt = client.call(
            "POST", path, {"user": picks[0], "num": w["num"]})
        check(status == 200, f"multitenant: {name}'s first query of block "
              f"{b} answered {status} {first}")
        c1 = kernels.counts()["shortlist"]
        n0 = sum(server._unit.batcher.batch_sizes.values())
        got = [({"user": picks[0]}, first)]
        _mt_drive(client, path, lambda i: {"user": picks[i],
                                           "num": w["num"]},
                  w["block"] - 1, base=1, lat=steady[name], answers=got)
        c2 = kernels.counts()["shortlist"]
        batches = sum(server._unit.batcher.batch_sizes.values()) - n0
        want = batches if scorers[name].mode == "twostage" else 0
        check(c2 - c1 == want, f"multitenant: {name} launched B2 "
              f"{c2 - c1} times for {batches} micro-batches")
        if not was_resident:
            reloads.append({"tenant": name, "block": b,
                            **server.last_warm_reload})
            check(server.warm_bytes == pre_evict_bytes[name],
                  f"multitenant: {name} reloaded to {server.warm_bytes} "
                  f"bytes, {pre_evict_bytes[name]} before its eviction")
        lt.run(host.enforce_budget())
        total = resident_total()
        check(host.config.budget_bytes == 0
              or total <= host.config.budget_bytes,
              f"multitenant: {total} resident bytes over the budget "
              f"{host.config.budget_bytes}")
        answers[name].append(got)
        blocks.append({"tenant": name, "block": b,
                       "was_resident": was_resident,
                       "first_query_ms": first_dt * 1e3,
                       "first_query_b2": c1 - c0,
                       "b2_launches": c2 - c1, "micro_batches": batches,
                       "evictions_in_block": len(evictions) - n_evicted,
                       "resident_bytes_total": total})

    try:
        kernels.reset_counts()
        t_traffic = time.perf_counter()
        block("rec", 1)
        block("rec8", 1)
        sizes = {n: host.tenants[n].server.warm_bytes for n in scorers}
        budget = int(w["budget_factor"] * max(sizes.values()))
        check(sum(sizes.values()) > budget,
              f"multitenant: both tenants ({sizes}) fit the budget "
              f"{budget}")
        host.config.budget_bytes = budget
        log(f"multitenant: ledger bytes {sizes}, budget {budget}")
        lt.run(host.enforce_budget())
        check(resident_total() <= budget, "multitenant: the sweep left "
              "the tenants over the budget")
        block("rec", 2)
        block("rec8", 2)
        report["b2_launches"] = kernels.counts()["shortlist"]
        report["traffic_s"] = time.perf_counter() - t_traffic
        report.update({"ledger_bytes": sizes, "budget_bytes": budget,
                       "blocks": blocks, "evictions": evictions,
                       "warm_reloads": reloads})
        check({e["tenant"] for e in evictions} == set(scorers)
              and {r["tenant"] for r in reloads} == set(scorers),
              f"multitenant: evicted {[e['tenant'] for e in evictions]}, "
              f"reloaded {[r['tenant'] for r in reloads]}")
        for name in scorers:
            first, second = answers[name]
            identical = 0
            for (q, a), (_, b) in zip(first, second):
                _same_answers(b, a, f"multitenant {name} {q['user']} "
                              "across the eviction")
                identical += a == b
            report.setdefault("identical_across_eviction", {})[name] = \
                identical
            report.setdefault("steady", {})[name] = _lat(steady[name])
    finally:
        lt.run(host.close())
        lt.stop()
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)
    del host
    gc.collect()
    index = {str(u): i for i, u in enumerate(users)}
    V_dev = torch.from_numpy(V).to(DEV)
    try:
        flat = [(q["user"], 200, body) for blk in answers["rec"]
                for q, body in blk]
        report["rec_exact"] = _exact_answers(U, V_dev, index, flat,
                                             "multitenant rec")
        # not gated: int8 over-fetches 4k and rescores in f32
        flat = [(q["user"], 200, body) for blk in answers["rec8"]
                for q, body in blk]
        try:
            report["rec8_exact"] = _exact_answers(U, V_dev, index, flat,
                                                  "multitenant rec8")
        except SmokeFailure as e:
            report["rec8_exact"] = {"not_gated": str(e)}
    finally:
        del V_dev
        torch.cuda.empty_cache()
    return report


_MT_CLI_CHILD = r"""
import http.client, json, os, signal, sys, threading, time

variant, port, device = sys.argv[1], int(sys.argv[2]), sys.argv[3]
users = sys.argv[4].split(",")
result = {}

def call(method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t0 = time.perf_counter()
    c.request(method, path, body=None if body is None else json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read()), time.perf_counter() - t0

def drive():
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            try:
                call("GET", "/")
                break
            except OSError:
                time.sleep(0.1)
        result["up_s"] = time.perf_counter() - T0
        result["queries"] = {
            t: [call("POST", f"/t/{t}/queries.json", {"user": u, "num": 10})
                for u in users] for t in ("ml100k-a", "ml100k-b")}
        result["tenants"] = call("GET", "/tenants.json")
        result["residency"] = call("GET", "/residency.json")
        result["status"] = {t: call("GET", f"/t/{t}/deploy/status.json")
                            for t in ("ml100k-a", "ml100k-b")}
        result["bad"] = sorted(
            m for m in sys.modules
            if any(m == t or m.startswith(t + ".")
                   for t in ("jax", "predictionio_tpu")))
    finally:
        os.kill(os.getpid(), signal.SIGTERM)

T0 = time.perf_counter()
threading.Thread(target=drive, daemon=True).start()
from predictionio_tpu_torch.cli.main import main
result["rc"] = main(["multiserve", "--tenant", f"ml100k-a={variant}",
                     "--tenant", f"ml100k-b={variant}", "--ip", "127.0.0.1",
                     "--port", str(port), "--device", device])
print("MT-RESULT " + json.dumps(result), flush=True)
"""


def multiserve_cli_leg(env, work, variant, model, instance_id: str) -> dict:
    """Leg 3, inside the lifecycle on its latest release: ``pio
    multiserve`` in its own process with two tenants of the ML-100k
    variant; one query a tenant per user through ``/t/NAME/
    queries.json`` (each the exact top-10 of ``model``), the host's
    documents and each tenant's ``deploy/status.json`` through the
    mount; the process's ``sys.modules`` holds neither jax nor the
    reference."""
    import numpy as np

    home = work / "mt_home"
    home.mkdir(parents=True, exist_ok=True)
    picks = [str(u) for u in np.asarray(model.user_vocab)[:3]]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _MT_CLI_CHILD, str(variant),
         str(_free_ports(1)), DEV, ",".join(picks)],
        cwd=str(ROOT), env=dict(env, PIO_HOME=str(home)),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    line = next((x for x in out.stdout.splitlines()
                 if x.startswith("MT-RESULT ")), None)
    check(out.returncode == 0 and line is not None,
          f"multiserve: rc {out.returncode}: {out.stdout[-1500:]} "
          f"{out.stderr[-2500:]}")
    res = json.loads(line.split(" ", 1)[1])
    check(res["rc"] == 0 and res["bad"] == [],
          f"multiserve: rc {res['rc']}, modules {res['bad'][:5]}")
    max_err = 0.0
    U, V = _factors_on_card(model, "multiserve")
    for tenant, calls in res["queries"].items():
        for user, (status, body, _dt) in zip(picks, calls):
            check(status == 200, f"multiserve: {tenant} answered {status}")
            max_err = max(max_err, _top10_err(
                U, V, model, user, body, f"multiserve {tenant}"))
    status, doc, _ = res["tenants"]
    check(status == 200 and [(t["tenant"], t["resident"],
                              t["engineInstanceId"]) for t in doc["tenants"]]
          == [("ml100k-a", True, instance_id), ("ml100k-b", True,
                                                instance_id)],
          f"multiserve: /tenants.json {status} {doc}")
    check(res["residency"][0] == 200, "multiserve: /residency.json "
          f"answered {res['residency'][0]}")
    for tenant, (status, doc, _) in res["status"].items():
        check(status == 200 and doc["resident"] is True
              and doc["active"]["engineInstanceId"] == instance_id,
              f"multiserve: /t/{tenant}/deploy/status.json {status} {doc}")
    return {"wall_s": wall, "up_s": res["up_s"], "max_score_abs_err":
            max_err, "query_ms": [c[2] * 1e3 for calls in
                                  res["queries"].values() for c in calls],
            "modules_clean": True}


def multitenant_phase(seed: int, users, items, U, V, blob: bytes,
                      cli: dict) -> dict:
    """The ``multitenant`` phase: leg 2 on the serve cell's model (its
    blob ``blob``), then leg 1; leg 3 ran inside the lifecycle
    (``cli``)."""
    t0 = time.perf_counter()
    report = {"width": mt_width_leg(seed, users, items, U, V, blob)}
    report["width"]["leg_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    report["bench"] = mt_bench_leg()
    report["bench"]["leg_s"] = time.perf_counter() - t1
    report["cli"] = cli
    report["phase_s"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# classify phase
# ---------------------------------------------------------------------------

#: leg 1: the reference bench's naive_bayes_spam (bench.py:247-255,
#: :712-738): documents x vocabulary of Poisson counts, seed 3, 40% spam;
#: train and predict best of ``reps``; accuracy above ``min_accuracy``
#: (the bench's assert); log_prior / log_prob within ``tol`` of the
#: float64 numpy recompute (bench.py:258-269)
NB_SPAM = dict(n_docs=20_000, vocab=2_000, seed=3, spam=0.4, reps=3,
               min_accuracy=0.9, tol=1e-5)
#: leg 2, on the same corpus: the template's logistic regression and
#: random forest (auto: ceil(sqrt(2000)) = 45 features a node), the
#: forest's node arrays held to the CPU fit on the first
#: ``forest_check_docs`` documents, logreg's W and b to the CPU run on
#: the first ``logreg_check_docs``
CLS_WIDTH = dict(
    logreg=dict(iterations=200, learning_rate=0.1, reg=1e-4, seed=0),
    forest=dict(num_trees=10, max_depth=4, max_bins=32,
                feature_subset_strategy="auto", impurity="gini", seed=0),
    forest_check_docs=4_000, logreg_check_docs=20_000, reps=3)
#: logreg on the card against the port's CPU run from the same initial W:
#: |dW|, |db| <= LOGREG_TOL * max(1, max |W|), the CPU test's tolerance
#: (tests/test_torch_classification.py)
LOGREG_TOL = 1e-4
#: leg 3: the template through the CLI on the classification_app law of
#: tests/test_engines.py:129-145 at ``users`` users; ``queries`` queries
#: a deployed variant; ``pio eval`` with eval_k folds
CLS_CLI = dict(users=10_000, seed=5, queries=200, eval_k=3)
CLS_ALGOS = ("naive", "logreg", "randomforest")
CLS_ATTRS = ("attr0", "attr1", "attr2")

#: runs the port's CLI in this interpreter (``python -c _CHECKED_CLI
#: ARGS`` is ``python -m predictionio_tpu_torch.cli.main ARGS``), then
#: prints the jax or reference modules the process held as its last line
_CHECKED_CLI = r"""
import json, sys
from predictionio_tpu_torch.cli.main import main
try:
    rc = main(sys.argv[1:])
finally:
    print("modules: " + json.dumps(sorted(
        m for m in sys.modules
        if any(m == t or m.startswith(t + ".")
               for t in ("jax", "predictionio_tpu")))), flush=True)
sys.exit(rc)
"""


def forbidden_modules(lines, what: str) -> None:
    """The ``_CHECKED_CLI`` line of a process's output must name no
    module."""
    found = [x for x in lines if x.startswith("modules: ")]
    check(bool(found), f"{what}: no modules line")
    mods = json.loads(found[-1][len("modules: "):])
    check(mods == [], f"{what} loaded {mods[:5]}")


def nb_spam_data():
    """bench.py's _nb_data: (X [N, V] float32 counts, labels)."""
    import numpy as np

    c = NB_SPAM
    rng = np.random.default_rng(c["seed"])
    labels = np.where(rng.random(c["n_docs"]) < c["spam"], "spam", "ham")
    X = rng.poisson(
        np.where((labels == "spam")[:, None],
                 rng.random(c["vocab"]) * 2.0, rng.random(c["vocab"]) * 1.2)
    ).astype(np.float32)
    return X, labels


def plain_row(name: str, ms: float, nbytes: float, ops: float,
              shape: dict) -> dict:
    """A plain-PyTorch computation's time beside its bound: the larger of
    its bytes (each input read once, each output written once) over HBM
    and its operations over the f32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return {"name": name, "ms": ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops, "shape": shape}


def _best_wall(fn, reps: int):
    """(best seconds of ``reps`` calls of ``fn``, its last result); the
    card is synchronised around each call."""
    best, out = float("inf"), None
    for _ in range(reps):
        synchronize()
        t0 = time.perf_counter()
        out = fn()
        synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def classify_nb_leg():
    """Leg 1: multinomial NB at the spam width, the device branch."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import naive_bayes
    from predictionio_tpu_torch.ops import device_cache
    from predictionio_tpu_torch.utils.profiling import collect_phases

    c = NB_SPAM
    t_leg = time.perf_counter()
    X, labels = nb_spam_data()
    device_cache.clear()
    phases = {}
    synchronize()
    t0 = time.perf_counter()
    with collect_phases(phases):      # the cold call: compact + upload
        model = naive_bayes.train_multinomial_nb(X, labels, device=DEV)
        pred = model.predict(X)
    synchronize()
    cold_s = time.perf_counter() - t0
    check(model.branches == {"train_device": 1, "predict_device": 1},
          f"NB at {X.shape}: branches {dict(model.branches)}, expected "
          "the device branch for the train and the predict")
    train_s, model = _best_wall(
        lambda: naive_bayes.train_multinomial_nb(X, labels, device=DEV),
        c["reps"])
    check(model.branches == {"train_device": 1},
          f"NB: the timed train took {dict(model.branches)}")
    predict_s, pred = _best_wall(lambda: model.predict(X), c["reps"])
    check(model.branches["predict_device"] == c["reps"],
          f"NB: the timed predicts took {dict(model.branches)}")
    acc = float((pred == labels).mean())
    check(acc > c["min_accuracy"], f"NB accuracy {acc}")
    # the float64 recompute of bench.py's base_naive_bayes
    vocab, codes = np.unique(labels, return_inverse=True)
    counts = np.stack([X[codes == k].sum(0, dtype=np.float64)
                       for k in range(len(vocab))])
    prior = np.log(np.bincount(codes) / len(labels))
    prob = np.log((counts + 1.0) / (counts + 1.0).sum(1, keepdims=True))
    err = max(float(np.abs(model.log_prior - prior).max()),
              float(np.abs(model.log_prob - prob).max()))
    check(list(model.label_vocab) == list(vocab) and err <= c["tol"],
          f"NB: log_prior/log_prob {err} from the float64 recompute")
    # the host branch on the same values (a copy: not resident)
    saved = naive_bayes.DEVICE_MIN_SIZE
    naive_bayes.DEVICE_MIN_SIZE = X.size + 1
    try:
        X_host = X.copy()
        host = naive_bayes.train_multinomial_nb(X_host, labels, device=DEV)
        host_pred = host.predict(X_host)
    finally:
        naive_bayes.DEVICE_MIN_SIZE = saved
    check(host.branches == {"train_host_gemm": 1, "predict_host": 1},
          f"NB host side took {dict(host.branches)}")
    check(bool((host_pred == pred).all()), "NB: the device branch's labels "
          f"differ from the host branch's at "
          f"{int((host_pred != pred).sum())} documents")
    # the two device products alone, on the resident X
    dev = torch.device(DEV)
    resident = naive_bayes.resident_x(X, model.device)
    codes_d = torch.from_numpy(codes.astype(np.int64)).to(model.device)
    lp, pri = model.params_on(model.device)
    n, v, n_labels = X.shape[0], X.shape[1], len(vocab)
    count_ms = cuda_ms(lambda: naive_bayes.count_product(
        resident, codes_d, n_labels), 20)
    score_ms = cuda_ms(lambda: naive_bayes.score_product(
        resident, lp, pri), 20)
    xbytes = resident[0].numel() * resident[0].element_size()
    rows = [plain_row("nb_count_product", count_ms,
                      xbytes + n * 8 + n_labels * v * 4,
                      2 * n_labels * n * v,
                      {"N": n, "F": v, "L": n_labels,
                       "x_dtype": str(resident[0].dtype)}),
            plain_row("nb_score_product", score_ms,
                      xbytes + n_labels * v * 4 + n_labels * 4
                      + n * n_labels * 4, 2 * n * v * n_labels,
                      {"N": n, "F": v, "L": n_labels,
                       "x_dtype": str(resident[0].dtype)})]
    del resident, codes_d
    device_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    report = {"shape": list(X.shape), "device": str(dev),
              "accuracy": acc, "train_s": train_s, "predict_s": predict_s,
              "cold_s": cold_s,
              "compact_s": phases.get("nb_compact", 0.0),
              "transfer_s": phases.get("nb_transfer", 0.0),
              "x_dtype": str(naive_bayes._compact_for_transfer(X).dtype),
              "max_param_err": err, "rows": rows,
              "leg_s": time.perf_counter() - t_leg}
    log("classify: nb " + json.dumps(report))
    return report


def forest_walk(m, X):
    """A forest's class codes for X, in numpy: host binning, the
    lockstep walk of every tree, the vote (ties to the lowest code)."""
    import numpy as np

    xq = np.stack([np.searchsorted(m.thresholds[j], X[:, j], side="left")
                   for j in range(X.shape[1])], 1)
    n = len(X)
    node = np.zeros((m.feat.shape[0], n), np.int64)
    cols = np.arange(n)[None, :]
    for d in range(m.max_depth):
        idx = 2 ** d - 1 + node
        f = np.take_along_axis(m.feat, idx, 1)
        t = np.take_along_axis(m.thr, idx, 1)
        node = node * 2 + (xq[cols, f] > t)
    pred = np.take_along_axis(m.leaf.astype(np.int64), node, 1)
    votes = np.zeros((n, len(m.classes)), np.int64)
    for row in pred:
        np.add.at(votes, (cols[0], row), 1)
    return np.argmax(votes, 1)


def classify_width_leg():
    """Leg 2: logistic regression and the forest at the spam width on
    the card, each held to the port's CPU run."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import forest, logreg

    c = CLS_WIDTH
    t_leg = time.perf_counter()
    X, labels = nb_spam_data()
    n, v = X.shape
    lp = logreg.LogRegParams(**c["logreg"])
    init = logreg.initial_W(v, 2, lp.seed)
    synchronize()
    t0 = time.perf_counter()
    lr = logreg.train_logreg(X, labels, lp, device=DEV, init_W=init)
    fit_s = time.perf_counter() - t0
    lr_acc = float((lr.predict(X) == labels).mean())
    upload_s, _ = _best_wall(lambda: logreg.train_logreg(
        X, labels, logreg.LogRegParams(**dict(c["logreg"], iterations=0)),
        device=DEV, init_W=init), c["reps"])
    steps_s, _ = _best_wall(lambda: logreg.train_logreg(
        X, labels, lp, device=DEV, init_W=init), c["reps"])
    step_ms = (steps_s - upload_s) / lp.iterations * 1e3
    k = c["logreg_check_docs"]
    t0 = time.perf_counter()
    cpu = logreg.train_logreg(X[:k], labels[:k], lp, device="cpu",
                              init_W=init)
    cpu_s = time.perf_counter() - t0
    card = lr if k == n else logreg.train_logreg(
        X[:k], labels[:k], lp, device=DEV, init_W=init)
    scale = max(1.0, float(np.abs(cpu.W).max()))
    lr_err = max(float(np.abs(card.W - cpu.W).max()),
                 float(np.abs(card.b - cpu.b).max()))
    check(lr_err <= LOGREG_TOL * scale, f"logreg on the card: W/b "
          f"{lr_err} from the CPU run (tolerance {LOGREG_TOL * scale})")
    logreg_row = plain_row(
        "logreg_adam_step", step_ms, n * v * 4 + n * 8 + 4 * (v * 2 + 2),
        2 * (2 * n * v * 2), {"N": n, "F": v, "L": 2})

    fp = forest.ForestParams(**c["forest"])
    levels = []
    synchronize()
    t0 = time.perf_counter()
    fm = forest.train_forest(X, labels, fp, device=DEV, timings=levels)
    forest_fit_s = time.perf_counter() - t0
    predict_s, codes = _best_wall(lambda: fm.predict_codes(X), c["reps"])
    f_acc = float((fm.classes[codes] == labels).mean())
    walk = forest_walk(fm, X)
    check(bool((walk == codes).all()), f"forest: the card's votes differ "
          f"from a numpy walk of its trees at {int((walk != codes).sum())}"
          " documents")
    k = c["forest_check_docs"]
    t0 = time.perf_counter()
    f_cpu = forest.train_forest(X[:k], labels[:k], fp, device="cpu")
    forest_cpu_s = time.perf_counter() - t0
    f_card = forest.train_forest(X[:k], labels[:k], fp, device=DEV)
    for field in ("thresholds", "feat", "thr", "leaf"):
        check(np.array_equal(getattr(f_card, field), getattr(f_cpu, field)),
              f"forest: the card's {field} differ from the CPU fit's on "
              f"{k} documents")
    # one level's histogram alone at the deepest level's shape (node ids
    # drawn uniformly over the level's 8 nodes)
    xq = fm.binize(X)                  # the fit's own bins
    boot, _ = forest.draw_bags(n, v, fp)
    width = 2 ** (fp.max_depth - 1)
    g = torch.Generator().manual_seed(1)
    dev = fm._on_device()[0].device
    xq_d = torch.from_numpy(xq.astype(np.uint8)).to(dev)
    y_d = torch.from_numpy(np.unique(labels, return_inverse=True)[1]
                           .astype(np.int64)).to(dev)
    boot_d = torch.from_numpy(boot.astype(np.int64)).to(dev)
    node_d = torch.randint(0, width, boot.shape, generator=g).to(dev)
    hist_ms = cuda_ms(lambda: forest._level_histogram(
        xq_d, y_d, boot_d, node_d, width, fp.max_bins, 2), 5)
    t_all = fp.num_trees
    cells = t_all * width * v * fp.max_bins * 2
    hist_row = plain_row(
        "forest_level_histogram", hist_ms,
        n * v + n * 8 + 2 * t_all * n * 8 + cells * 8, t_all * n * v,
        {"T": t_all, "N": n, "F": v, "B": fp.max_bins, "C": 2,
         "width": width})
    del xq_d, y_d, boot_d, node_d
    gc.collect()
    torch.cuda.empty_cache()
    report = {
        "logreg": {"fit_s": fit_s, "accuracy": lr_acc, "step_ms": step_ms,
                   "upload_s": upload_s,
                   "cpu_check_docs": c["logreg_check_docs"], "cpu_s": cpu_s,
                   "max_abs_err": lr_err, "tolerance": LOGREG_TOL * scale},
        "forest": {"fit_s": forest_fit_s, "predict_s": predict_s,
                   "accuracy": f_acc, "level_histogram_s": levels,
                   "cpu_check_docs": c["forest_check_docs"],
                   "cpu_fit_s": forest_cpu_s,
                   "features_a_node": int(forest._subset_size(
                       fp.feature_subset_strategy, v))},
        "rows": [logreg_row, hist_row],
        "leg_s": time.perf_counter() - t_leg}
    log("classify: width " + json.dumps(report))
    return report


def cls_recompute(m, X):
    """The labels a stored classifier gives the rows of X, in numpy."""
    import numpy as np

    kind = type(m).__name__
    if kind == "MultinomialNBModel":
        return m.label_vocab[np.argmax(
            X @ m.log_prob.T + m.log_prior[None, :], 1)]
    if kind == "LogRegModel":
        return m.label_vocab[np.argmax(X @ m.W + m.b, 1)]
    return m.classes[forest_walk(m, X)]


_CLS_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.classification import (
    Accuracy, DataSourceParams, default_engine_params, engine,
)

evaluation = Evaluation(engine=engine(), metric=Accuracy(), output_path=BEST)
evaluation.engine_params_list = [EngineParams(
    data_source_params=DataSourceParams(app_name=APP, eval_k=EVAL_K),
    algorithm_params_list=default_engine_params(
        APP, a).algorithm_params_list) for a in ALGOS]
"""


def classify_cli_leg(seed: int):
    """Leg 3: the classification template through the CLI: events over
    the event server, ``template get``, three trains at once, three
    deploys and one ``eval`` at once; every process's modules checked."""
    import numpy as np

    from predictionio_tpu_torch.data.ingest import aggregate_scan
    from predictionio_tpu_torch.obs.registry import default_registry

    c = CLS_CLI
    work = WORK / "classify"
    env = smoke_store(work)
    env = dict(env, PIO_HOME=str(work / "home"), PYTHONPATH=os.pathsep.join(
        [str(work), str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    app = "ClsApp"
    servers = []
    eval_proc = None
    t_leg = time.perf_counter()
    try:
        events_srv = Server(["eventserver", "--ip", "127.0.0.1", "--port",
                             "0"], env, tag="classify")
        servers.append(events_srv)
        es_port = events_srv.wait_ready(timeout_s=120)
        out = _cli(["app", "new", app], env)
        key = next(x for x in out if "Access Key:" in x).split()[-1]
        rng = np.random.default_rng(c["seed"])
        wire = []
        for i in range(c["users"]):
            a0 = float(rng.integers(0, 8))
            a1 = float(rng.integers(0, 8))
            a2 = float(rng.integers(0, 4))
            wire.append({"event": "$set", "entityType": "user",
                         "entityId": f"u{i}", "properties": {
                             "plan": 1.0 if a0 > a1 else 0.0, "attr0": a0,
                             "attr1": a1, "attr2": a2}})
        _ids, ingest_lat, ingest_s = ingest(es_port, key, wire)
        out = _cli(["template", "get", "classification",
                    str(work / "tpl")], env)
        template = json.loads((work / "tpl" / "engine.json").read_text())
        check(template["algorithms"][0]["name"] == "naive",
              f"template get classification: {template}")
        variants = {}
        for algo in CLS_ALGOS:
            variants[algo] = work / f"{algo}.json"
            variants[algo].write_text(json.dumps(dict(
                template, id=algo,
                engineFactory=reference_factory("classification"),
                datasource={"params": {"appName": app}},
                algorithms=[{"name": algo, "params": {}}])))

        # the eval and the three trains at once (the eval reads the
        # store only)
        t0 = time.perf_counter()
        best = work / "best.json"
        (work / "cls_eval.py").write_text(
            f"BEST = {str(best)!r}\nAPP = {app!r}\n"
            f"EVAL_K = {c['eval_k']}\nALGOS = {CLS_ALGOS!r}\n"
            + _CLS_EVAL_MODULE)
        # its output to files: nothing reads it until the queries end
        # pio: ignore[PIO002]: the eval child's stdout log in scratch
        fo = open(work / "eval.out", "w")
        # pio: ignore[PIO002]: the eval child's stderr log in scratch
        fe = open(work / "eval.err", "w")
        with fo, fe:
            eval_proc = subprocess.Popen(
                [sys.executable, "-c", _CHECKED_CLI, "eval",
                 "cls_eval:evaluation", "--device", DEV], cwd=str(ROOT),
                env=env, stdout=fo, stderr=fe)
        procs = {a: subprocess.Popen(
            [sys.executable, "-c", _CHECKED_CLI, "train", "--variant",
             str(variants[a]), "--device", DEV], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for a in CLS_ALGOS}
        trains = {}
        for a, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"classify: train {a} exited "
                  f"{proc.returncode}: {out[-1000:]} {err[-2000:]}")
            lines = out.strip().splitlines()
            forbidden_modules(lines, f"classify: the {a} train")
            trains[a] = json.loads(lines[-2])
        trains_s = time.perf_counter() - t0
        log("classify: trains " + json.dumps(trains))
        check(trains["naive"]["labels"] == 2
              and trains["randomforest"]["trees"] == 10,
              f"classify: trained {[trains[a]['models'] for a in trains]}")
        models = {a: _stored_models(trains[a]["instance"])[0]
                  for a in CLS_ALGOS}

        # three deploys at once
        t1 = time.perf_counter()
        # each deploy its own PIO_HOME (its telemetry store)
        deploys = {a: Server(["deploy", "--variant", str(variants[a]),
                              "--ip", "127.0.0.1", "--port", "0",
                              "--device", DEV],
                             dict(env, PIO_HOME=str(work / f"home-{a}")),
                             tag=f"classify {a}", checked=True)
                   for a in CLS_ALGOS}
        servers.extend(deploys.values())
        ports = {a: srv.wait_ready(timeout_s=300)
                 for a, srv in deploys.items()}
        deploy_s = time.perf_counter() - t1
        qrng = np.random.default_rng(seed + 70)
        Q = np.stack([qrng.integers(0, 8, c["queries"]),
                      qrng.integers(0, 8, c["queries"]),
                      qrng.integers(0, 4, c["queries"])], 1).astype(
            np.float32)
        answered = {}
        for a in CLS_ALGOS:
            want = [float(x) for x in cls_recompute(models[a], Q)]
            client = Client(ports[a])
            lat = []
            for q, w in zip(Q.tolist(), want):
                status, body, dt = client.call(
                    "POST", "/queries.json", dict(zip(CLS_ATTRS, q)))
                check(status == 200 and body == {"label": w},
                      f"classify: {a} answered {status} {body} to {q}, "
                      f"the stored model says {w}")
                lat.append(dt * 1e3)
            status, _, _ = client.call("POST", "/stop")
            check(status == 200 and deploys[a].proc.wait(timeout=60) == 0,
                  f"classify: the {a} deploy did not stop")
            answered[a] = {"latency": _lat(lat),
                           "labels": sorted(set(want))}
        for a, srv in deploys.items():
            while srv.lines.get(timeout=30) != "":
                pass
            forbidden_modules([x.rstrip() for x in srv.history],
                              f"classify: the {a} deploy")
        eval_proc.wait(timeout=600)
        out = (work / "eval.out").read_text()
        err = (work / "eval.err").read_text()
        check(eval_proc.returncode == 0, f"classify: eval exited "
              f"{eval_proc.returncode}: {out[-1000:]} {err[-2000:]}")
        lines = out.strip().splitlines()
        forbidden_modules(lines, "classify: the eval")
        evaluated = json.loads(lines[-2])
        scores = [s for s, _ in evaluated["scores"]]
        check(evaluated["candidates"] == 3 and all(0 < s <= 1
                                                   for s in scores)
              and scores[1] > 0.85 and best.exists(),
              f"classify: eval scores {scores}")
        cli_s = time.perf_counter() - t0

        # this process: an unchanged app hits the scan cache, a new
        # event misses it
        reg = default_registry()

        def cache_counts():
            return tuple(
                (reg.get(f"pio_ingest_cache_{k}_total").value(app=app)
                 if reg.get(f"pio_ingest_cache_{k}_total") is not None
                 and reg.get(f"pio_ingest_cache_{k}_total").contains(
                     app=app) else 0.0) for k in ("hits", "misses"))

        required = ["plan", *CLS_ATTRS]
        c0 = cache_counts()
        first = aggregate_scan(app, "user", required=required)
        c1 = cache_counts()
        again = aggregate_scan(app, "user", required=required)
        c2 = cache_counts()
        check(c1[1] - c0[1] == 1 and c2[0] - c1[0] == 1
              and c2[1] == c1[1] and set(again) == set(first),
              f"classify: scan cache counts {c0} {c1} {c2}")
        status, _, _ = Client(es_port).call(
            "POST", f"/events.json?accessKey={key}",
            {"event": "$set", "entityType": "user",
             "entityId": f"u{c['users']}", "properties": {
                 "plan": 1.0, "attr0": 5.0, "attr1": 1.0, "attr2": 0.0}})
        check(status == 201, f"classify: one more event answered {status}")
        after = aggregate_scan(app, "user", required=required)
        c3 = cache_counts()
        check(c3[1] - c2[1] == 1 and c3[0] == c2[0]
              and len(after) == len(first) + 1,
              f"classify: after one more event {c2} -> {c3}, "
              f"{len(after)} users")
        report = {"users": c["users"], "ingest_s": ingest_s,
                  "ingest_latency": _lat(ingest_lat), "trains": trains,
                  "trains_s": trains_s, "deploys_up_s": deploy_s,
                  "answered": answered, "eval": evaluated,
                  "trains_deploys_queries_eval_s": cli_s,
                  "scan_cache": {"smoke": {"before": c0, "first": c1,
                                           "again": c2, "after_event": c3},
                                 "eval": evaluated["ingest"]},
                  "leg_s": time.perf_counter() - t_leg}
        log("classify: cli " + json.dumps(report))
        return report
    finally:
        for srv in servers:
            srv.stop()
        if eval_proc is not None and eval_proc.poll() is None:
            eval_proc.kill()
            eval_proc.wait()
        from predictionio_tpu_torch.storage.registry import Storage

        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def classify_phase(seed: int) -> dict:
    """The ``classify`` phase: NB at the spam width (leg 1), logistic
    regression and the forest on the same corpus (leg 2), the template
    through the CLI (leg 3)."""
    from predictionio_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_counts()
    report = {"nb": classify_nb_leg(), "width": classify_width_leg()}
    report["cli"] = classify_cli_leg(seed)
    report["launches"] = kernels.counts()
    report["rows"] = report["nb"]["rows"] + report["width"]["rows"]
    report["phase_s"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# sessionrec phase
# ---------------------------------------------------------------------------

#: leg 1: the catalog of ML-20M as BERT4Rec uses it (Sun et al. 2019:
#: 138,493 users x 26,744 items), sessions of ``session_len`` items (the
#: one cut: ML-20M's histories run longer, and ``pad_sessions`` keeps the
#: last max_len + 1 of them) drawn from a planted law: the next item is
#: the current one + 1 (mod the catalog) with probability ``p_next``,
#: else a Zipf(``zipf``)-popular one; ``queries`` served next-item
#: queries of ``num``, ``timed_steps`` steps timed alone and
#: ``profiled_steps`` under the profiler
SESSIONREC = dict(n_users=138_493, n_items=26_744, session_len=(2, 64),
                  p_next=0.8, zipf=1.1, queries=1_000, num=10,
                  timed_steps=50, profiled_steps=10)
#: the template's widths (the reference's scaffold,
#: predictionio_tpu/cli/main.py:1873-1877, and SeqRecParams' defaults),
#: epochs cut from 10 to 1: the leg alone took 97.4 s at 10 epochs, 66.1
#: s at 4 and 78.9 s at 3 on the card, past its 60 s (the step is host
#: bound: 6.1-15.4 ms with the host's speed, an epoch of 1,081 steps
#: 7.1-15.5 s)
SR_PARAMS = dict(d_model=64, n_heads=2, n_layers=2, max_len=32,
                 batch_size=128, learning_rate=1e-3, seed=7, epochs=1)
#: the card's first step against the port's CPU run of it: the loss
#: relative, every gradient in relative Frobenius norm
SR_LOSS_TOL = 1e-5
SR_GRAD_TOL = 1e-4
#: served next-item scores against the CPU model's, absolute; ids equal
#: except among scores within this of each other
SR_SERVE_TOL = 1e-4
#: leg 2: the template through the CLI on a fresh store: ``users`` users,
#: each with ``views`` views along a cyclic ``n_items``-item catalog,
#: ``queries`` queries of a user's last ``recent`` views; the learned
#: successor in the top 10 of at least ``min_hit`` of them
SESSIONREC_CLI = dict(users=2_000, views=(5, 30), n_items=200, queries=200,
                      recent=3, min_hit=0.5)


def planted_sessions(seed: int):
    """Leg 1's sessions, item ids ``i00000``.. (sorted as their codes),
    and the catalog's ids."""
    import numpy as np

    c = SESSIONREC
    rng = np.random.default_rng(seed + 150)
    n, users = c["n_items"], c["n_users"]
    pop = 1.0 / np.arange(1, n + 1) ** c["zipf"]
    pop = pop[rng.permutation(n)]
    cdf = np.cumsum(pop / pop.sum())
    lo, hi = c["session_len"]
    lens = rng.integers(lo, hi + 1, size=users)
    seqs = np.empty((users, hi), np.int64)
    seqs[:, 0] = np.searchsorted(cdf, rng.random(users))
    for j in range(1, hi):
        draw = np.minimum(np.searchsorted(cdf, rng.random(users)), n - 1)
        seqs[:, j] = np.where(rng.random(users) < c["p_next"],
                              (seqs[:, j - 1] + 1) % n, draw)
    names = np.asarray([f"i{k:05d}" for k in range(n)], dtype=object)
    return [names[seqs[u, :lens[u]]].tolist() for u in range(users)], names


def sr_masked_row(model, recent):
    """The CPU recompute of a query: the ``[V]`` next-item scores of
    ``model`` with the reference's masks (pad id, vocabulary padding,
    every seen item) at -inf, float64; None without a known item."""
    import numpy as np

    codes = [c for it in recent if (c := model.item_code(it)) is not None]
    if not codes:
        return None
    row = model.next_logits(codes).astype(np.float64)
    row[0] = -np.inf
    row[len(model.item_vocab) + 1:] = -np.inf
    row[np.asarray(codes)] = -np.inf
    return row


def sr_same(got, row, model, num: int, tag: str) -> float:
    """Served ``[(item, score)]`` against a recompute row: as many answers
    as finite scores (at most num), distinct known items, each served
    score within SR_SERVE_TOL of the best scores in order and of the
    row's score of its own item (ids equal up to near-ties). Returns the
    largest error."""
    import numpy as np

    if row is None:
        check(got == [], f"{tag}: {got[:3]} for no known item")
        return 0.0
    best = np.sort(row[np.isfinite(row)])[::-1][:num]
    check(len(got) == len(best), f"{tag}: {len(got)} answers, "
          f"{len(best)} expected")
    codes = [model.item_code(i) for i, _ in got]
    check(None not in codes and len(set(codes)) == len(codes),
          f"{tag}: unknown or repeated items {got[:5]}")
    served = np.asarray([s for _, s in got], np.float64)
    err = np.maximum(np.abs(served - best), np.abs(served - row[codes]))
    check(bool((err <= SR_SERVE_TOL).all()),
          f"{tag}: served {got[:4]}, best {best[:4].tolist()}")
    return float(err.max()) if len(err) else 0.0


def sr_step_bound(b: int, l: int, d: int, v: int) -> dict:
    """A train step's bound: the three V-wide products (logits, their
    gradients into the hidden states and into the embedding) at 2 b l d v
    operations each, and the ``[b l, v]`` f32 logits written, read and
    their gradient written."""
    ops = 6.0 * b * l * d * v
    nbytes = 3.0 * b * l * v * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return {"ms": max(by_bytes, by_ops), "operations": ops, "bytes": nbytes,
            "by": "bytes" if by_bytes >= by_ops else "operations"}


def sr_serve_bound(params: dict, l: int, v: int, d: int,
                   n_layers: int) -> dict:
    """A query's bound: every parameter read once and the ``[v]`` row
    written, against the forward's and the row's operations."""
    nbytes = sum(a.nbytes for a in params.values()) + l * 8 + v * 4
    ops = 2.0 * v * d + 2.0 * l * n_layers * (12 * d * d + 2 * l * d)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return {"ms": max(by_bytes, by_ops), "operations": ops, "bytes": nbytes,
            "by": "bytes" if by_bytes >= by_ops else "operations"}


def sr_first_step(sessions, p):
    """The first step of a train on the card and on the CPU from the same
    init and batch: the loss relative and each gradient's relative
    Frobenius distance. Returns the report and the padded ``(inputs,
    targets)``."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import seqrec

    vocab, inputs, targets = seqrec.encode_sessions(sessions, p.max_len)
    state = seqrec._flatten(seqrec.init_params(
        np.random.default_rng(p.seed), len(vocab), p))
    idx = seqrec.epoch_order(len(inputs), p, 0)[
        :min(p.batch_size, len(inputs))]
    out = {}
    for dev in (DEV, "cpu"):
        net = seqrec.SeqRecNet.from_state(state, p.n_heads,
                                          torch.device(dev))
        loss = seqrec._loss_fn(
            net, torch.from_numpy(inputs[idx].astype(np.int64)).to(dev),
            torch.from_numpy(targets[idx].astype(np.int64)).to(dev))
        loss.backward()
        out[dev] = (float(loss.detach()),
                    {k: prm.grad.detach().cpu().numpy()
                     for k, prm in net.named_parameters()})
    (loss_c, g_c), (loss_h, g_h) = out[DEV], out["cpu"]
    grads = {k: _rel(g_c[k], g_h[k]) for k in g_h}
    report = {"loss_card": loss_c, "loss_cpu": loss_h,
              "loss_rel": abs(loss_c - loss_h) / abs(loss_h),
              "grad_rel_max": max(grads.values()),
              "grad_rel_by_param": grads, "n_vocab": len(vocab) + 1,
              "sessions": len(inputs)}
    check(report["loss_rel"] <= SR_LOSS_TOL,
          f"sessionrec: first-step loss {loss_c} on the card, {loss_h} on "
          f"the CPU")
    check(report["grad_rel_max"] <= SR_GRAD_TOL,
          f"sessionrec: first-step gradients {grads}")
    return report, (inputs, targets)


def sr_step_times(model, padded, p) -> dict:
    """A step timed alone (a fresh net from the trained weights, the
    run's batches): ms on the host clock synchronised and by CUDA events
    over ``timed_steps`` steps; then ``profiled_steps`` steps under the
    profiler: the top device ops, the device's busy ms and idle share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models import seqrec

    c = SESSIONREC
    inputs, targets = padded
    order = seqrec.epoch_order(len(inputs), p, 0)
    n = c["timed_steps"] + c["profiled_steps"] + 5
    idx = torch.from_numpy(order[:n * p.batch_size].reshape(n, -1)).to(DEV)
    x = torch.from_numpy(inputs.astype(np.int64)).to(DEV)
    y = torch.from_numpy(targets.astype(np.int64)).to(DEV)
    net = seqrec.SeqRecNet.from_state(model.params, p.n_heads,
                                      torch.device(DEV))
    step = seqrec.make_train_step(net, seqrec.make_optimizer(net, p), p)
    for i in range(5):
        step(x[idx[i]], y[idx[i]])
    k = c["timed_steps"]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(5, 5 + k):
        step(x[idx[i]], y[idx[i]])
    end.record()
    synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / k
    event_ms = start.elapsed_time(end) / k
    j = c["profiled_steps"]
    synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5 + k, 5 + k + j):
            step(x[idx[i]], y[idx[i]])
        synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in cuda) / 1e3
    by_name: dict = {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"step_ms_host": host_ms, "step_ms_events": event_ms,
            "timed_steps": k, "profiled_steps": j,
            "profiled_wall_ms_a_step": wall / j,
            "device_busy_ms_a_step": busy / j if busy else None,
            "idle_share": 1.0 - busy / wall if busy else None,
            "device_ops_a_step": len(cuda) / j,
            "top_device_ops_ms_a_step": [(name, ms / j) for name, ms in top]}


def sessionrec_width_leg(seed: int) -> dict:
    """Leg 1: the template's model at full width over the ML-20M-shaped
    catalog: the first step held to the CPU's, 10 epochs of training,
    1,000 served queries held to the CPU model's, the step's times and
    profile beside its bound."""
    import numpy as np

    from predictionio_tpu_torch.models import seqrec

    t_leg = time.perf_counter()
    c = SESSIONREC
    p = seqrec.SeqRecParams(**SR_PARAMS)
    t0 = time.perf_counter()
    sessions, names = planted_sessions(seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, padded = sr_first_step(sessions, p)
    first["seconds"] = time.perf_counter() - t0
    check(first["n_vocab"] == c["n_items"] + 1,
          f"sessionrec: vocabulary of {first['n_vocab']} rows")
    losses, epochs = [], []
    synchronize()
    t0 = time.perf_counter()
    model = seqrec.train_seqrec(None, sessions, p, device=DEV,
                                losses=losses, timings=epochs)
    synchronize()
    train_s = time.perf_counter() - t0
    per_epoch = len(losses) // p.epochs
    first10 = float(np.mean(losses[:10]))
    last_epoch = float(np.mean(losses[-per_epoch:]))
    check(per_epoch == first["sessions"] // p.batch_size,
          f"sessionrec: {per_epoch} steps an epoch")
    check(np.isfinite(losses).all() and last_epoch < first10,
          f"sessionrec: last epoch's loss {last_epoch}, first 10 steps' "
          f"{first10}")

    # serving: the card-trained model against the CPU model of its arrays
    cpu = seqrec.SeqRecModel(item_vocab=model.item_vocab,
                             params=model.params, hyper=p, device="cpu")
    qrng = np.random.default_rng(seed + 151)
    users = qrng.choice(len(sessions), size=c["queries"], replace=False)
    for u in users[:5]:                 # warm-up, not timed
        model.recommend_next(sessions[u], c["num"])
    lat, err, hits = [], 0.0, 0
    t_serve = time.perf_counter()
    for u in users:
        s = sessions[u]
        recent = s[:int(qrng.integers(1, len(s)))]
        t0 = time.perf_counter()
        got = model.recommend_next(recent, c["num"])
        lat.append((time.perf_counter() - t0) * 1e3)
        err = max(err, sr_same(got, sr_masked_row(cpu, recent), cpu,
                               c["num"], f"sessionrec: query {u}"))
        succ = names[(int(recent[-1][1:]) + 1) % c["n_items"]]
        hits += succ in {i for i, _ in got}
    serve_s = time.perf_counter() - t_serve
    t0 = time.perf_counter()
    times = sr_step_times(model, padded, p)
    times["seconds"] = time.perf_counter() - t0
    b, l, d, v = p.batch_size, p.max_len, p.d_model, first["n_vocab"]
    report = {
        "shape": {"users": c["n_users"], "items": c["n_items"], "V": v,
                  "events": int(sum(len(s) for s in sessions)),
                  "session_len": c["session_len"], **SR_PARAMS},
        "sessions_s": gen_s, "first_step": first,
        "train_s": train_s, "epoch_s": epochs, "steps_an_epoch": per_epoch,
        "loss_first10": first10, "loss_last_epoch": last_epoch,
        "loss_by_epoch": [float(np.mean(losses[e * per_epoch:
                                               (e + 1) * per_epoch]))
                          for e in range(p.epochs)],
        **times,
        "step_bound": sr_step_bound(b, l, d, v),
        "serve": {"queries": len(users), "latency": _lat(lat),
                  "seconds_with_cpu_recompute": serve_s,
                  "max_err": err, "hit_at_10": hits / len(users),
                  "bound": sr_serve_bound(model.params, l, v, d,
                                          p.n_layers)},
        "device_bytes": model.device_bytes(),
        "leg_s": time.perf_counter() - t_leg}
    log("sessionrec: width " + json.dumps(report))
    return report


def sessionrec_cli_leg(seed: int, port: int, work) -> dict:
    """Leg 2: the sessionrec template through the CLI on a fresh store:
    views over the event server, ``template get sessionrec``, ``train``
    and ``deploy`` (the engine.json naming the reference's factory
    string), 200 queries over HTTP each equal to the stored model's
    answer on the CPU, the learned successor's hits; no jax or reference
    module in the train or the deploy."""
    import datetime as dt

    import numpy as np

    from predictionio_tpu_torch.workflow.serialization import (
        deserialize_models,
    )

    c = SESSIONREC_CLI
    env = dict(smoke_store(work), PIO_HOME=str(work / "home"))
    app = "SessApp"
    servers = []
    t_leg = time.perf_counter()
    try:
        events_srv = Server(["eventserver", "--ip", "127.0.0.1", "--port",
                             "0"], env, tag="sessionrec")
        servers.append(events_srv)
        es_port = events_srv.wait_ready(timeout_s=120)
        out = _cli(["app", "new", app], env)
        key = next(x for x in out if "Access Key:" in x).split()[-1]
        rng = np.random.default_rng(seed + 152)
        base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
        sessions, wire = [], []
        for u in range(c["users"]):
            start = int(rng.integers(0, c["n_items"]))
            s = [f"i{(start + j) % c['n_items']}"
                 for j in range(int(rng.integers(c["views"][0],
                                                 c["views"][1] + 1)))]
            sessions.append(s)
            wire += [{"event": "view", "entityType": "user",
                      "entityId": f"u{u}", "targetEntityType": "item",
                      "targetEntityId": it, "eventTime": (
                          base + dt.timedelta(seconds=u * 100 + j)
                      ).isoformat()} for j, it in enumerate(s)]
        _ids, ingest_lat, ingest_s = ingest(es_port, key, wire)
        _cli(["template", "get", "sessionrec", str(work / "tpl")], env)
        template = json.loads((work / "tpl" / "engine.json").read_text())
        check(template["algorithms"][0]["name"] == "seqrec",
              f"template get sessionrec: {template}")
        variant = work / "engine.json"
        variant.write_text(json.dumps(dict(
            template, engineFactory=reference_factory("sessionrec"),
            datasource={"params": {"appName": app}})))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _CHECKED_CLI, "train", "--variant",
             str(variant), "--device", DEV], cwd=str(ROOT), env=env,
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"sessionrec: train exited "
              f"{proc.returncode}: {proc.stdout[-1000:]} "
              f"{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        forbidden_modules(lines, "sessionrec: the train")
        train = json.loads(lines[-2])
        train["wall_s"] = time.perf_counter() - t0
        check(train["items"] == c["n_items"] and train["d_model"] == 64
              and not any(train["launches"].values()),
              f"sessionrec: train {train}")
        from predictionio_tpu_torch.storage.registry import Storage

        blob = Storage.get_model_data_models().get(train["instance"])
        check(blob is not None, "sessionrec: no model blob stored")
        model = deserialize_models(blob.models, device="cpu")[0]

        t1 = time.perf_counter()
        deploy = Server(["deploy", "--variant", str(variant), "--ip",
                         "127.0.0.1", "--port", "0", "--device", DEV],
                        env, tag="sessionrec deploy", checked=True)
        servers.append(deploy)
        client = Client(deploy.wait_ready(timeout_s=300))
        deploy_s = time.perf_counter() - t1
        qrng = np.random.default_rng(seed + 153)
        lat, err, hits = [], 0.0, 0
        for u in qrng.choice(c["users"], size=c["queries"], replace=False):
            recent = sessions[u][-c["recent"]:]
            status, body, dt_s = client.call(
                "POST", "/queries.json", {"items": recent, "num": 10})
            check(status == 200 and set(body) == {"itemScores"},
                  f"sessionrec: {status} {body}")
            got = [(x["item"], x["score"]) for x in body["itemScores"]]
            err = max(err, sr_same(got, sr_masked_row(model, recent), model,
                                   10, f"sessionrec: cli query u{u}"))
            lat.append(dt_s * 1e3)
            succ = f"i{(int(recent[-1][1:]) + 1) % c['n_items']}"
            hits += succ in {i for i, _ in got}
        _, root, _ = client.call("GET", "/")
        check(not any(root["kernelLaunches"].values()),
              f"sessionrec: the deploy launched {root['kernelLaunches']}")
        status, _, _ = client.call("POST", "/stop")
        check(status == 200 and deploy.proc.wait(timeout=60) == 0,
              "sessionrec: the deploy did not stop")
        while deploy.lines.get(timeout=30) != "":
            pass
        forbidden_modules([x.rstrip() for x in deploy.history],
                          "sessionrec: the deploy")
        check(hits >= c["min_hit"] * c["queries"],
              f"sessionrec: the successor in {hits} of {c['queries']} "
              f"top-10s")
        report = {"users": c["users"], "events": len(wire),
                  "ingest_s": ingest_s, "ingest_latency": _lat(ingest_lat),
                  "train": train, "deploy_up_s": deploy_s,
                  "queries": c["queries"], "latency": _lat(lat),
                  "max_err": err, "hit_at_10": hits / c["queries"],
                  "deploy_launches": root["kernelLaunches"],
                  "leg_s": time.perf_counter() - t_leg}
        log("sessionrec: cli " + json.dumps(report))
        return report
    finally:
        for srv in servers:
            srv.stop()
        from predictionio_tpu_torch.storage.registry import Storage

        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def sessionrec_phase(seed: int, cli: dict) -> dict:
    """The ``sessionrec`` phase: leg 1 in this process, its launch counts
    zeroed just before and read just after; leg 2's report (run in a
    process of its own) beside it."""
    from predictionio_tpu_torch.ops import kernels

    kernels.reset_counts()
    report = {"width": sessionrec_width_leg(seed)}
    report["launches"] = kernels.counts()
    check(not any(report["launches"].values()),
          f"sessionrec: launched {report['launches']}")
    report["cli"] = cli
    return report


def sessionrec_launches(report: dict, kernel: str) -> int:
    """A kernel's launches in the sessionrec phase: leg 1's (this
    process) and leg 2's train and deploy processes'."""
    cli = report["cli"]
    return (report["launches"][kernel] + cli["train"]["launches"][kernel]
            + cli["deploy_launches"][kernel])


#: the reference bench's ingest_write partition curve (bench.py:1783-1866):
#: 8,192 events submitted open loop in batches of 256 with 24 outstanding,
#: a 30 ms commit wall injected into every insert_batch, 1, 2 and 4 commit
#: lanes, best of 2 at each, and the bench's scaling floor at 4 over 1
LT_CURVE = dict(events=8192, batch=256, outstanding=24, flush_max=256,
                linger_s=0.004, queue_max=1 << 20, commit_ms=30.0,
                partitions=(1, 2, 4), best_of=2, min_scaling=2.5)
#: cfg_loadtest's leg 1 (bench.py:3040-3077): the sustained storm
LT_STORM = dict(population=200_000, items=20_000, duration_s=24.0,
                rate=400.0, amplitude=0.5, seed=7, replicas=2,
                partitions=2, outstanding=256, retrain_at=0.4,
                p99_ms=2000.0)
#: B1 launches of one of the fleet's trains: its engine.json trains ALS
#: for 3 iterations, one launch a half-sweep
LT_TRAIN_LAUNCHES = 6
#: the fleet's app (LocalFleet's first app) and its training read (the
#: recommendation engine's scan shape)
LT_APP = "loadtest"
LT_SCAN = dict(entity_type="user", event_names=["rate", "buy"],
               target_entity_type="item", ordered=False,
               columns=("event", "entity_id", "target_entity_id",
                        "properties"))


def _curve_point(parts: int, rnd: int) -> dict:
    """One open-loop drive of the curve against ``parts`` commit lanes,
    every flush paying the injected commit wall; the store then holds
    every acked id exactly once."""
    import datetime as _dt

    from predictionio_tpu_torch.data.event import UTC, Event
    from predictionio_tpu_torch.data.write_buffer import WriteBuffer
    from predictionio_tpu_torch.loadtest.harness import drive_open_loop
    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.storage.audit import audit_exactly_once
    from predictionio_tpu_torch.storage.faults import FaultyEvents
    from predictionio_tpu_torch.storage.partitioned import (
        PartitionedEvents, SqlitePartitions,
    )

    c, app = LT_CURVE, 1
    root = WORK / "loadtest" / f"curve_p{parts}_{rnd}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    store = PartitionedEvents(SqlitePartitions(str(root / "events.db")),
                              initial_count=parts)
    store.init_channel(app)
    walled = FaultyEvents(store, latency_s=c["commit_ms"] / 1000.0,
                          ops=("insert_batch",))
    buf = WriteBuffer(lambda: walled, flush_max=c["flush_max"],
                      linger_s=c["linger_s"], queue_max=c["queue_max"],
                      partitions=parts, registry=MetricsRegistry())
    base = _dt.datetime(2026, 1, 1, tzinfo=UTC)
    n = c["events"]
    events = [Event(event="view", entity_type="user",
                    entity_id=f"u{i % 5000}", target_entity_type="item",
                    target_entity_id=f"i{i % 800}",
                    event_time=base + _dt.timedelta(seconds=i))
              for i in range(n)]
    batches = [events[i:i + c["batch"]] for i in range(0, n, c["batch"])]
    ledger = []
    try:
        res = drive_open_loop(
            batches, lambda b: buf.submit(b, app),
            max_outstanding=c["outstanding"], weight=len, timeout_s=600,
            on_ack=lambda _b, fut: ledger.extend(fut.result()))
        buf.stop()
        check(not res.timed_out and res.dropped == 0 and res.failed == 0,
              f"loadtest: curve P={parts} dropped={res.dropped} "
              f"failed={res.failed} timed_out={res.timed_out}")
        rows = len(store.find_columns(app, columns=("event_id",),
                                      ordered=False)["event_id"])
        check(rows == n, f"loadtest: curve P={parts} holds {rows} of "
              f"{n} rows")
        audit = audit_exactly_once(store, app, ledger)
        check(audit.ok, f"loadtest: curve P={parts}: {audit.summary()}")
        return {"events_per_s": res.events_per_s(),
                "ack_p99_ms": res.p99_ms(), "flushes": buf.flushes,
                "partitions": audit.partitions}
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)


def loadtest_curve_leg() -> dict:
    """Leg 1: ``ingest_write``'s partition curve, host work only."""
    c = LT_CURVE
    t0 = time.perf_counter()
    points = {}
    for parts in c["partitions"]:
        runs = [_curve_point(parts, r) for r in range(c["best_of"])]
        best = max(runs, key=lambda r: r["events_per_s"])
        points[parts] = dict(best, runs_events_per_s=[
            r["events_per_s"] for r in runs])
        log(f"loadtest: curve P={parts}: "
            f"{best['events_per_s']:.1f} events/s (best of "
            f"{c['best_of']}: {points[parts]['runs_events_per_s']}), "
            f"ack p99 {best['ack_p99_ms']:.1f} ms, "
            f"{best['flushes']} flushes, rows by partition "
            f"{best['partitions']}")
    lo, hi = c["partitions"][0], c["partitions"][-1]
    scaling = points[hi]["events_per_s"] / points[lo]["events_per_s"]
    check(scaling >= c["min_scaling"], f"loadtest: {scaling:.2f}x at "
          f"P={hi} over P={lo}, under the bench's {c['min_scaling']}x")
    return {"points": {str(k): v for k, v in points.items()},
            "scaling": scaling, "leg_s": time.perf_counter() - t0}


def _lt_storage(root: pathlib.Path) -> dict:
    """The CLI's environment for the fleet's store, and the same store
    configured in this process (the committed partition map decides the
    layout; no partition knob is set)."""
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.storage.registry import Storage

    env = {k: v for k, v in os.environ.items()
           if k != "PIO_INGEST_PARTITIONS"}
    env.update({
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(root / "meta.db"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_EV_PATH": str(root / "events.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV"})
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(root / "meta.db")},
                    "EV": {"TYPE": "sqlite",
                           "PATH": str(root / "events.db")}},
        "repositories": {
            "METADATA": {"NAME": "pio_meta", "SOURCE": "DB"},
            "MODELDATA": {"NAME": "pio_model", "SOURCE": "DB"},
            "EVENTDATA": {"NAME": "pio_event", "SOURCE": "EV"}}})
    eventstore.clear_cache()
    return env


def _lt_state(app_id: int):
    """(every stored event id, the training read's rows sorted) of the
    fleet's app."""
    from predictionio_tpu_torch.data.ingest import training_columns
    from predictionio_tpu_torch.storage.registry import Storage

    store = Storage.get_events()
    check(hasattr(store, "partition_count"), "loadtest: the fleet's store "
          "does not open partitioned")
    ids = [e.event_id for e in store.find(app_id)]
    cols = training_columns(LT_APP, cache=False, **LT_SCAN)
    rows = sorted(zip(*[cols[k].tolist() for k in LT_SCAN["columns"]]),
                  key=repr)
    return ids, rows, store.partition_count


class _StormTimeline:
    """Where a storm's query latency goes: the retrain's cycle and cutover
    times and the fleet loop's lag (a 10 ms sleep's overshoot, the loop
    the event server and the replicas share), on the storm's clock
    beside each query's submit offset and round trip (``run_storm``'s
    ``query_times``, taken in the traffic process). The storm's clock
    starts ``retrain_at_s`` before the retrain incident fired, to within
    its thread's wake-up."""

    def __init__(self, fleet, retrain_at_s: float):
        import asyncio

        self.retrain_at_s = retrain_at_s
        self.marks = {}
        self.lags = []
        self._done = threading.Event()
        retrain = fleet.run_retrain_cycle

        def timed_retrain():
            self.marks["retrain_start_s"] = time.perf_counter()
            orig_tick = fleet._orch.tick

            def tick(force=False):
                doc = orig_tick(force=force)
                self.marks["cycle_end_s"] = time.perf_counter()
                return doc

            fleet._orch.tick = tick
            try:
                return retrain()
            finally:
                fleet._orch.tick = orig_tick
                self.marks["cutover_end_s"] = time.perf_counter()

        fleet.run_retrain_cycle = timed_retrain

        async def monitor():
            while not self._done.is_set():
                t = time.perf_counter()
                await asyncio.sleep(0.01)
                lag = time.perf_counter() - t - 0.01
                self.lags.append((t, lag))

        asyncio.run_coroutine_threadsafe(monitor(), fleet._loop)
        self._cpu0 = self._thread_cpu()
        self._proc0 = time.process_time()
        self._wall0 = time.perf_counter()

    @staticmethod
    def _thread_cpu() -> dict:
        """CPU seconds of this process's threads by name (digits
        dropped, so a pool's threads add up), from /proc."""
        tick = os.sysconf("SC_CLK_TCK")
        names = {t.native_id: t.name for t in threading.enumerate()}
        out = collections.Counter()
        for tid, name in names.items():
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            out["".join(c for c in name if not c.isdigit()).rstrip("_-")] \
                += (int(fields[11]) + int(fields[12])) / tick
        return out

    def stop(self) -> None:
        self._done.set()
        self._cpu = self._thread_cpu()
        self._cpu.subtract(self._cpu0)
        self._proc = time.process_time() - self._proc0
        self._wall = time.perf_counter() - self._wall0

    def summary(self, query_times) -> dict:
        def p99(xs):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(0.99 * len(xs)))] * 1e3 \
                if xs else None

        queries = [tuple(q) for q in query_times]
        t0 = self.marks.get("retrain_start_s", self._wall0) \
            - self.retrain_at_s
        marks = {k: v - t0 for k, v in self.marks.items()}
        lo = marks.get("retrain_start_s", float("inf"))
        hi = marks.get("cutover_end_s", lo)
        inside = [d for t, d in queries if lo <= t <= hi + 1.0]
        outside = [d for t, d in queries if not lo <= t <= hi + 1.0]
        slow = [t for t, d in queries if d > 0.5]
        lag_list = [(t - t0, d) for t, d in self.lags]
        lags = [d for _, d in lag_list]
        cpu = {k: round(v, 2) for k, v in self._cpu.most_common(8)}
        return {**{k: round(v, 3) for k, v in marks.items()},
                "wall_s": round(self._wall, 3),
                "thread_cpu_s": cpu,
                "process_cpu_s": round(self._proc, 2),
                "queries": len(queries),
                "query_p99_ms_retrain_window": p99(inside),
                "query_p99_ms_elsewhere": p99(outside),
                "slow_queries_by_second": dict(sorted(collections.Counter(
                    int(t) for t in slow).items())),
                "loop_lag_p99_ms": p99(lags),
                "loop_lag_max_ms": max(lags) * 1e3 if lags else None,
                "loop_lags_over_100ms": [
                    (round(t, 2), round(d * 1e3, 1))
                    for t, d in lag_list if d > 0.1][:40]}


def loadtest_storm_leg(work: pathlib.Path) -> dict:
    """Leg 2: cfg_loadtest's sustained storm on the card (the replicas,
    the orchestrator's trains and fold-in on ``DEV``), launch counts from
    zero around the fleet's whole life. Leg 3: ``reshard -p 4``,
    ``reshard -p 2`` and ``compact`` through the CLI on the storm's
    store, the audit and the training read checked after each."""
    from predictionio_tpu_torch.loadtest.fleet import LocalFleet
    from predictionio_tpu_torch.loadtest.scenario import Scenario
    from predictionio_tpu_torch.loadtest.simulator import run_storm
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.storage.audit import audit_exactly_once
    from predictionio_tpu_torch.storage.registry import Storage

    s = LT_STORM
    sc = Scenario.from_dict({
        "name": "smoke-sustained", "population": s["population"],
        "items": s["items"], "durationS": s["duration_s"],
        "seed": s["seed"], "baseRate": s["rate"],
        "amplitude": s["amplitude"],
        "mix": {"events": 0.6, "queries": 0.3, "feedback": 0.1},
        "replicas": s["replicas"], "partitions": s["partitions"],
        "backend": "sqlite", "maxOutstanding": s["outstanding"],
        "incidents": [{"kind": "retrain",
                       "atS": round(s["duration_s"] * s["retrain_at"], 1)}],
    })
    root = work / "storm"
    shutil.rmtree(root, ignore_errors=True)
    fleet = LocalFleet(str(root), replicas=sc.replicas,
                       partitions=sc.partitions, backend=sc.backend,
                       device=DEV)
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        fleet.start()
        start_s = time.perf_counter() - t0
        timeline = _StormTimeline(fleet, sc.incidents[0].at_s)
        query_times = []
        t1 = time.perf_counter()
        try:
            report = run_storm(sc, fleet, ack_p99_bound_ms=s["p99_ms"],
                               query_p99_bound_ms=s["p99_ms"],
                               query_times=query_times)
        finally:
            timeline.stop()
        storm_s = time.perf_counter() - t1
    finally:
        fleet.stop()
    where = timeline.summary(query_times)
    log(f"loadtest: storm timeline: {json.dumps(where)}")
    synchronize()
    launches = kernels.counts()
    servers = [x for x in fleet._replica_servers if x is not None]
    solves = sum(x._foldin.solves for x in servers
                 if x._foldin is not None)
    modes = sorted({x.scorer_config.mode for x in servers})
    fails = [r for r in report["invariants"] if not r["ok"]]
    check(report["ok"], f"loadtest: storm violated {fails}")
    check(report["audit"]["ok"], f"loadtest: {report['audit']['summary']}")
    promoted = [c for c in report["cycles"] if c["outcome"] == "promoted"]
    check(bool(promoted), f"loadtest: no cycle promoted mid-run: "
          f"{report['cycles']}")
    trains = 1 + len(report["cycles"])          # the seed cycle's too
    want_b1 = LT_TRAIN_LAUNCHES * trains + solves
    check(launches["spd_solve"] == want_b1, f"loadtest: B1 launched "
          f"{launches['spd_solve']} times, the {trains} trains and "
          f"{solves} fold-in solves make {want_b1}")
    check(solves > 0, "loadtest: fold-in solved nothing on the card")
    if modes == ["exact"]:
        check(launches["shortlist"] == 0, "loadtest: B2 launched under "
              "the exact scorer")
        b2_note = ("the replicas' scorer ran exact (the fleet sets no "
                   "PIO_SCORER_MODE), so B2 is not on this path")
    else:
        check(launches["shortlist"] > 0, f"loadtest: scorer {modes} "
              "never launched B2")
        b2_note = f"the replicas' scorer ran {modes}"
    lanes = report["lanes"]
    ops_s = sum(r["acked"] for r in lanes.values()) / report["wall_s"]
    log(f"loadtest: storm {ops_s:.1f} ops/s over {report['wall_s']} s "
        f"({report['arrivals']} arrivals, {report['active_users']} users "
        f"woke); ack p99 events {lanes['events']['ack_p99_ms']} ms, "
        f"feedback {lanes['feedback']['ack_p99_ms']} ms, queries "
        f"{lanes['queries']['ack_p99_ms']} ms; audited "
        f"{report['audit']['expected']} events "
        f"{report['audit']['partitions']}; folded "
        f"{report['foldin_applied_rows']} rows; B1 {launches['spd_solve']}"
        f" ({trains} trains x {LT_TRAIN_LAUNCHES} + {solves} fold-in "
        f"solves), B2 {launches['shortlist']}: {b2_note}")

    # leg 3: maintenance through the CLI on the storm's store
    t2 = time.perf_counter()
    env = _lt_storage(root)
    app_id = fleet.app_id
    ledger, rows0, count0 = _lt_state(app_id)
    check(count0 == sc.partitions and len(ledger)
          == report["audit"]["expected"], f"loadtest: the store holds "
          f"{len(ledger)} ids over {count0} partitions after the storm")
    steps = []
    for args, count in ((["reshard", "-p", "4"], 4),
                        (["reshard", "-p", "2"], 2),
                        (["compact", "--appname", LT_APP, "--ttl-days",
                          "36500"], 2)):
        Storage.reset()
        t3 = time.perf_counter()
        out = _cli(args, env, timeout=300)
        cli_s = time.perf_counter() - t3
        _lt_storage(root)
        store = Storage.get_events()
        audit = audit_exactly_once(store, app_id, ledger)
        _ids, rows, got_count = _lt_state(app_id)
        check(audit.ok, f"loadtest: after {args}: {audit.summary()}")
        check(rows == rows0, f"loadtest: after {args} the training read "
              f"changed ({len(rows)} rows, {len(rows0)} before)")
        check(got_count == count, f"loadtest: after {args} the store has "
              f"{got_count} partitions")
        steps.append({"args": args, "out": out[-1], "cli_s": cli_s,
                      "partitions": audit.partitions})
        log(f"loadtest: {' '.join(args)}: {out[-1]} ({cli_s:.3f} s); "
            f"audit clean {audit.partitions}, {len(rows)} training rows")
    check(steps[2]["out"].endswith('{"removed_rows": 0}'),
          f"loadtest: compact removed rows: {steps[2]['out']}")
    Storage.reset()
    shutil.rmtree(root, ignore_errors=True)
    return {"timeline": where, "storm": {k: report[k] for k in (
                "ok", "wall_s", "arrivals", "active_users", "lanes",
                "audit", "invariants", "cycles", "foldin_applied_rows")},
            "ops_per_s": ops_s, "start_s": start_s, "storm_s": storm_s,
            "launches": launches, "trains": trains, "foldin_solves": solves,
            "scorer_modes": modes, "b2_note": b2_note,
            "maintenance": steps,
            "maintenance_s": time.perf_counter() - t2,
            "training_rows": len(rows0)}


def loadtest_phase(seed: int, port: int, work) -> dict:
    """Phase 17 in its own process: the process-wide knobs the fleet sets
    (``PIO_INGEST_PARTITIONS``, ``PIO_SERVER_CONF``) touch nothing else."""
    t0 = time.perf_counter()
    curve = loadtest_curve_leg()
    storm = loadtest_storm_leg(pathlib.Path(work))
    return {"curve": curve, **storm, "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# distributed phase: multi-process ALS and the sharded scorer
# ---------------------------------------------------------------------------

#: legs 1-2's processes, their rendezvous and run bounds, leg 2's
#: queries; leg 3's query batches (B 1 and 8, one whitelist batch of 8
#: concentrated in the second shard)
DIST = dict(nproc=2, rendezvous_s=300, run_s=600, queries=100,
            batches=(1,) * 8 + (8,) * 4, whitelist=500, http_queries=24)
#: both processes of leg 1 hold the same full factors (they gather the
#: same blocks): max |difference|
DIST_SAME = 1e-5
#: leg 3's served scores against the host's exact f32 scores
SHARD_TOL = 1e-5


def _dist_spawn(leg_cfg: dict, work: pathlib.Path):
    """Start leg 1-2's processes (``dist_worker``), each with the repo
    root on ``PYTHONPATH``, a free loopback port for the rendezvous and
    gloo on the loopback interface; returns them with their log paths."""
    port = _free_ports(1)
    procs = []
    t_spawn = time.time()
    for pid in range(DIST["nproc"]):
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                   CHIP_SMOKE_DIST=json.dumps(dict(
                       leg_cfg, pid=pid, port=port, t_spawn=t_spawn)))
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        for k in ("PIO_COORDINATOR_ADDRESS", "PIO_NUM_PROCESSES",
                  "PIO_PROCESS_ID"):
            env.pop(k, None)
        # pio: ignore[PIO002]: a process's stdout log in scratch
        out = open(work / f"dist{pid}.out", "w")
        # pio: ignore[PIO002]: a process's stderr log in scratch
        err = open(work / f"dist{pid}.err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.dist_worker())"], cwd=str(ROOT),
            stdout=out, stderr=err, start_new_session=True, env=env),
            out, err))
    return procs


def _dist_wait(procs, work: pathlib.Path) -> list:
    """Wait for leg 1-2's processes within ``DIST["run_s"]``; one that
    fails or hangs fails the phase and both are killed. Returns their
    reports in process order."""
    deadline = time.monotonic() + DIST["run_s"]
    try:
        for pid, (proc, _, _) in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                check(False, f"distributed: process {pid} ran past "
                      f"{DIST['run_s']} s (a hung rendezvous?)")
            if proc.returncode != 0:
                err = (work / f"dist{pid}.err").read_text()[-3000:]
                check(False, f"distributed: process {pid} exited "
                      f"{proc.returncode}: {err}")
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            out.close()
            err.close()
    reports = []
    for pid in range(len(procs)):
        lines = (work / f"dist{pid}.out").read_text().splitlines()
        for line in lines[:-1]:
            log(line)
        reports.append(json.loads(lines[-1]))
    return reports


def dist_worker() -> int:
    """One process of legs 1-2 and 4-7 (``python3 -c "import chip_smoke;
    chip_smoke.dist_worker()"``, its settings in ``CHIP_SMOKE_DIST``):
    joins the gloo group, runs leg 1 (the ML-20M train over a 2-position
    process mesh), leg 2 (the recommendation engine's sharded read and
    train), then legs 4-7 (the classifiers, distributed cooccurrence,
    the eval sweep and seqrec over the process mesh; their arrays go to
    the leg's ``out`` directory) and prints its report as the last
    line."""
    global DEV
    sys.path.insert(0, str(ROOT))
    cfg = json.loads(os.environ["CHIP_SMOKE_DIST"])
    DEV = cfg["device"]
    for key, shape in cfg["shapes"].items():
        globals()[key].update(shape)
    from predictionio_tpu_torch.parallel.distributed import (
        initialize_distributed, process_count, process_index,
    )

    pid, nproc = cfg["pid"], DIST["nproc"]
    try:
        initialize_distributed(f"127.0.0.1:{cfg['port']}", nproc, pid,
                               timeout_s=DIST["rendezvous_s"])
        check((process_index(), process_count()) == (pid, nproc),
              f"distributed: process {pid} joined as "
              f"{(process_index(), process_count())}")
        report = {"pid": pid,
                  "group_ready_s": time.time() - cfg["t_spawn"]}
        import torch

        torch.zeros(1, device=DEV)
        report["device_ready_s"] = time.time() - cfg["t_spawn"]
        report["leg1"] = _dist_leg1(pid, nproc,
                                    pathlib.Path(cfg["factors"]))
        report["leg2"] = _dist_leg2(cfg)
        out = pathlib.Path(cfg["out"])
        report["leg4"] = _dist_leg4(pid, out)
        report["leg5"] = _dist_leg5(pid, nproc, out)
        report["leg6"] = _dist_leg6()
        report["leg7"] = _dist_leg7(pid, nproc, out, cfg["seed"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report), flush=True)
    return 0


def _dist_leg1(pid: int, nproc: int, factors: pathlib.Path) -> dict:
    """Leg 1 in one process: its contiguous slice of the ML-20M COO, the
    row exchange and local pack (``build_distributed``), an uncounted
    train, then the timed train with B1 counted from zero; its factors
    go to ``factors``."""
    import numpy as np

    from predictionio_tpu_torch.models.als import (
        ALSParams, build_distributed, train_als,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.parallel.distributed import contiguous_range
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    c = ML20M
    t0 = time.perf_counter()
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    lo, hi = contiguous_range(len(ratings), pid, nproc)
    users, items, ratings = (users[lo:hi].copy(), items[lo:hi].copy(),
                             ratings[lo:hi].copy())
    synth_s = time.perf_counter() - t0
    mesh = make_mesh(device=DEV)
    check(mesh.size == nproc and mesh.spans_processes,
          f"distributed: mesh {mesh}")
    t0 = time.perf_counter()
    data = build_distributed(mesh, users, items, ratings, c["n_users"],
                             c["n_items"])
    synchronize()
    build_s = time.perf_counter() - t0
    params = ALSParams(rank=c["rank"], num_iterations=c["iters"],
                       reg=c["reg"], chunk_size=c["chunk"])
    train_als(data, params, mesh=mesh)         # a process's first train
    synchronize()
    kernels.reset_counts()
    stats = {}
    t0 = time.perf_counter()
    U, V = train_als(data, params, mesh=mesh, stats=stats)
    train_s = time.perf_counter() - t0
    launches = kernels.counts()["spd_solve"]
    np.save(factors / f"U{pid}.npy", U)
    np.save(factors / f"V{pid}.npy", V)
    gather = np.asarray(stats["gather_s"]) * 1e3
    return {"local_ratings": hi - lo, "synth_s": synth_s,
            "build_s": build_s, "exchange": data.exchange,
            "digest": data.digest, "launches": launches,
            "train_s": train_s, "half_sweeps": stats["half_sweeps"],
            "half_sweep_ms": train_s / stats["half_sweeps"] * 1e3,
            "gather_ms_mean": float(gather.mean()),
            "gather_ms_max": float(gather.max()),
            "gather_share": float(gather.sum() / 1e3 / train_s)}


def _dist_leg2(cfg: dict) -> dict:
    """Leg 2 in one process: the recommendation DataSource's sharded read
    of leg 2's store, ``ALSAlgorithm.train`` over the process mesh (B1
    counted from zero), and its answers to the leg's queries."""
    import types

    import torch

    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, DataSourceParams,
        RecommendationDataSource, RecommendationPreparator,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.parallel.mesh import make_mesh
    from predictionio_tpu_torch.storage.registry import Storage

    c = ML100K
    Storage.configure(cfg["store"])
    eventstore.clear_cache()
    try:
        t0 = time.perf_counter()
        ds = RecommendationDataSource(DataSourceParams(app_name="DistApp"))
        td = ds.read_training(None)
        read_s = time.perf_counter() - t0
        pd = RecommendationPreparator().prepare(None, td)
        algo = ALSAlgorithm(AlgorithmParams(rank=c["rank"],
                                            num_iterations=c["iters"],
                                            reg=c["reg"]))
        ctx = types.SimpleNamespace(mesh=make_mesh(device=DEV),
                                    device=torch.device(DEV),
                                    checkpointer=None)
        kernels.reset_counts()
        t0 = time.perf_counter()
        model = algo.train(ctx, pd)
        train_s = time.perf_counter() - t0
        launches = kernels.counts()["spd_solve"]
        answers = [[[i, s] for i, s in r] for r in model.recommend_batch(
            [(u, 10, (), None) for u in cfg["queries"]])]
    finally:
        Storage.reset()
    return {"local_rows": len(td.columns.users), "read_s": read_s,
            "train_s": train_s, "launches": launches,
            "users": len(model.user_vocab), "items": len(model.item_vocab),
            "answers": answers}


#: leg 5: the reference's cooccurrence bench at the ML-1M shape
#: (bench.py:674: 6,040 x 3,706, 1,000,000 events, seed 2), top 20
DIST_COOC = dict(n_users=6_040, n_items=3_706, nnz=1_000_000, seed=2,
                 n=COOC_N)
#: leg 7: seqrec at the template's widths (``SR_PARAMS``) over ML-20M's
#: catalog (``SESSIONREC``, V 26,745), ``steps`` steps of one epoch:
#: the first ``steps * batch - 1`` planted sessions and one session
#: holding the whole catalog (so the vocabulary is the catalog's; the
#: one cut is the step count); ``queries`` next-item queries of
#: ``num`` on each process
DIST_SR = dict(steps=40, queries=20, num=10)
#: leg 7 (a) across the processes against the same mesh in one process
#: on the card: each step's loss relative, every parameter absolute (the
#: same f32 steps; only the collectives' path differs)
DIST_SR_TOL = 1e-5
#: leg 7 (b): ring attention on a data 2 x seq 2 mesh against flash on
#: one device, ``emb`` absolute (the reference's bound,
#: tests/test_sessionrec.py:153-173)
DIST_RING_TOL = 2e-4
#: leg 7 (c): Ulysses against dense attention on the card, absolute
DIST_ATT_TOL = 1e-5
#: the shapes the distributed phase's processes read
DIST_SHAPES = ("ML20M", "ML100K", "NB_SPAM", "CLS_WIDTH", "EVAL_GRID",
               "DIST_COOC", "DIST_SR", "SESSIONREC", "SR_PARAMS")


def _on_card(t, what: str) -> None:
    """``t`` (a tensor or a device) is on the smoke's device type."""
    import torch

    dev = getattr(t, "device", t)
    check(dev is not None and dev.type == torch.device(DEV).type,
          f"distributed {what}: not on {DEV} ({dev})")


def _dist_leg4(pid: int, out: pathlib.Path) -> dict:
    """Leg 4 in one process: naive Bayes (its mesh branch), logistic
    regression and the forest over the 2-position process mesh at the
    spam width, then a predict of this process's own whole X with each;
    the models and answers go to ``out``."""
    import numpy as np

    from predictionio_tpu_torch.models import forest, logreg, naive_bayes
    from predictionio_tpu_torch.parallel import collectives
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    t_leg = time.perf_counter()
    mesh = make_mesh(device=DEV)
    _on_card(mesh.local_devices()[0], "leg 4: the mesh")
    X, labels = nb_spam_data()
    collectives.reset_staged_stats()
    secs = {}
    t0 = time.perf_counter()
    nb = naive_bayes.train_multinomial_nb(X, labels, mesh=mesh)
    secs["nb_train_s"] = time.perf_counter() - t0
    nb_spam = nb.predict(X) == "spam"
    check(dict(nb.branches) == {"train_mesh": 1, "predict_device": 1},
          f"distributed leg 4: naive Bayes took {dict(nb.branches)}")
    _on_card(nb._x_ref(), "leg 4: the resident X of naive Bayes")
    lp = logreg.LogRegParams(**CLS_WIDTH["logreg"])
    t0 = time.perf_counter()
    lr = logreg.train_logreg(X, labels, lp, mesh=mesh, init_W=logreg.
                             initial_W(X.shape[1], 2, lp.seed))
    secs["logreg_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fm = forest.train_forest(X, labels,
                             forest.ForestParams(**CLS_WIDTH["forest"]),
                             mesh=mesh)
    secs["forest_train_s"] = time.perf_counter() - t0
    f_codes = fm.predict_codes(X)
    _on_card(fm._on_device()[1], "leg 4: the forest's nodes")
    np.savez(out / f"leg4_{pid}.npz", nb_log_prob=nb.log_prob,
             nb_log_prior=nb.log_prior, nb_spam=nb_spam, lr_W=lr.W,
             lr_b=lr.b, lr_spam=lr.predict(X) == "spam", f_feat=fm.feat,
             f_thr=fm.thr, f_leaf=fm.leaf, f_codes=f_codes)
    return dict(secs, leg_s=time.perf_counter() - t_leg,
                staged=collectives.staged_stats())


def _dist_leg5(pid: int, nproc: int, out: pathlib.Path) -> dict:
    """Leg 5 in one process: ``cooccurrence_topn_distributed`` on this
    process's disjoint half of the ML-1M events (every ``nproc``-th from
    ``pid``); the top-N goes to ``out``."""
    import numpy as np

    from predictionio_tpu_torch.models import cooccurrence as co
    from predictionio_tpu_torch.parallel import collectives
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    c = DIST_COOC
    t_leg = time.perf_counter()
    users, items, _ = synthetic_ratings(c["n_users"], c["n_items"],
                                        c["nnz"], seed=c["seed"])
    mesh = make_mesh(device=DEV)
    collectives.reset_staged_stats()
    stats = {}
    synchronize()
    t0 = time.perf_counter()
    vals, ids = co.cooccurrence_topn_distributed(
        mesh, users[pid::nproc], items[pid::nproc], c["n_users"],
        c["n_items"], c["n"], stats=stats)
    topn_s = time.perf_counter() - t0
    check(stats["path"] == "mesh" and stats["device"].startswith(DEV),
          f"distributed leg 5: the count ran on {stats['device']}")
    np.savez(out / f"leg5_{pid}.npz", vals=vals, ids=ids)
    return dict(stats, topn_s=topn_s, local_events=len(users[pid::nproc]),
                leg_s=time.perf_counter() - t_leg,
                staged=collectives.staged_stats())


def _dist_leg6() -> dict:
    """Leg 6 in one process: ``run_sweep`` over the eval grid across the
    processes (its groups round-robin, one a process), after one
    uncounted sweep; B1 counted from zero around the counted one."""
    from predictionio_tpu_torch.parallel import collectives

    t_leg = time.perf_counter()
    data, cands = _eval_grid_data()
    _sweep_side(data, cands, EVAL_GRID["rank_metrics"])
    collectives.reset_staged_stats()
    res, wall, launches = _sweep_side(data, cands,
                                      EVAL_GRID["rank_metrics"])
    return {"launches": launches, "sweep_s": wall,
            "batch_sizes": res.batch_sizes, "seconds": res.seconds,
            "candidates": [dataclasses.asdict(c) | {"params": None}
                           for c in res.candidates],
            "leg_s": time.perf_counter() - t_leg,
            "staged": collectives.staged_stats()}


def _eval_grid_data():
    """The eval grid's sweep data and candidates (``EVAL_GRID``)."""
    from predictionio_tpu_torch.core.cross_validation import (
        fold_assignments,
    )
    from predictionio_tpu_torch.models.als import ALSParams
    from predictionio_tpu_torch.models.als_sweep import build_sweep_data

    c = EVAL_GRID
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    data = build_sweep_data(users, items, ratings,
                            fold_assignments(c["folds"], c["nnz"]),
                            c["n_users"], c["n_items"])
    cands = [ALSParams(rank=r, num_iterations=c["iters"], reg=g,
                       chunk_size=c["chunk"])
             for r in c["ranks"] for g in c["regs"]]
    return data, cands


def dist_sr_sessions(seed: int):
    """Leg 7's sessions (``DIST_SR``) and its queries (the last five
    items of the first sessions)."""
    sessions, names = planted_sessions(seed)
    k = DIST_SR["steps"] * SR_PARAMS["batch_size"] - 1
    sessions = sessions[:k] + [names.tolist()]
    return sessions, [s[-5:] for s in sessions[:DIST_SR["queries"]]]


def _dist_leg7(pid: int, nproc: int, out: pathlib.Path, seed: int) -> dict:
    """Leg 7 (a) in one process: seqrec over a data 1 x model 2 mesh of
    the two processes (tp across them), ``DIST_SR["steps"]`` steps; each
    step's loss, the step's milliseconds and the share of the train in
    host-staged collectives, the answers to the leg's queries; the whole
    parameters go to ``out``."""
    import numpy as np

    from predictionio_tpu_torch.models import seqrec
    from predictionio_tpu_torch.parallel import collectives
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    t_leg = time.perf_counter()
    sessions, queries = dist_sr_sessions(seed)
    mesh = make_mesh((1, nproc), ("data", "model"), device=DEV)
    p = seqrec.SeqRecParams(**SR_PARAMS)
    losses, timings = [], []
    collectives.reset_staged_stats()
    t0 = time.perf_counter()
    model = seqrec.train_seqrec(mesh, sessions, p, losses=losses,
                                timings=timings)
    train_s = time.perf_counter() - t0
    staged = collectives.staged_stats()
    check(len(losses) == DIST_SR["steps"], f"distributed leg 7: "
          f"{len(losses)} steps, expected {DIST_SR['steps']}")
    answers = [model.recommend_next(q, DIST_SR["num"]) for q in queries]
    _on_card(model.net().emb, "leg 7: the trained model")
    np.savez(out / f"leg7_{pid}.npz", **model.params)
    return {"train_s": train_s, "steps": len(losses),
            "step_ms": timings[0] / len(losses) * 1e3,
            "staged_share": staged["seconds"] / timings[0],
            "staged": staged, "losses": losses, "answers": answers,
            "n_vocab": int(model.params["emb"].shape[0]),
            "leg_s": time.perf_counter() - t_leg}


def _dist_store(work: pathlib.Path, seed: int) -> dict:
    """Leg 2's store: the ML-100k ratings as rate events (sqlite, written
    with ``insert_batch``); returns its storage configuration."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.registry import Storage

    c = ML100K
    smoke_store(work / "store")
    conf = {"sources": {"SMOKE": {"TYPE": "sqlite",
                                  "PATH": str(work / "store" / "pio.db")}},
            "repositories": {
                "METADATA": {"NAME": "pio_meta", "SOURCE": "SMOKE"},
                "EVENTDATA": {"NAME": "pio_event", "SOURCE": "SMOKE"},
                "MODELDATA": {"NAME": "pio_model", "SOURCE": "SMOKE"}}}
    Storage.configure(conf)
    app_id = _new_app("DistApp")
    users, items, ratings = synthetic_ratings(
        c["n_users"], c["n_items"], c["nnz"], seed=seed + 40)
    Storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": float(r)})
        for u, i, r in zip(users.tolist(), items.tolist(),
                           ratings.tolist())], app_id)
    return conf


def distributed_legs(seed: int, port: int, work) -> dict:
    """Legs 1-2 and 4-7 of the distributed phase (a background leg):
    leg 2's store, the two processes of legs 1-2 and 4-7 on the card,
    then here each leg's one-process twin and checks, and leg 7's ring
    and Ulysses parts; leg 1's factors are held to the train phase's
    one-process train by ``distributed_twin``."""
    import types

    import numpy as np
    import torch

    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, DataSourceParams,
        RecommendationDataSource, RecommendationPreparator,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.storage.registry import Storage

    work = pathlib.Path(work)
    shutil.rmtree(work, ignore_errors=True)
    out = work / "out"
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    store = _dist_store(work, seed)
    store_s = time.perf_counter() - t0
    queries = [f"u{u}" for u in range(DIST["queries"])]
    # leg 1's factors outlive this leg's directory: distributed_twin
    # reads them after the train phase, then removes them
    factors = WORK / "dist_factors"
    shutil.rmtree(factors, ignore_errors=True)
    factors.mkdir(parents=True)
    t0 = time.perf_counter()
    reports = _dist_wait(_dist_spawn(dict(
        device=DEV, factors=str(factors), out=str(out), seed=seed,
        shapes={k: globals()[k] for k in DIST_SHAPES},
        store=store, queries=queries), work), work)
    procs_s = time.perf_counter() - t0
    r0, r1 = (r["leg1"] for r in reports)
    # leg 1: the same factors on both processes, 2 x iters launches each
    want = 2 * ML20M["iters"]
    for r in (r0, r1):
        check(r["launches"] == want, f"distributed leg 1: {r['launches']} "
              f"B1 launches in a process, expected {want}")
    check(r0["digest"] == r1["digest"], "distributed leg 1: the processes' "
          f"digests differ ({r0['digest']}, {r1['digest']})")
    same = {}
    for side in ("U", "V"):
        a, b = (np.load(factors / f"{side}{p}.npy") for p in (0, 1))
        same[side] = float(np.abs(a - b).max())
        check(same[side] <= DIST_SAME, f"distributed leg 1: {side} "
              f"differs across the processes by {same[side]} > "
              f"{DIST_SAME}")
    # leg 2: strict subsets summing to the whole, the same model
    rows = [r["leg2"]["local_rows"] for r in reports]
    check(all(0 < n < ML100K["nnz"] for n in rows)
          and sum(rows) == ML100K["nnz"], f"distributed leg 2: the "
          f"processes read {rows} of {ML100K['nnz']} rows")
    want2 = 2 * ML100K["iters"]
    for r in reports:
        check(r["leg2"]["launches"] == want2, f"distributed leg 2: "
              f"{r['leg2']['launches']} B1 launches, expected {want2}")
    Storage.configure(store)
    eventstore.clear_cache()
    try:
        c = ML100K
        ds = RecommendationDataSource(DataSourceParams(app_name="DistApp"))
        pd = RecommendationPreparator().prepare(None, ds.read_training(None))
        kernels.reset_counts()
        model = ALSAlgorithm(AlgorithmParams(
            rank=c["rank"], num_iterations=c["iters"], reg=c["reg"])).train(
            types.SimpleNamespace(device=torch.device(DEV),
                                  checkpointer=None), pd)
        one_launches = kernels.counts()["spd_solve"]
        want_answers = model.recommend_batch(
            [(u, 10, (), None) for u in queries])
    finally:
        Storage.reset()
    max_err = 0.0
    for r in reports:
        for u, got, want in zip(queries, r["leg2"]["answers"],
                                want_answers):
            _same_answers(
                {"itemScores": [{"item": i, "score": s} for i, s in got]},
                {"itemScores": [{"item": i, "score": s} for i, s in want]},
                f"distributed leg 2: {u}")
            if got:
                max_err = max(max_err, float(np.abs(
                    np.array([s for _, s in got])
                    - np.array([s for _, s in want])).max()))
        r["leg2"].pop("answers")
    legs = {"leg4": _dist_check_leg4(reports, out),
            "leg5": _dist_check_leg5(reports, out),
            "leg6": _dist_check_leg6(reports),
            "leg7": _dist_check_leg7(reports, out, seed)}
    return {"card": card_line(), "store_s": store_s,
            "processes_s": procs_s, "procs": [
                {k: r[k] for k in ("group_ready_s", "device_ready_s")}
                for r in reports],
            "leg1": {"per_process": [r0, r1], "factors": str(factors),
                     "max_abs_diff_across_processes": same},
            "leg2": {"per_process": [r["leg2"] for r in reports],
                     "one_process_launches": one_launches,
                     "queries": len(queries), "max_score_abs_err": max_err},
            **legs}


def _dist_check_leg4(reports, out: pathlib.Path) -> dict:
    """Leg 4 against one process on the card: naive Bayes' log-probs and
    the forest's node arrays equal, logistic regression's W and b within
    ``LOGREG_TOL``, and every process's answers on its whole X equal the
    one-process model's."""
    import numpy as np

    from predictionio_tpu_torch.models import forest, logreg, naive_bayes

    t0 = time.perf_counter()
    X, labels = nb_spam_data()
    nb = naive_bayes.train_multinomial_nb(X, labels, device=DEV)
    nb_spam = nb.predict(X) == "spam"
    lp = logreg.LogRegParams(**CLS_WIDTH["logreg"])
    lr = logreg.train_logreg(X, labels, lp, device=DEV,
                             init_W=logreg.initial_W(X.shape[1], 2, lp.seed))
    fm = forest.train_forest(X, labels,
                             forest.ForestParams(**CLS_WIDTH["forest"]),
                             device=DEV)
    f_codes = fm.predict_codes(X)
    one_s = time.perf_counter() - t0
    scale = max(1.0, float(np.abs(lr.W).max()))
    lr_err = 0.0
    for pid in range(len(reports)):
        got = np.load(out / f"leg4_{pid}.npz")
        for k, want in (("nb_log_prob", nb.log_prob),
                        ("nb_log_prior", nb.log_prior), ("nb_spam", nb_spam),
                        ("f_feat", fm.feat), ("f_thr", fm.thr),
                        ("f_leaf", fm.leaf), ("f_codes", f_codes)):
            check(np.array_equal(got[k], want), f"distributed leg 4: "
                  f"process {pid}'s {k} differs from one process's")
        err = max(float(np.abs(got["lr_W"] - lr.W).max()),
                  float(np.abs(got["lr_b"] - lr.b).max()))
        lr_err = max(lr_err, err)
        check(err <= LOGREG_TOL * scale, f"distributed leg 4: process "
              f"{pid}'s logreg W/b {err} from one process's (tolerance "
              f"{LOGREG_TOL * scale})")
        check(np.array_equal(got["lr_spam"], lr.predict(X) == "spam"),
              f"distributed leg 4: process {pid}'s logreg answers differ")
    report = {"per_process": [r["leg4"] for r in reports],
              "one_process_s": one_s, "logreg_max_abs_err": lr_err,
              "logreg_tol": LOGREG_TOL * scale,
              "nb_branches_one_process": dict(nb.branches)}
    log("distributed: leg 4 " + json.dumps(report))
    return report


def _dist_check_leg5(reports, out: pathlib.Path) -> dict:
    """Leg 5 against one process on the card over all the events (the
    slabbed product ``cooccurrence_topn`` runs on the card): counts and
    ids exactly equal (ties keep the lower id in both)."""
    import numpy as np

    from predictionio_tpu_torch.models import cooccurrence as co

    c = DIST_COOC
    users, items, _ = synthetic_ratings(c["n_users"], c["n_items"],
                                        c["nnz"], seed=c["seed"])
    du, di = co.distinct_pairs(users, items)
    stats = {}
    t0 = time.perf_counter()
    vals, ids = co.cooccurrence_topn_slabs(
        du, di, c["n_users"], c["n_items"], c["n"], device=DEV, stats=stats)
    one_s = time.perf_counter() - t0
    for pid in range(len(reports)):
        got = np.load(out / f"leg5_{pid}.npz")
        check(np.array_equal(got["vals"], vals)
              and np.array_equal(got["ids"], ids), f"distributed leg 5: "
              f"process {pid}'s top-{c['n']} differs from one process's")
    report = {"per_process": [r["leg5"] for r in reports],
              "one_process_s": one_s, "one_process_path": stats["path"],
              "distinct_pairs": len(du)}
    log("distributed: leg 5 " + json.dumps(report))
    return report


def _dist_check_leg6(reports) -> dict:
    """Leg 6 against one process's sweep on the card: each process ran
    one rank group (B1 ``2 * iters`` times), and both merged results
    hold the one-process sweep's (``_hold_sweeps``)."""
    from predictionio_tpu_torch.models.als_sweep import (
        CandidateResult, SweepResult,
    )

    c = EVAL_GRID
    data, cands = _eval_grid_data()
    units = len(c["regs"]) * c["folds"]
    one, one_s, one_n = _sweep_side(data, cands, c["rank_metrics"])
    sides = {"one_process": one}
    for pid, r in enumerate(reports):
        leg = r["leg6"]
        check(leg["launches"] == 2 * c["iters"] and leg["batch_sizes"]
              == [units], f"distributed leg 6: process {pid} launched B1 "
              f"{leg['launches']} times over {leg['batch_sizes']}")
        sides[f"process_{pid}"] = SweepResult(
            candidates=[CandidateResult(**dict(d, params=p)) for d, p
                        in zip(leg.pop("candidates"), cands)],
            n_groups=one.n_groups, batch_sizes=leg["batch_sizes"],
            mode="batched")
    gap, hit_gap = _hold_sweeps("distributed leg 6", sides,
                                c["rank_metrics"])
    report = {"per_process": [r["leg6"] for r in reports],
              "launches_per_process": [r["leg6"]["launches"]
                                       for r in reports],
              "one_process_s": one_s, "one_process_launches": one_n,
              "max_rmse_gap": gap, "max_hit_gap": hit_gap}
    log("distributed: leg 6 " + json.dumps(report))
    return report


def _dist_check_leg7(reports, out: pathlib.Path, seed: int) -> dict:
    """Leg 7: (a) the processes' tp train against the same 1 x 2 mesh
    in one process, both positions on the card (one device, the same
    init: the vocabulary padded to 2): each step's loss and every
    parameter within ``DIST_SR_TOL``, the answers equal on both
    processes and the one-process model's (``_same_answers``);
    (b) here, a data 2 x seq 2 mesh of positions on the card trained
    with ``attention_impl="ring"`` against flash on one device, ``emb``
    within ``DIST_RING_TOL``; (c) ``ulysses_attention`` against ``mha``
    on the card."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import seqrec
    from predictionio_tpu_torch.ops import attention
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    sessions, queries = dist_sr_sessions(seed)
    p = seqrec.SeqRecParams(**SR_PARAMS)
    t0 = time.perf_counter()
    losses = []
    one = seqrec.train_seqrec(
        make_mesh((1, 2), ("data", "model"), devices=[DEV] * 2), sessions,
        p, losses=losses)
    one_s = time.perf_counter() - t0
    loss_err = param_err = 0.0
    for pid, r in enumerate(reports):
        got = np.asarray(r["leg7"].pop("losses"))
        loss_err = max(loss_err, float(np.max(np.abs(got - losses)
                                              / np.abs(losses))))
        params = np.load(out / f"leg7_{pid}.npz")
        for k, want in one.params.items():
            param_err = max(param_err,
                            float(np.abs(params[k] - want).max()))
    answers = [r["leg7"].pop("answers") for r in reports]
    check(all(a == answers[0] for a in answers),
          "distributed leg 7: the processes answer differently")
    for q, a in zip(queries, answers[0]):
        _same_answers(
            {"itemScores": [{"item": i, "score": x} for i, x in a]},
            {"itemScores": [{"item": i, "score": x} for i, x in
                            one.recommend_next(q, DIST_SR["num"])]},
            f"distributed leg 7: {q}")
    check(loss_err <= DIST_SR_TOL and param_err <= DIST_SR_TOL,
          f"distributed leg 7: losses {loss_err}, parameters {param_err} "
          f"from one process (tolerance {DIST_SR_TOL})")
    # (b) ring over "seq" in this process, four positions on the card
    t0 = time.perf_counter()
    flash = seqrec.train_seqrec(None, sessions, p, device=DEV)
    ring_mesh = make_mesh((2, 2), ("data", "seq"), devices=[DEV] * 4)
    ring = seqrec.train_seqrec(
        ring_mesh, sessions,
        seqrec.SeqRecParams(**dict(SR_PARAMS, attention_impl="ring")))
    ring_s = time.perf_counter() - t0
    _on_card(ring.net().emb, "leg 7 (b): the ring-trained model")
    ring_err = float(np.abs(ring.params["emb"] - flash.params["emb"]).max())
    check(ring_err <= DIST_RING_TOL, f"distributed leg 7 (b): ring emb "
          f"{ring_err} from flash (tolerance {DIST_RING_TOL})")
    # (c) Ulysses against dense attention at the template's shapes
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = SR_PARAMS["d_model"] // SR_PARAMS["n_heads"]
    q, k, v = (torch.randn((SR_PARAMS["batch_size"], SR_PARAMS["max_len"],
                            SR_PARAMS["n_heads"], d), generator=g).to(DEV)
               for _ in range(3))
    key_mask = (torch.arange(SR_PARAMS["max_len"])[None, :]
                >= torch.randint(0, SR_PARAMS["max_len"],
                                 (SR_PARAMS["batch_size"], 1),
                                 generator=g)).to(DEV)
    uly = attention.ulysses_attention(
        q, k, v, make_mesh((2,), ("seq",), devices=[DEV] * 2), causal=True,
        key_mask=key_mask)
    _on_card(uly, "leg 7 (c): the Ulysses output")
    att_err = float((uly - attention.mha(q, k, v, causal=True,
                                         key_mask=key_mask)).abs().max())
    check(att_err <= DIST_ATT_TOL, f"distributed leg 7 (c): Ulysses "
          f"{att_err} from mha (tolerance {DIST_ATT_TOL})")
    report = {"per_process": [r["leg7"] for r in reports],
              "one_process_s": one_s, "loss_max_rel_err": loss_err,
              "param_max_abs_err": param_err, "tol": DIST_SR_TOL,
              "ring_s": ring_s, "ring_emb_max_abs_err": ring_err,
              "ring_tol": DIST_RING_TOL, "ulysses_max_abs_err": att_err,
              "n_vocab": reports[0]["leg7"]["n_vocab"],
              "sessions": len(sessions)}
    log("distributed: leg 7 " + json.dumps(report))
    return report


def distributed_twin(report: dict, full_UV, digest: str) -> dict:
    """Leg 1's factors against the train phase's one-process train from
    the same initial factors (its ``TWIN_TOL``), and the digest against
    its ``ALSData.build``'s."""
    import numpy as np

    factors = pathlib.Path(report["leg1"]["factors"])
    U, V = (np.load(factors / f"{s}0.npy") for s in ("U", "V"))
    shutil.rmtree(factors, ignore_errors=True)
    du, dv = _rel(U, full_UV[0]), _rel(V, full_UV[1])
    check(max(du, dv) <= TWIN_TOL, f"distributed leg 1: factors differ "
          f"from the one-process train by {max(du, dv)} > {TWIN_TOL}")
    got = report["leg1"]["per_process"][0]["digest"]
    check(got == digest, f"distributed leg 1: digest {got} is not the "
          f"one-process build's {digest}")
    return {"rel_diff_U": du, "rel_diff_V": dv, "digest": digest}


def _check_sharded_answers(batches, got, U, V, what: str) -> float:
    """Every scored user's top-10 against the host's exact f32 top-10
    (ids up to ties, scores within ``SHARD_TOL``); the largest score
    error."""
    import numpy as np

    from predictionio_tpu_torch.ops.topk import host_topk

    max_err = 0.0
    for (rows, m), (sc, ids) in zip(batches, got):
        exact = U[rows] @ V.T
        if m is not None:
            exact = np.where(m, -np.inf, exact)
        _, top = host_topk(exact, 10)
        for k, ui in enumerate(rows):
            want = [{"item": int(i), "score": float(exact[k, i])}
                    for i in top[k]]
            _same_answers({"itemScores": [
                {"item": int(i), "score": float(s)}
                for i, s in zip(ids[k], sc[k])]}, {"itemScores": want},
                f"distributed leg 3 ({what}): user {ui}")
            err = np.abs(sc[k] - exact[k, ids[k]])
            max_err = max(max_err, float(err.max()))
            check(bool((err <= SHARD_TOL * np.maximum(
                1.0, np.abs(exact[k, ids[k]]))).all()),
                f"distributed leg 3 ({what}): user {ui}'s scores off "
                f"exact by {float(err.max())}")
    return max_err


def sharded_serve_leg(seed: int, port: int, users, items, U, V,
                      unsharded: dict) -> dict:
    """Leg 3: the serve cell's model under ``PIO_SCORER_SHARDS=2``
    (twostage, B2 on both shards), in this process and then through
    ``deploy`` over HTTP against the serve phase's unsharded answers;
    then the same batches under mode ``exact`` with two shards, each
    shard's product on the card."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import build_sharded_scorer
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    n_items, shards = V.shape[0], 2
    cfg = ScorerConfig(mode="twostage", tile_items=TILE,
                       shortlist=SHORTLIST, shards=shards)
    t0 = time.perf_counter()
    scorer = build_sharded_scorer(V, cfg, device=DEV)
    build_s = time.perf_counter() - t0
    st = scorer.status()
    log("distributed: sharded scorer " + json.dumps(
        {k: v for k, v in st.items() if k != "shardStatus"}))
    check(st["activeMode"] == "twostage", f"distributed leg 3: the sharded "
          f"scorer serves {st['activeMode']!r}")
    check(st["maxShardFactorBytes"] <= st["exactBytes"] / 2
          < st["exactBytes"], f"distributed leg 3: a shard holds "
          f"{st['maxShardFactorBytes']} bytes of {st['exactBytes']}")
    rng = np.random.default_rng(seed + 3)
    picks = rng.choice(len(users), size=sum(DIST["batches"]) + 8,
                       replace=False)
    lo, hi = scorer.ranges[1]
    allow = np.sort(rng.choice(np.arange(lo, hi), size=DIST["whitelist"],
                               replace=False))
    mask = np.ones((8, n_items), bool)
    mask[:, allow] = False
    batches, start = [], 0
    for b in DIST["batches"]:
        batches.append((picks[start:start + b], None))
        start += b
    batches.append((picks[start:start + 8], mask))
    synchronize()
    kernels.reset_counts()
    lat, got = [], []
    for rows, m in batches:
        t0 = time.perf_counter()
        got.append(scorer.topk(U[rows], 10, mask=m))
        lat.append(time.perf_counter() - t0)
    launches = kernels.counts()["shortlist"]
    check(launches == shards * len(batches), f"distributed leg 3: "
          f"{launches} B2 launches, expected {shards} x {len(batches)}")
    max_err = _check_sharded_answers(batches, got, U, V, "twostage")
    inproc = {"build_s": build_s, "status": {
        k: v for k, v in st.items() if k != "shardStatus"},
        "shard_scan_ranks": [s["scanRank"] for s in st["shardStatus"]],
        "batches": len(batches), "b2_launches": launches,
        "max_score_abs_err": max_err,
        "batch_ms_p50": float(np.median(np.array(lat) * 1e3))}
    del scorer

    # mode exact, two shards: each shard's rows stay on the card and its
    # product runs there (the card's allocator serves every batch), no
    # host product and no B2
    t0 = time.perf_counter()
    scorer = build_sharded_scorer(
        V, ScorerConfig(mode="exact", shards=shards), device=DEV)
    exact_build_s = time.perf_counter() - t0
    check(scorer.status()["activeMode"] == "exact"
          and len(scorer._v_devices) == shards
          and all(v is not None and v.is_cuda for v in scorer._v_devices),
          "distributed leg 3 (exact): a shard's rows are not on the card")
    synchronize()
    kernels.reset_counts()
    lat, got, card_allocs = [], [], []
    for rows, m in batches:
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        t0 = time.perf_counter()
        got.append(scorer.topk(U[rows], 10, mask=m))
        lat.append(time.perf_counter() - t0)
        card_allocs.append(torch.cuda.memory_stats()[
            "allocation.all.allocated"] - before)
    check(min(card_allocs) >= shards, f"distributed leg 3 (exact): a "
          f"batch made {min(card_allocs)} allocations on the card, fewer "
          f"than its {shards} shards' products")
    check(not any(kernels.counts().values()), f"distributed leg 3 (exact): "
          f"launched {kernels.counts()}")
    exact = {"build_s": exact_build_s, "batches": len(batches),
             "card_allocations_min": min(card_allocs),
             "max_score_abs_err": _check_sharded_answers(
                 batches, got, U, V, "exact"),
             "batch_ms_p50": float(np.median(np.array(lat) * 1e3))}
    log("distributed: sharded exact " + json.dumps(exact))
    del scorer

    # over HTTP: the serve phase's model file, two shards
    env = dict(os.environ, PIO_SCORER_MODE="twostage",
               PIO_SCORER_TILE_ITEMS=str(TILE),
               PIO_SCORER_SHORTLIST=str(SHORTLIST),
               PIO_SCORER_SHARDS=str(shards))
    server = Server(["deploy", "--model", str(WORK / "als_model.npz"),
                     "--port", str(port), "--device", DEV], env,
                    tag="distributed")
    try:
        t0 = time.perf_counter()
        client = Client(server.wait_ready(timeout_s=600))
        ready_s = time.perf_counter() - t0
        _, root, _ = client.call("GET", "/")
        (sst,) = root["scorer"]
        check(sst.get("sharded") and sst["shards"] == shards
              and sst["activeMode"] == "twostage", f"distributed leg 3: "
              f"the deploy's scorer is {sst}")
        check(all(v == 0 for v in root["kernelLaunches"].values()),
              f"distributed leg 3: launch counts not zero before the "
              f"queries: {root['kernelLaunches']}")
        http_lat = []
        for user, want in unsharded.items():
            status, body, dt = client.call("POST", "/queries.json",
                                           {"user": user, "num": 10})
            check(status == 200, f"distributed leg 3: {user} answered "
                  f"{status}")
            http_lat.append(dt)
            _same_answers(body, {"itemScores": want},
                          f"distributed leg 3: {user} over HTTP")
        _, root, _ = client.call("GET", "/")
        http_launches = root["kernelLaunches"]["shortlist"]
        check(http_launches == shards * len(unsharded),
              f"distributed leg 3: {http_launches} B2 launches over HTTP, "
              f"expected {shards} x {len(unsharded)}")
    finally:
        server.stop()
    return {"card": card_line(), "in_process": inproc, "exact": exact,
            "http": {"ready_s": ready_s, "queries": len(unsharded),
                     "b2_launches": http_launches,
                     "p50_ms": float(np.median(np.array(http_lat) * 1e3)),
                     "recall_probe": sst["recallProbe"],
                     "max_shard_factor_bytes": sst["maxShardFactorBytes"],
                     "exact_bytes": sst["exactBytes"]}}


# ---------------------------------------------------------------------------
# operator phase: server.json's key, TLS and serving section, the webhooks,
# export/import, the management commands and the consoles
# ---------------------------------------------------------------------------

#: leg 1's webhook traffic: rate events one request each through each
#: example connector, and the channel leg's events
OPERATOR = dict(hook_events=1000, channel_events=20, users=20)
#: leg 2 on the serve cell's deploy: server.json's serving section (with
#: PIO_BATCH_LINGER_S), the HTTPS clients and their queries, the serial
#: client's rounds over the serve phase's plain users
OPERATOR_SERVE = dict(batch_max=8, inflight=2, linger_s=0.002, clients=64,
                      queries=1280, serial_rounds=2, interval_s=1.0)
OPERATOR_KEY = "operator-smoke-key"
#: the reference's webhook routes' answers (event_server.py:442-456)
_HOOK_OK = "webhooks connection for {} is ok."
_HOOK_UNKNOWN = "webhooks connection for {} is not supported."
#: the reference's own test payloads (tests/test_event_server.py:337-370)
SEGMENTIO_TRACK = {
    "version": "2", "type": "track", "userId": "u42", "event": "Signed Up",
    "timestamp": "2015-01-02T00:30:12.984Z", "properties": {"plan": "pro"},
    "sent_at": "2015-01-02T00:30:12.984Z"}
MAILCHIMP_SUBSCRIBE = {
    "type": "subscribe", "fired_at": "2009-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30"}
#: the events those payloads store, written out by hand
SEGMENTIO_EVENT = {
    "event": "track", "entityType": "user", "entityId": "u42",
    "properties": {"properties": {"plan": "pro"}, "event": "Signed Up"},
    "eventTime": "2015-01-02T00:30:12.984Z"}
MAILCHIMP_EVENT = {
    "event": "subscribe", "entityType": "user", "entityId": "8a25ff1d98",
    "targetEntityType": "list", "targetEntityId": "a6b5da1054",
    "properties": {"email": "api@mailchimp.com", "email_type": "html",
                   "merges": {"EMAIL": "api@mailchimp.com",
                              "FNAME": "MailChimp", "LNAME": "API"},
                   "ip_opt": "10.20.10.30", "ip_signup": "10.20.10.30"},
    "eventTime": "2009-03-26T21:35:57.000Z"}


def _event_bag(app_id: int, channel_id=None):
    """The app's (or its channel's) stored events as a multiset of their
    JSON, creation times aside."""
    from predictionio_tpu_torch.storage.registry import Storage

    return collections.Counter(
        json.dumps({k: v for k, v in e.to_dict().items()
                    if k != "creationTime"}, sort_keys=True)
        for e in Storage.get_events().find(app_id, channel_id))


def _without_ids(bag):
    out = collections.Counter()
    for line, n in bag.items():
        d = json.loads(line)
        d.pop("eventId", None)
        out[json.dumps(d, sort_keys=True)] += n
    return out


def operator_store_copy(db: pathlib.Path) -> None:
    """The lifecycle's store (releases, evaluations), copied for leg 2's
    consoles before the lifecycle removes it."""
    import sqlite3

    dst = WORK / "operator" / "lifecycle.db"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.unlink(missing_ok=True)
    src, out = sqlite3.connect(str(db)), sqlite3.connect(str(dst))
    try:
        src.backup(out)
    finally:
        src.close()
        out.close()


def operator_export(env, work, app: str, app_id: int) -> dict:
    """Leg 1's export, in the lifecycle right after train v2 (before the
    fold-in leg adds events): ``export`` of the app to JSON lines, and
    the app's events at that moment, to hold the import against."""
    t0 = time.perf_counter()
    out = _cli(["export", "--appname", app, "--output",
                str(work / "export.jsonl")], env)
    wall = time.perf_counter() - t0
    source = _event_bag(app_id)
    n = sum(source.values())
    check(out[-1] == f"[INFO] Exported {n} events to "
          f"{work / 'export.jsonl'}.", f"operator: export printed "
          f"{out[-1]!r}, the app holds {n} events")
    return {"events": n, "export_s": wall, "source": source}


def _hook_call(conn, method: str, path: str, body=None, form=None):
    """(status, JSON) of one request on a keep-alive connection: a JSON
    body, or form fields url-encoded."""
    import urllib.parse

    if form is not None:
        data = urllib.parse.urlencode(form).encode()
        ctype = "application/x-www-form-urlencoded"
    else:
        data = json.dumps(body).encode() if body is not None else None
        ctype = "application/json"
    conn.request(method, path, body=data, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _rate_hook(u: int, i: int, r: float, j: int):
    """(JSON payload, form fields, the event they store) of one rate."""
    ts = f"2024-03-01T00:{(j // 60) % 60:02d}:{j % 60:02d}.{j % 1000:03d}Z"
    ctx = {"ip": f"10.0.{j % 256}.{u % 256}", "source": "webhook"}
    payload = {"type": "userActionItem", "userId": f"hu{u}",
               "event": "rate", "itemId": f"hi{i}", "context": ctx,
               "anotherPropertyA": r, "timestamp": ts}
    form = dict(payload, context=json.dumps(ctx),
                anotherPropertyA=repr(r))
    event = {"event": "rate", "entityType": "user", "entityId": f"hu{u}",
             "targetEntityType": "item", "targetEntityId": f"hi{i}",
             "properties": {"context": ctx, "anotherPropertyA": r},
             "eventTime": ts}
    return payload, form, event


def _operator_copy(seed, env, work, variant, m2, export, copy_id) -> dict:
    """Leg 1's import of the export into the second app, its events held
    to the source's, and the train of a variant on it: 40 B1 launches,
    its top-10s v2's (the same rows in the same order, the seeded
    initial factors)."""
    import numpy as np
    import torch

    c = OPERATOR
    report = {}
    t0 = time.perf_counter()
    out = _cli(["import", "--appname", "SmokeCopy", "--input",
                str(work / "export.jsonl")], env)
    report["import_s"] = time.perf_counter() - t0
    check(out[-1] == f"[INFO] Imported {export['events']} events.",
          f"operator: import printed {out[-1]!r}")
    check(_event_bag(copy_id) == export["source"], "operator: the imported "
          "app's events differ from the exported app's")
    copy_variant = work / "engine-copy.json"
    spec = json.loads(pathlib.Path(variant).read_text())
    spec["id"] = "operator-copy"
    spec["datasource"]["params"]["appName"] = "SmokeCopy"
    copy_variant.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    line = json.loads(_cli(["train", "--variant", str(copy_variant),
                            "--device", DEV], env)[-1])
    report["train_s"] = time.perf_counter() - t0
    report["train_launches"] = line["launches"]
    want = 2 * ML100K["iters"]
    check(line["launches"]["spd_solve"] == want, f"operator: the copy's "
          f"train launched B1 {line['launches']['spd_solve']} times, "
          f"expected {want}")
    mc = _stored_model(line["instance"])
    U2, V2 = _factors_on_card(m2, "operator v2")
    Uc, Vc = _factors_on_card(mc, "operator copy")
    known_c = set(mc.user_vocab.tolist())
    picks = [str(m2.user_vocab[i]) for i in np.random.default_rng(
        seed + 19).choice(len(m2.user_vocab), size=c["users"],
                          replace=False)]
    err = 0.0
    for user in picks:
        check(user in known_c, f"operator: {user} is missing from the "
              "copy's model")
        vals, idx = torch.topk(Vc @ Uc[mc.user_index(user)], 10)
        body = {"itemScores": [{"item": str(mc.item_vocab[j]),
                                "score": float(v)}
                               for j, v in zip(idx.tolist(),
                                               vals.tolist())]}
        err = max(err, _top10_err(U2, V2, m2, user, body, "operator copy"))
    for user in ("nobody", f"u{ML100K['n_users'] + 1000}"):
        check(user not in known_c
              and user not in set(m2.user_vocab.tolist()),
              f"operator: {user} is known to a model")
    report["copy_max_score_err"] = err
    return report


def _operator_hooks(seed, env, es_port: int, apps_ids: dict) -> dict:
    """Leg 1's webhooks against direct POSTs, then the channel and key
    commands on the webhook app at the running event server."""
    import http.client

    import numpy as np

    from predictionio_tpu_torch.storage.registry import Storage

    c = OPERATOR
    (hook_id, hook_key), (direct_id, direct_key) = (apps_ids["HookApp"],
                                                    apps_ids["DirectApp"])
    conn = http.client.HTTPConnection("localhost", es_port, timeout=120)
    rng = np.random.default_rng(seed + 20)
    hook_lat, direct_lat = [], []
    t_hooks = time.perf_counter()
    for j in range(c["hook_events"]):
        payload, form, event = _rate_hook(
            int(rng.integers(0, 200)), int(rng.integers(0, 300)),
            float(rng.integers(1, 6)), j)
        name = "examplejson" if j % 2 == 0 else "exampleform"
        t0 = time.perf_counter()
        status, body = _hook_call(
            conn, "POST", f"/webhooks/{name}.json?accessKey={hook_key}",
            *((payload, None) if name == "examplejson" else (None, form)))
        hook_lat.append(time.perf_counter() - t0)
        check(status == 201, f"operator: {name} answered {status} {body}")
        t0 = time.perf_counter()
        status, body = _hook_call(
            conn, "POST", f"/events.json?accessKey={direct_key}", event)
        direct_lat.append(time.perf_counter() - t0)
        check(status == 201, f"operator: a direct POST answered {status}")
    for name, payload, form, event in (
            ("segmentio", SEGMENTIO_TRACK, None, SEGMENTIO_EVENT),
            ("mailchimp", None, MAILCHIMP_SUBSCRIBE, MAILCHIMP_EVENT)):
        status, body = _hook_call(
            conn, "POST", f"/webhooks/{name}.json?accessKey={hook_key}",
            payload, form)
        check(status == 201, f"operator: {name} answered {status} {body}")
        status, _ = _hook_call(
            conn, "POST", f"/events.json?accessKey={direct_key}", event)
        check(status == 201, "operator: a direct POST failed")
    hooks_s = time.perf_counter() - t_hooks
    for name, want in (
            ("examplejson", (200, {"message": _HOOK_OK.format(
                "examplejson")})),
            ("mailchimp", (200, {"message": _HOOK_OK.format("mailchimp")})),
            ("nope", (404, {"message": _HOOK_UNKNOWN.format("nope")}))):
        got = _hook_call(conn, "GET", f"/webhooks/{name}.json?accessKey="
                                      f"{hook_key}")
        check(got == want, f"operator: GET /webhooks/{name}.json answered "
              f"{got}")
    status, body = _hook_call(
        conn, "POST", f"/webhooks/nope.json?accessKey={hook_key}", {})
    check((status, body) == (404, {"message": _HOOK_UNKNOWN.format(
        "nope")}), f"operator: an unknown connector answered {status}")
    hooked = _without_ids(_event_bag(hook_id))
    direct = _without_ids(_event_bag(direct_id))
    n_hooked = c["hook_events"] + 2
    check(sum(hooked.values()) == n_hooked and hooked == direct,
          f"operator: {sum(hooked.values())} webhook events stored, "
          f"{sum((hooked & direct).values())} of them as the direct "
          f"POSTs' {sum(direct.values())}")
    report = {"events": n_hooked, "hooks_s": hooks_s,
              "hook_p50_ms": 1e3 * float(np.percentile(hook_lat, 50)),
              "direct_p50_ms": 1e3 * float(np.percentile(direct_lat, 50))}

    # the channel and key commands ------------------------------------------
    channels = Storage.get_meta_data_channels()
    _cli(["app", "channel-new", "HookApp", "side"], env)
    side = next(ch.id for ch in channels.get_by_appid(hook_id)
                if ch.name == "side")
    for j in range(c["channel_events"]):
        payload, _, _ = _rate_hook(j, j, 3.0, 10_000 + j)
        status, _ = _hook_call(
            conn, "POST", f"/webhooks/examplejson.json?accessKey="
                          f"{hook_key}&channel=side", payload)
        check(status == 201, f"operator: a channel webhook answered "
              f"{status}")
    check(sum(_event_bag(hook_id, side).values()) == c["channel_events"],
          "operator: the side channel lacks its events")
    _cli(["app", "data-delete", "HookApp", "--channel", "side", "--force"],
         env)
    check(sum(_event_bag(hook_id, side).values()) == 0
          and sum(_event_bag(hook_id).values()) == n_hooked,
          "operator: data-delete --channel left the side channel "
          f"{sum(_event_bag(hook_id, side).values())} events, the default "
          f"{sum(_event_bag(hook_id).values())}")
    _cli(["app", "channel-delete", "HookApp", "side", "--force"], env)
    check(not channels.get_by_appid(hook_id), "operator: channel-delete "
          "left the channel")
    spare = _cli(["accesskey", "new", "HookApp"], env)[-1].split()[-1]
    payload, _, _ = _rate_hook(1, 1, 5.0, 20_000)
    status, _ = _hook_call(conn, "POST", f"/webhooks/examplejson.json?"
                           f"accessKey={spare}", payload)
    check(status == 201, f"operator: the new key answered {status}")
    _cli(["accesskey", "delete", spare], env)
    status, body = _hook_call(conn, "POST", f"/webhooks/examplejson.json?"
                              f"accessKey={spare}", payload)
    check((status, body) == (401, {"message": "Invalid accessKey."}),
          f"operator: the deleted key answered {status} {body}")
    conn.close()
    return report


def _operator_small(env, work) -> dict:
    """``version``, ``run`` of a module and ``shell`` fed a line."""
    from predictionio_tpu_torch import __version__
    from predictionio_tpu_torch.storage.registry import Storage

    t0 = time.perf_counter()
    out = _cli(["version"], env)
    check(out == [__version__], f"operator: version printed {out}")
    (work / "operator_mod.py").write_text(
        "import sys\nprint('operator module', sys.argv[1:])\n")
    run_env = dict(env, PYTHONPATH=os.pathsep.join(
        [str(work)] + [p for p in [env.get("PYTHONPATH")] if p]))
    out = _cli(["run", "operator_mod", "a", "--b"], run_env)
    check(out[-1] == "operator module ['a', '--b']",
          f"operator: run printed {out}")
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "shell"],
        input="print('shell', sorted(a.name for a in "
              "Storage.get_meta_data_apps().get_all()))\n",
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=300)
    names = sorted(a.name for a in Storage.get_meta_data_apps().get_all())
    check(proc.returncode == 0 and "shell [" in proc.stdout
          and "'SmokeApp'" in proc.stdout, f"operator: shell printed "
          f"{proc.stdout[-500:]} {proc.stderr[-500:]} (apps {names})")
    return {"small_s": time.perf_counter() - t0}


def operator_cli_leg(seed, env, work, variant, key: str, es_port: int,
                     m2, export: dict) -> dict:
    """Leg 1 of the operator phase, inside the lifecycle on its store and
    event server: the import of the export into a second app and a train
    of it, the webhooks with the channel and key commands, and the small
    commands, the three at once (their apps are their own); then ``app
    delete --force`` of the three apps it made (no event, key or channel
    left)."""
    from predictionio_tpu_torch.storage.registry import Storage

    apps = Storage.get_meta_data_apps()
    made = {}
    for name in ("SmokeCopy", "HookApp", "DirectApp"):
        out = _cli(["app", "new", name], env)
        made[name] = (apps.get_by_name(name).id,
                      next(x for x in out if "Access Key:" in x).split()[-1])
    copy, hooks, small = _together(
        lambda: _operator_copy(seed, env, work, variant, m2, export,
                               made["SmokeCopy"][0]),
        lambda: _operator_hooks(seed, env, es_port, made),
        lambda: _operator_small(env, work))
    _cli(["app", "show", "HookApp"], env)
    events = Storage.get_events()
    for name, (app_id, _) in made.items():
        _cli(["app", "delete", name, "--force"], env)
        try:
            left = sum(1 for _ in events.find(app_id))
        except Exception:        # noqa: BLE001 — the table is gone
            left = 0
        check(apps.get_by_name(name) is None
              and not Storage.get_meta_data_access_keys().get_by_appid(
                  app_id)
              and not Storage.get_meta_data_channels().get_by_appid(app_id)
              and left == 0,
              f"operator: app delete left {name}'s rows ({left} events)")
    report = {"events": export["events"], "export_s": export["export_s"],
              **copy, "webhooks": hooks, **small}
    log("operator: leg 1 " + json.dumps(report))
    return report


class TlsClient(Client):
    """A keep-alive HTTPS connection to a self-signed certificate."""

    def __init__(self, port: int):
        import http.client
        import ssl

        self.conn = http.client.HTTPSConnection(
            "localhost", port, timeout=300,
            context=ssl._create_unverified_context())


def _self_signed(home: pathlib.Path):
    """(certfile, keyfile) made by ``openssl req -x509``, or None when
    the host has no openssl."""
    cert, key = home / "cert.pem", home / "key.pem"
    try:
        p = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=localhost"], capture_output=True, timeout=120)
    except FileNotFoundError:
        return None
    return (str(cert), str(key)) if p.returncode == 0 else None


def _same_top10(got, want, tag: str) -> float:
    """A served top-10 against the serve phase's answer for the user: ids
    equal up to ties within 1e-4, scores within 1e-4."""
    import numpy as np

    check(len(got) == len(want), f"{tag}: {len(got)} items, the serve "
          f"phase answered {len(want)}")
    gv = np.array([s["score"] for s in got])
    wv = np.array([s["score"] for s in want])
    err = np.abs(gv - wv)
    check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(wv))).all()),
          f"{tag}: scores differ from the serve phase's by {err.max()}")
    wid = [s["item"] for s in want]
    for a, b, v in zip([s["item"] for s in got], wid, wv):
        tied = np.abs(wv - v) <= 1e-4 * max(1.0, abs(v))
        check(a == b or a in {wid[j] for j in np.flatnonzero(tied)},
              f"{tag}: served {a} where the serve phase served {b}")
    return float(err.max()) if len(err) else 0.0


def _console(args, env, tag: str):
    return Server([*args, "--ip", "localhost", "--port", "0", "--device",
                   DEV], env, tag=tag)


def _metrics_buckets(text: bytes, name: str) -> dict:
    out = {}
    for line in text.decode().splitlines():
        if line.startswith(f"{name}_bucket{{le="):
            le = line.split('"')[1]
            out[le] = float(line.rsplit(" ", 1)[1])
        elif line.startswith(f"{name}_count "):
            out["count"] = float(line.rsplit(" ", 1)[1])
    return out


def operator_serve_leg(seed: int, shape: dict, users, plain_answers: dict,
                       serve: dict) -> dict:
    """Leg 2 of the operator phase, after obs, on the serve phase's model
    file: ``deploy`` under a server.json with a key, TLS (a certificate
    of ``openssl req -x509``) and ``serving`` {batchMax 8, batchInflight
    2}, ``PIO_BATCH_LINGER_S``, durable telemetry and the anatomy; its
    answers over HTTPS against the serve phase's, B2 launches, the
    micro-batches, the key and the refused plain request; ``analyze``
    over its telemetry; ``adminserver`` and ``dashboard`` over the
    lifecycle's store (copied there by the lifecycle) under the same
    server.json."""
    import numpy as np

    from predictionio_tpu_torch.obs.anatomy import SERVING_WALL_STAGES

    o = OPERATOR_SERVE
    home = WORK / "operator" / "home"
    shutil.rmtree(home, ignore_errors=True)
    (home / "conf").mkdir(parents=True)
    tls = _self_signed(home)
    conf = {"key": OPERATOR_KEY,
            "serving": {"batchMax": o["batch_max"],
                        "batchInflight": o["inflight"]}}
    if tls is None:
        log("operator: tls: no openssl on this host")
    else:
        conf["ssl"] = {"enabled": True, "certfile": tls[0],
                       "keyfile": tls[1]}
    (home / "conf" / "server.json").write_text(json.dumps(conf))
    store = WORK / "operator" / "lifecycle.db"
    env = dict(os.environ, PIO_HOME=str(home), PIO_SCORER_MODE="twostage",
               PIO_SCORER_TILE_ITEMS=str(TILE),
               PIO_SCORER_SHORTLIST=str(SHORTLIST),
               PIO_BATCH_LINGER_S=str(o["linger_s"]), PIO_ANATOMY="1",
               PIO_TELEMETRY="1",
               PIO_TELEMETRY_INTERVAL_S=str(o["interval_s"]),
               PIO_STORAGE_SOURCES_OPS_TYPE="sqlite",
               PIO_STORAGE_SOURCES_OPS_PATH=str(store),
               **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
                  for r, name in (("METADATA", "pio_meta"),
                                  ("EVENTDATA", "pio_event"),
                                  ("MODELDATA", "pio_model"))
                  for k, v in (("NAME", name), ("SOURCE", "OPS"))})
    mk = TlsClient if tls else Client
    report = {"tls": tls is not None}
    t_start = time.perf_counter()
    server = Server(["deploy", "--model", str(WORK / "als_model.npz"),
                     "--port", "0", "--device", DEV], env, tag="operator")
    # the consoles start while the deploy loads its model
    admin = _console(["adminserver"], env, "operator admin")
    dash = _console(["dashboard"], env, "operator dashboard")
    try:
        port = server.wait_ready(timeout_s=600)
        client = mk(port)
        status, root, _ = client.call("GET", "/")
        report["deploy_to_first_answer_s"] = time.perf_counter() - t_start
        t_queries = time.perf_counter()
        check(status == 200, f"operator: GET / answered {status}")
        scorer = root["scorer"][0]
        check(scorer["activeMode"] == "twostage"
              and (scorer["scanRank"], scorer["tileItems"],
                   scorer["tiles"]) == (shape["R"], shape["T"],
                                        shape["nt"]),
              f"operator: the deploy serves {scorer}")
        check(all(v == 0 for v in root["kernelLaunches"].values()),
              f"operator: launches before the queries "
              f"{root['kernelLaunches']}")
        # one client, the serve phase's plain users in turn ----------------
        plain = list(plain_answers.items())
        serial_lat, err = [], 0.0
        for _ in range(o["serial_rounds"]):
            for user, want in plain:
                status, body, dt = client.call(
                    "POST", "/queries.json", {"user": user, "num": 10})
                check(status == 200, f"operator: a query answered {status}")
                serial_lat.append(dt * 1e3)
                err = max(err, _same_top10(body["itemScores"], want,
                                           f"operator {user}"))
        # 64 HTTPS clients ------------------------------------------------
        per = -(-o["queries"] // o["clients"])
        lat, failures, errs, lock = [], [], [err], threading.Lock()

        def run(k):
            c = mk(port)
            for q in range(per):
                user, want = plain[(k + q) % len(plain)]
                try:
                    status, body, dt = c.call(
                        "POST", "/queries.json", {"user": user, "num": 10})
                    check(status == 200, f"answered {status}")
                    e = _same_top10(body["itemScores"], want,
                                    f"operator {user}")
                except Exception as ex:     # noqa: BLE001 — reported
                    failures.append(repr(ex))
                    return
                with lock:
                    lat.append(dt * 1e3)
                    errs.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(o["clients"])]
        for t in threads:
            t.start()
        _join(threads, "operator")
        conc_s = time.perf_counter() - t0
        check(not failures, f"operator: {len(failures)} HTTPS clients "
              f"failed, first {failures[:3]}")
        n_sent = len(serial_lat) + len(lat)
        report["queries_s"] = time.perf_counter() - t_queries
        _, root1, _ = client.call("GET", "/")
        b2 = root1["kernelLaunches"]["shortlist"]
        check(b2 > 0, "operator: B2 never launched")
        status, metrics, _ = client.call("GET", "/metrics", raw=True)
        sizes = _metrics_buckets(metrics, "pio_batch_size")
        check(sizes.get(str(o["batch_max"])) == sizes.get("count")
              and sizes.get("count", 0) > 0,
              f"operator: micro-batches above {o['batch_max']}: {sizes}")
        check(b2 == root1["microBatches"]["batches"], f"operator: B2 "
              f"launched {b2} times for {root1['microBatches']['batches']} "
              "micro-batches")
        # the key and the plain listener ---------------------------------
        status, body, _ = client.call("POST", "/stop")
        check(status == 401, f"operator: /stop without the key answered "
              f"{status}")
        if tls:
            refused = False
            try:
                Client(port).call("GET", "/")
            except Exception:       # noqa: BLE001 — the handshake fails
                refused = True
            check(refused, "operator: a plain-HTTP request was answered")
        t0 = time.perf_counter()
        status, _, _ = client.call("POST",
                                   f"/stop?accessKey={OPERATOR_KEY}")
        check(status == 200 and server.proc.wait(timeout=120) == 0,
              "operator: the deploy did not stop on its key")
        report["stop_s"] = time.perf_counter() - t0
        report.update({
            "queries": n_sent, "b2_launches": b2,
            "micro_batches": root1["microBatches"]["batches"],
            "batch_sizes": {k: v for k, v in sizes.items()},
            "max_score_abs_err": max(errs),
            "https_serial": _lat(serial_lat),
            "https_clients": dict(_lat(lat), clients=o["clients"],
                                  qps=len(lat) / conc_s),
            "http_serve_phase": {
                "plain_p50_ms": serve["p50_ms_by_kind"]["plain"],
                "p50_ms": serve["query_p50_ms"],
                "p99_ms": serve["query_p99_ms"]}})
        # analyze over the deploy's telemetry -----------------------------
        t0 = time.perf_counter()
        doc = json.loads(_cli(["analyze", "--json", "--since", "10m",
                               "--dir", str(home / "telemetry")], env)[-1])
        report["analyze_s"] = time.perf_counter() - t0
        counts = {s: v["count"] for s, v in doc["stages"].items()}
        check(set(SERVING_WALL_STAGES) <= set(counts)
              and all(counts[s] == n_sent for s in SERVING_WALL_STAGES),
              f"operator: analyze counts {counts}, sent {n_sent}")
        report["analyze_p99_composition"] = doc["p99Composition"]
        # the consoles ------------------------------------------------------
        t0 = time.perf_counter()
        report["consoles"] = operator_consoles(admin, dash, mk, port)
        report["consoles"]["checks_s"] = time.perf_counter() - t0
        log("operator: leg 2 " + json.dumps(report))
        return report
    finally:
        for proc in (server, admin, dash):
            proc.stop()


def operator_consoles(admin, dash, mk, deploy_port: int) -> dict:
    """``adminserver`` and ``dashboard`` over the lifecycle's store and
    the deploy's telemetry root: the admin app round-trip and releases,
    the dashboard's key, console, evaluations and history."""
    a = mk(admin.wait_ready(timeout_s=300))
    d_port = dash.wait_ready(timeout_s=300)
    d = mk(d_port)
    status, body, _ = a.call("POST", "/cmd/app", {"name": "OperatorAdmin"})
    check(status == 201 and body["accessKey"], f"admin: create answered "
          f"{status} {body}")
    _, listing, _ = a.call("GET", "/cmd/app")
    check("OperatorAdmin" in [x["name"] for x in listing["apps"]],
          f"admin: the app is not listed: {listing}")
    status, _, _ = a.call("DELETE", "/cmd/app/OperatorAdmin")
    _, listing2, _ = a.call("GET", "/cmd/app")
    check(status == 200 and "OperatorAdmin" not in [
        x["name"] for x in listing2["apps"]], "admin: delete failed")
    _, rel, _ = a.call("GET", "/cmd/releases?engineVariant=default")
    versions = sorted(r["version"] for r in rel["releases"])
    check(versions[:2] == [1, 2], f"admin: releases {versions}")
    status, _, _ = d.call("GET", "/evaluations.json")
    check(status == 401, f"dashboard: no key answered {status}")
    status, evals, _ = d.call("GET", f"/evaluations.json?accessKey="
                                     f"{OPERATOR_KEY}")
    check(status == 200 and len(evals) >= 2, f"dashboard: evaluations "
          f"{status} {evals}")
    status, page, _ = d.call("GET", f"/?accessKey={OPERATOR_KEY}",
                             raw=True)
    page = page.decode()
    for want in ("<h2>Releases</h2>", "<h2>SLO burn (trailing hour)</h2>",
                 "<h2>Capacity ledger (trailing hour)</h2>",
                 "recommendation:engine/default", "<td>v2</td>"):
        check(want in page, f"dashboard: the console lacks {want!r}")
    status, series, _ = d.call("GET", "/history/series.json")
    procs = {s["labels"].get("process", "") for s in series["series"]}
    check(status == 200 and any(p.startswith("query_server")
                                for p in procs),
          f"dashboard: /history/series.json names {sorted(procs)}")
    return {"admin_apps": len(listing["apps"]), "releases": versions,
            "evaluations": len(evals), "history_processes": sorted(procs),
            "console_bytes": len(page)}


def operator_phase(seed: int, shape: dict, users, plain_answers: dict,
                   serve: dict, cli: dict) -> dict:
    """Leg 2 here; leg 1's report from the lifecycle."""
    t0 = time.perf_counter()
    report = {"serve": operator_serve_leg(seed, shape, users,
                                          plain_answers, serve),
              "cli": cli}
    report["serve"]["leg_s"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# evlog phase
# ---------------------------------------------------------------------------

#: leg 1: ML-1M's rating count (6,040 users x 3,706 items) through both
#: codecs, in appends of ``batch`` records, event times over 30 days
EVLOG_CODEC = dict(records=1_000_209, n_users=6040, n_items=3706,
                   batch=20_000, days=30, seed=11)
#: leg 2: the lifecycle's ML-100k ratings over REST into an evlog store,
#: its train, a deploy and the queries held to a sqlite-trained twin
EVLOG = dict(queries=100, seed=40)
#: leg 2's answers against the twin's exact top-10: scores within this
#: (times max(1, |score|)) and ids equal up to ties within it; the two
#: trains read the same rows in the same order, and differ only in the
#: order of the Gramian assembly's f32 atomics
EVLOG_TOL = 1e-4
#: an event JSON of the lifecycle's shape, as ``Event.to_json`` writes it
_EVLOG_PAYLOAD = ('{{"creationTime": "{t}", "entityId": "u{u}", '
                  '"entityType": "user", "event": "rate", "eventId": '
                  '"{eid}", "eventTime": "{t}", "properties": {{"rating": '
                  '{r}}}, "targetEntityId": "i{i}", "targetEntityType": '
                  '"item"}}')


def _same_file(a: pathlib.Path, b: pathlib.Path) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _postgres_gate() -> str:
    """The port's postgres source on this machine, which has neither
    driver: the store raises ``StorageError`` naming both (the gate runs
    before any connection)."""
    from predictionio_tpu_torch.storage.base import StorageError
    from predictionio_tpu_torch.storage.registry import Storage

    Storage.configure({
        "sources": {"PG": {"TYPE": "postgres",
                           "URL": "postgresql://localhost/pio"}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "PG"} for r in
                         ("METADATA", "EVENTDATA", "MODELDATA")}})
    try:
        Storage.get_events()
    except StorageError as e:
        msg = str(e)
    else:
        msg = ""
    finally:
        Storage.reset()
    check("psycopg2" in msg and "pg8000" in msg,
          f"evlog: the postgres source without a driver gave {msg!r}")
    return msg


def evlog_codec_leg(seed: int) -> dict:
    """The evlog phase's leg 1, host work only (module docstring)."""
    import numpy as np

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.native import evlog

    c = EVLOG_CODEC
    work = WORK / "evlog_codec"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    report = {"records": c["records"], "card": card_line(),
              "postgres_gate": _postgres_gate()}
    try:
        t0 = time.perf_counter()
        lib = evlog.build()
        codecs = {"native": evlog.get_codec("native"),
                  "python": evlog.PyCodec()}
        check(codecs["native"].name == "native", "evlog: the native codec "
              f"is {codecs['native'].name}")
        report["build_s"] = time.perf_counter() - t0
        report["library"] = str(lib.relative_to(ROOT))
        report["source"] = str(evlog.SOURCE.relative_to(ROOT))

        t0 = time.perf_counter()
        n = c["records"]
        rng = np.random.default_rng(c["seed"] + seed)
        users = rng.integers(0, c["n_users"], n)
        items = rng.integers(0, c["n_items"], n)
        ratings = rng.integers(1, 6, n)
        times = BASE_MS + np.sort(rng.integers(0, c["days"] * 86_400_000, n))
        ids = rng.bytes(16 * n)
        hashes = [evlog.entity_hash("user", f"u{u}")
                  for u in range(c["n_users"])]
        # isoformat(timespec="milliseconds") of UTC times, vectorized
        whens = [w + "+00:00" for w in np.datetime_as_string(
            times.astype("datetime64[ms]"), unit="ms").tolist()]
        records = []
        for j, (u, i, r, ms, when) in enumerate(zip(
                users.tolist(), items.tolist(), ratings.tolist(),
                times.tolist(), whens)):
            rid = ids[16 * j:16 * j + 16]
            records.append((ms, hashes[u], 0, rid, _EVLOG_PAYLOAD.format(
                t=when, u=u, eid=rid.hex(), r=float(r), i=i).encode()))
        for j in rng.choice(n, 64, replace=False).tolist():
            p = records[j][4].decode()
            check(Event.from_json(p).to_json() == p,
                  f"evlog: payload {j} is not Event.to_json's: {p}")
        report["make_s"] = time.perf_counter() - t0

        paths = {k: work / f"{k}.evlog" for k in codecs}
        per = {}
        for name, codec in codecs.items():
            codec.create(str(paths[name]))
            t0 = time.perf_counter()
            for s in range(0, n, c["batch"]):
                codec.append(str(paths[name]), records[s:s + c["batch"]])
            per[name] = {"append_s": time.perf_counter() - t0}
        size = paths["native"].stat().st_size
        check(_same_file(paths["native"], paths["python"]),
              f"evlog: the native and Python codecs wrote different files "
              f"({paths['native'].stat().st_size} and "
              f"{paths['python'].stat().st_size} bytes)")
        report["file_bytes"] = size
        report["byte_identical"] = True

        lo, hi = (int(x) for x in np.quantile(times, [0.25, 0.75]))
        want_window = int(((times >= lo) & (times < hi)).sum())
        top_user = int(np.bincount(users).argmax())
        want_entity = int((users == top_user).sum())
        for name, codec in codecs.items():
            other = str(paths["python" if name == "native" else "native"])
            t0 = time.perf_counter()
            got = codec.scan(other)
            scan_s = time.perf_counter() - t0
            check(len(got) == n and got[0] == records[0]
                  and got[-1] == records[-1],
                  f"evlog: {name} read {len(got)} records of {n}")
            del got
            t0 = time.perf_counter()
            window = codec.scan(other, lo, hi)
            window_s = time.perf_counter() - t0
            check(len(window) == want_window, f"evlog: {name}'s window "
                  f"scan gave {len(window)}, expected {want_window}")
            t0 = time.perf_counter()
            ent = codec.scan(other, ehash=hashes[top_user])
            entity_s = time.perf_counter() - t0
            check(len(ent) == want_entity, f"evlog: {name}'s entity scan "
                  f"gave {len(ent)}, expected {want_entity}")
            t0 = time.perf_counter()
            verified = codec.verify(other)
            verify_s = time.perf_counter() - t0
            check(verified == n, f"evlog: {name} verified {verified}")
            mb = size / 1e6
            per[name].update({
                "append_MB_s": mb / per[name]["append_s"],
                "scan_s": scan_s, "scan_MB_s": mb / scan_s,
                "window_s": window_s, "window_records": want_window,
                "entity_s": entity_s, "entity_records": want_entity,
                "verify_s": verify_s, "verify_MB_s": mb / verify_s})
            log(f"evlog: codec {name} " + json.dumps(per[name]))
        report["codecs"] = per
        return report
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _evlog_config(work: pathlib.Path):
    """(the CLI's environment, the in-process config) of leg 2's store:
    events in an evlog directory under the native codec, metadata in
    sqlite, model blobs on ``localfs``."""
    sources = {"META": {"TYPE": "sqlite", "PATH": str(work / "pio.db")},
               "EVLOG": {"TYPE": "evlog", "PATH": str(work / "evlog"),
                         "CODEC": "native"},
               "MODELS": {"TYPE": "localfs", "PATH": str(work / "models")}}
    repos = {"METADATA": "META", "EVENTDATA": "EVLOG", "MODELDATA": "MODELS"}
    env = dict(os.environ)
    for name, src in sources.items():
        for k, v in src.items():
            env[f"PIO_STORAGE_SOURCES_{name}_{k}"] = v
    for repo, src in repos.items():
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = "pio"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = src
    return env, {"sources": sources, "repositories": {
        r: {"NAME": "pio", "SOURCE": s} for r, s in repos.items()}}


def evlog_leg(seed: int, port: int, work) -> dict:
    """The evlog phase's leg 2, end to end on its own store (module
    docstring)."""
    import numpy as np

    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.storage.registry import Storage

    c, e = ML100K, EVLOG
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env, config = _evlog_config(work)
    Storage.configure(config)
    eventstore.clear_cache()
    report = {"card": card_line()}
    servers = []
    t_leg = time.perf_counter()
    try:
        events_srv = Server(["eventserver", "--ip", "127.0.0.1", "--port",
                             "0"], env, tag="evlog")
        servers.append(events_srv)
        es_port = events_srv.wait_ready(timeout_s=120)
        out = _cli(["app", "new", "EvlogApp"], env)
        key = next(x for x in out if "Access Key:" in x).split()[-1]
        app_id = Storage.get_meta_data_apps().get_by_name("EvlogApp").id
        store = Storage.get_events()
        check(store.client.codec.name == "native",
              f"evlog: the store's codec is {store.client.codec.name}")

        # the ML-100k ratings over REST: write buffer -> insert_batch
        users, items, ratings = synthetic_ratings(
            c["n_users"], c["n_items"], c["nnz"], seed=seed + e["seed"])
        wire = _wire(users.tolist(), items.tolist(), ratings.tolist(),
                     ["rate"] * len(ratings))
        ids, lat, wall = ingest(es_port, key, wire)
        n = len(wire)
        stored = store.find_columns(app_id, columns=("event_id",),
                                    ordered=False)["event_id"]
        check(len(stored) == n and set(stored.tolist()) == set(ids),
              f"evlog: the store holds {len(stored)} rows, "
              f"{len(set(stored.tolist()) & set(ids))} of the acknowledged "
              f"{n} ids")
        report["ingest"] = {
            "events": n, "events_per_s": n / wall, "wall_s": wall,
            "request_p50_ms": float(np.percentile(lat, 50)),
            "request_p99_ms": float(np.percentile(lat, 99))}

        # one event deleted over REST, then 404
        gone = int(np.random.default_rng(seed + e["seed"]).integers(n))
        client = Client(es_port)
        status, _, _ = client.call(
            "DELETE", f"/events/{ids[gone]}.json?accessKey={key}")
        check(status == 200, f"evlog: DELETE answered {status}")
        status, _, _ = client.call(
            "GET", f"/events/{ids[gone]}.json?accessKey={key}")
        check(status == 404, f"evlog: GET of the deleted event answered "
              f"{status}")

        # export: the posted bag less the deleted event
        t0 = time.perf_counter()
        _cli(["export", "--appname", "EvlogApp", "--output",
              str(work / "export.jsonl")], env)
        report["export_s"] = time.perf_counter() - t0
        fields = ("event", "entityType", "entityId", "targetEntityType",
                  "targetEntityId", "properties")
        exported = [json.loads(x) for x in
                    (work / "export.jsonl").read_text().splitlines()]
        got_bag = collections.Counter(
            json.dumps([x.get(k, {} if k == "properties" else None)
                        for k in fields]) for x in exported)
        want_bag = collections.Counter(
            json.dumps([w.get(k, {} if k == "properties" else None)
                        for k in fields])
            for j, w in enumerate(wire) if j != gone)
        check(got_bag == want_bag and sorted(x["eventId"] for x in exported)
              == sorted(ids[:gone] + ids[gone + 1:]),
              f"evlog: export holds {len(exported)} events, not the "
              f"{n - 1} posted less the deleted one")
        report["exported"] = len(exported)

        # train from the log: B1 2 x iters in the train's process
        variant = work / "engine.json"
        variant.write_text(json.dumps({
            "id": "default", "engineFactory": RECOMMENDATION,
            "datasource": {"params": {"appName": "EvlogApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": c["rank"], "numIterations": c["iters"],
                "lambda": c["reg"]}}]}))

        def train(tenv, tag):
            t0 = time.perf_counter()
            line = json.loads(_cli(["train", "--variant", str(variant),
                                    "--device", DEV], tenv)[-1])
            line["wall_s"] = time.perf_counter() - t0
            check(line["launches"]["spd_solve"] == 2 * c["iters"],
                  f"evlog: the {tag} train launched B1 "
                  f"{line['launches']['spd_solve']} times, expected "
                  f"{2 * c['iters']}")
            check(line["nnz"] == n - 1, f"evlog: the {tag} train read "
                  f"{line['nnz']} ratings of {n - 1}")
            log(f"evlog: train ({tag}) " + json.dumps(line))
            return line

        report["train"] = train(env, "evlog")
        m_ev = _stored_model(report["train"]["instance"])
        t_split = report["train"]
        report["train_split"] = {
            "wall_s": t_split["wall_s"], "train_s": t_split["train_s"],
            "read_s": t_split["ingest"]["scan_s"],
            "build_s": t_split["build_s"]}

        # the twin: the same events, in the log's order, on sqlite
        t0 = time.perf_counter()
        events = list(store.find(app_id))
        twin_env = smoke_store(work / "twin")
        twin_id = _new_app("EvlogApp")
        for s in range(0, len(events), 20_000):
            Storage.get_events().insert_batch(events[s:s + 20_000], twin_id)
        report["twin_copy_s"] = time.perf_counter() - t0
        report["twin_train"] = train(twin_env, "sqlite twin")
        m_sql = _stored_model(report["twin_train"]["instance"])
        del events
        Storage.configure(config)
        eventstore.clear_cache()
        check(list(m_ev.user_vocab) == list(m_sql.user_vocab)
              and list(m_ev.item_vocab) == list(m_sql.item_vocab),
              "evlog: the two trains' vocabularies differ")
        report["factor_max_abs_diff"] = float(max(
            np.abs(np.asarray(m_ev.U) - np.asarray(m_sql.U)).max(),
            np.abs(np.asarray(m_ev.V) - np.asarray(m_sql.V)).max()))

        # deploy under twostage, queries through B2
        denv = dict(env, PIO_SCORER_MODE="twostage",
                    PIO_SCORER_SHORTLIST=str(SHORTLIST))
        t0 = time.perf_counter()
        server = Server(["deploy", "--variant", str(variant), "--port",
                         str(port), "--device", DEV, "--accesskey", key],
                        denv, tag="evlog")
        servers.append(server)
        qc = Client(server.wait_ready(timeout_s=300))
        report["deploy_up_s"] = time.perf_counter() - t0
        _, root0, _ = qc.call("GET", "/")
        sc = root0["scorer"][0]
        check(root0["engineInstance"]["id"] == report["train"]["instance"]
              and sc["activeMode"] == "twostage",
              f"evlog: deploy serves {root0['engineInstance']} under "
              f"{sc['activeMode']}")
        picks = [str(m_sql.user_vocab[i]) for i in np.random.default_rng(
            seed + e["seed"] + 1).choice(len(m_sql.user_vocab),
                                         size=e["queries"], replace=False)]
        U, V = _factors_on_card(m_sql, "evlog twin")
        max_err, qlat = 0.0, []
        for user in picks:
            status, body, dt_ = qc.call("POST", "/queries.json",
                                        {"user": user, "num": 10})
            check(status == 200, f"evlog: query for {user} answered "
                  f"{status}")
            qlat.append(dt_ * 1e3)
            max_err = max(max_err, _top10_err(U, V, m_sql, user, body,
                                               "evlog"))
        _, root1, _ = qc.call("GET", "/")
        b2 = (root1["kernelLaunches"]["shortlist"]
              - root0["kernelLaunches"]["shortlist"])
        batches = (root1["microBatches"]["batches"]
                   - root0["microBatches"]["batches"])
        check(b2 == batches and b2 > 0, f"evlog: B2 launched {b2} times "
              f"for {batches} micro-batches")
        check(root1["kernelLaunches"]["spd_solve"] == 0,
              f"evlog: the deploy launched B1 "
              f"{root1['kernelLaunches']['spd_solve']} times")
        status, _, _ = qc.call("POST", f"/stop?accessKey={key}")
        check(status == 200 and server.proc.wait(timeout=60) == 0,
              "evlog: the query server did not stop on POST /stop")
        events_srv.stop()
        check(events_srv.proc.returncode == 0, "evlog: the event server "
              f"did not drain and exit (rc {events_srv.proc.returncode})")
        report.update({
            "queries": len(picks), "max_score_abs_err": max_err,
            "tolerance": EVLOG_TOL, "b2_launches": b2,
            "micro_batches": batches,
            "query_p50_ms": float(np.percentile(qlat, 50)),
            "query_p99_ms": float(np.percentile(qlat, 99)),
            "scorer": {k: sc[k] for k in ("activeMode", "scanRank",
                                          "tileItems", "tiles",
                                          "shortlist", "recallProbe")},
            "leg_s": time.perf_counter() - t_leg})
        log("evlog: leg 2 " + json.dumps(report))
        return report
    finally:
        for srv in servers:
            srv.stop()
        Storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def spd_line(spd_rows, spd_err, train, lifecycle, width, b1_rows,
             canary, engines, evals, fleet, sessionrec, loadtest,
             distributed, evlog, dryrun) -> dict:
    """B1's entry of the kernels line: times at the shape of the main
    path's larger half-sweep (S = users, K = rank) and the launches of
    the ML-20M train and of the eval phase's sweeps (each counted from
    zero); beside them the fold-in launches of both legs and of the
    canary's held fold-in, the engines' trains and e-commerce's fold-in,
    the load test's storm (its trains and fold-in, counted from zero
    around the fleet), the distributed phase's trains and its sweep
    across processes (each process's own count), the evlog phase's
    train and its sqlite twin's, the check phase's dry run over two
    positions, B1's times at the applies' shapes and at the eval
    sweeps'."""
    fl = lifecycle["foldin"]
    grid, cli = evals["grid"]["launches"], evals["cli"]
    eval_launches = {
        "eval_grid_batched": grid["batched"],
        "eval_grid_sequential": grid["sequential"],
        "eval_width_batched": evals["width"]["launches"],
        "eval_cli_batched": cli["batched"]["launches"]["spd_solve"],
        "eval_cli_sequential": cli["sequential"]["launches"]["spd_solve"]}
    c = ML20M
    row = next(r for r in spd_rows
               if r["K"] == c["rank"] and r["S"] == c["n_users"])
    dist_train = [p["launches"]
                  for p in distributed["leg1"]["per_process"]]
    dist_engine = [p["launches"]
                   for p in distributed["leg2"]["per_process"]]
    dist_sweep = distributed["leg6"]["launches_per_process"]
    return {
        "name": "spd_solve",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/spd_solve.cu",
        "replaces": "predictionio_tpu/ops/linalg.py:106",
        "launches": train["full"]["launches"] + sum(eval_launches.values())
        + lifecycle["foldin_slo"]["b1_launches"]
        + lifecycle["operator_cli"]["train_launches"]["spd_solve"]
        + loadtest["launches"]["spd_solve"]
        + sum(dist_train) + sum(dist_engine) + sum(dist_sweep)
        + evlog["train"]["launches"]["spd_solve"]
        + evlog["twin_train"]["launches"]["spd_solve"]
        + dryrun["launches"]["spd_solve"],
        "max_abs_err": spd_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library": "torch.linalg.solve(A + lam I + jitter I, b)",
        "library_chol_ms": row["library_chol_ms"],
        "library_chol": "two-call composite: torch.linalg.cholesky_ex + "
                        "torch.cholesky_solve",
        "shape": {"S": row["S"], "K": row["K"], "regime": row["regime"],
                  "fits_l2": row["fits_l2"]},
        "launches_by_path": {
            "train_full": train["full"]["launches"],
            "train_subspace": train["subspace"]["launches"],
            "train_full_r64": train["full_r64"]["launches"],
            "lifecycle_train_v1":
                lifecycle["train"]["launches"]["spd_solve"],
            "lifecycle_train_v2":
                lifecycle["train_v2"]["launches"]["spd_solve"],
            "checkpointed_train":
                lifecycle["checkpoint"]["checkpointed_launches"],
            "resumed_train": lifecycle["checkpoint"]["resumed_launches"],
            "foldin_lifecycle_deploy": fl["b1_launches"],
            "foldin_width_stream": width["stream_launches"]["spd_solve"],
            "foldin_width_solver": {
                k: [v["launches_batched"], v["launches_one_at_a_time"]]
                for k, v in width["solver"].items()},
            "canary_held_foldin": canary["held_foldin"]["b1_launches"],
            "foldin_slo": lifecycle["foldin_slo"]["b1_launches"],
            "engines_ecommerce_train":
                engines["ecommerce"]["train"]["launches"]["spd_solve"],
            "engines_ecommerce_unseen_train": engines["ecommerce"][
                "train_unseen"]["launches"]["spd_solve"],
            "engines_ecommerce_foldin":
                engines["ecommerce"]["foldin"]["b1_launches"],
            "engines_similarproduct_train": engines["similarproduct"][
                "train"]["launches"]["spd_solve"],
            "engines_recommended_user_train": engines["recommended_user"][
                "train"]["launches"]["spd_solve"],
            "engines_similar_width_train":
                engines["similar_width"]["b1_launches"],
            "fleet_orchestrate": fleet["orchestrate"]["b1_launches"],
            "sessionrec": sessionrec_launches(sessionrec, "spd_solve"),
            "loadtest_storm": loadtest["launches"]["spd_solve"],
            "distributed_train_per_process": dist_train,
            "distributed_engine_per_process": dist_engine,
            "distributed_engine_one_process":
                distributed["leg2"]["one_process_launches"],
            "distributed_sweep_per_process": dist_sweep,
            "distributed_sweep_one_process":
                distributed["leg6"]["one_process_launches"],
            "operator_copy_train":
                lifecycle["operator_cli"]["train_launches"]["spd_solve"],
            "evlog_train": evlog["train"]["launches"]["spd_solve"],
            "evlog_sqlite_twin_train":
                evlog["twin_train"]["launches"]["spd_solve"],
            "check_dryrun_multichip": dryrun["launches"]["spd_solve"],
            **eval_launches},
        "eval_shapes": [r for r in spd_rows if r["eval"]],
        "foldin": {
            "at_apply_shapes": b1_rows,
            "K10_lifecycle_applies": fl["apply_split"]["b1_by_shape"],
            "K64_width_applies": width["apply_split"]["b1_by_shape"],
            "K64_solver": {k: {"S256": v["b1_at_S256"], "S1": v["b1_at_S1"]}
                           for k, v in width["solver"].items()}},
    }


def ml20m_one_process():
    """The train phase's full leg alone, for a partial run: ((U, V), the
    build's digest) of the ML-20M train from the seeded initial
    factors."""
    import torch

    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, _init_item_factors, train_als,
    )
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    c = ML20M
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    data = ALSData.build(users, items, ratings, c["n_users"],
                         c["n_items"]).put(
        make_mesh(devices=[torch.device(DEV)]))
    params = ALSParams(rank=c["rank"], num_iterations=c["iters"],
                       reg=c["reg"], chunk_size=c["chunk"])
    init_V = _init_item_factors(data.n_items, data.n_items_pad, params.rank,
                                params.seed, torch.device(DEV))
    UV = train_als(data, params, device=DEV, init_V=init_V.cpu().numpy())
    return UV, data.digest


#: the rule ids ``check`` ships: the reference's 13
CHECK_RULES = ["PIO001", "PIO002", "PIO003", "PIO004", "PIO005", "PIO006",
               "PIO007", "PIO008", "PIO009", "PIO090", "PIO100", "PIO101",
               "PIO102"]


def check_leg() -> dict:
    """Leg 1 of the check phase, host only: ``check`` over the port's
    tree through the CLI, in four processes at once (the whole tree as
    JSON, PIO004 on ``data/write_buffer.py``, a path outside the root,
    ``--list-rules``). Checks each one's exit code and report."""
    cli = [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
           "check"]
    runs = {"tree": ["--json"],
            "pio004": ["--json", "-r", "PIO004",
                       "predictionio_tpu_torch/data/write_buffer.py"],
            "outside": [str(ROOT.parent)],
            "list_rules": ["--list-rules"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cli + a, cwd=str(ROOT), text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, a in runs.items()}
    out, wall = {}, None
    for k, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            check(False, f"check: {runs[k]} ran past 600 s")
        # the whole tree's run is waited for first: its end is its own
        wall = time.perf_counter() - t0 if wall is None else wall
        out[k] = (proc.returncode, stdout, stderr)
    n_py = len(list((ROOT / "predictionio_tpu_torch").rglob("*.py")))
    rc, stdout, stderr = out["tree"]
    check(rc == 0, f"check: the tree exited {rc}: {stdout[-3000:]} "
          f"{stderr[-2000:]}")
    doc = json.loads(stdout)
    check(doc["ok"] is True and doc["rules"] == CHECK_RULES
          and not doc["findings"] and not doc["parseErrors"]
          and doc["filesChecked"] == n_py + 1,
          f"check: the tree's report ok={doc['ok']} rules={doc['rules']} "
          f"files={doc['filesChecked']} (want {n_py} + chip_smoke.py) "
          f"findings={doc['findings'][:5]} "
          f"parseErrors={doc['parseErrors']}")
    rc4, stdout4, stderr4 = out["pio004"]
    doc4 = json.loads(stdout4) if rc4 in (0, 1) else {}
    check(rc4 == 0 and doc4.get("rules") == ["PIO004"],
          f"check: -r PIO004 on data/write_buffer.py exited {rc4}: "
          f"{stdout4[-2000:]} {stderr4[-2000:]}")
    rco, stdouto, _ = out["outside"]
    check(rco == 2 and "outside the project root" in stdouto,
          f"check: a path outside the root exited {rco}: {stdouto[-500:]}")
    rcl, stdoutl, _ = out["list_rules"]
    listed = [line.split()[0] for line in stdoutl.splitlines() if line]
    check(rcl == 0 and listed == CHECK_RULES,
          f"check: --list-rules exited {rcl} with {listed}")
    log(f"check: wall {wall:.3f} s (the whole tree, --json; the four "
        f"runs at once)")
    log(f"check: files {doc['filesChecked']} ({n_py} under "
        "predictionio_tpu_torch/ + chip_smoke.py), parse errors "
        f"{len(doc['parseErrors'])}")
    log(f"check: findings {len(doc['findings'])}, baselined "
        f"{doc['baselinedCount']}, rules {len(doc['rules'])}")
    return {"wall_s": wall, "files": doc["filesChecked"],
            "port_py_files": n_py, "findings": len(doc["findings"]),
            "baselined": doc["baselinedCount"], "rules": doc["rules"],
            "pio004": {"rc": rc4, "findings": len(doc4["findings"])},
            "outside_rc": rco, "list_rules_rc": rcl,
            "runs_s": time.perf_counter() - t0}


def check_dryrun(n: int = 2) -> dict:
    """Leg 2 of the check phase, on the card: the port's entry module,
    ``entry()``'s forward against a plain recompute and
    ``dryrun_multichip(n)`` over n positions of the card; B1's launches
    counted from zero around the dry run (one a position a half-sweep of
    its one ALS iteration)."""
    import torch

    from predictionio_tpu_torch.entry import dryrun_multichip, entry
    from predictionio_tpu_torch.ops import kernels

    fn, args = entry(DEV)
    scores, ids = fn(*args)
    user_vec, factors, _ = (a.cpu().double() for a in args)
    plain = factors @ user_vec
    want = torch.topk(plain, len(ids))
    check(torch.equal(ids.cpu(), want.indices)
          and float((scores.cpu().double() - want.values).abs().max())
          <= 1e-4 * max(1.0, float(want.values.abs().max())),
          f"check: entry()'s top-10 {ids.tolist()} against the f64 "
          f"recompute's {want.indices.tolist()}")
    synchronize()
    t0 = time.perf_counter()
    kernels.reset_counts()
    report = dryrun_multichip(n, DEV)
    synchronize()
    launches = kernels.counts()
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = launches
    check(launches["spd_solve"] == 2 * n,
          f"check: dryrun_multichip({n}) launched B1 "
          f"{launches['spd_solve']} times, want {2 * n}")
    log(f"check: dryrun_multichip({n}) {json.dumps(report)}")
    return report


def partial_run(args, shape) -> int:
    """``--only``: the named phases after the kernels phase, for
    debugging on the card; no kernels line and no result."""
    phases = set(args.only.split(","))
    bad = phases - {"serve", "obs", "lifecycle", "fleet", "multitenant",
                    "classify", "sessionrec", "loadtest", "distributed",
                    "operator", "evlog", "check"}
    check(not bad, f"--only takes serve, obs, lifecycle, fleet, "
          f"multitenant, classify, sessionrec, loadtest, distributed, "
          f"operator, evlog, check; got {sorted(bad)}")
    if "check" in phases:
        report = finish_legs(start_legs(["check"], args.seed,
                                        args.port))["check"]
        report["dryrun"] = check_dryrun()
        log("check: " + json.dumps(report))
    if "evlog" in phases:
        # leg 1 (host only), then leg 2 on the card, each in its worker
        evlog = finish_legs(start_legs(["evlog_codec"], args.seed,
                                       args.port))
        evlog.update(finish_legs(start_legs(["evlog"], args.seed,
                                            args.port)))
        log("evlog: " + json.dumps(evlog))
    if "distributed" in phases:
        # legs 1-2, the one-process twin, then the serve phase (the
        # unsharded answers) and leg 3 on its model
        dist = finish_legs(start_legs(["distributed"], args.seed,
                                      args.port))["distributed"]
        dist["twin"] = distributed_twin(dist, *ml20m_one_process())
        served = build_model(args.seed, args.items, SERVE_USERS,
                             SERVE_RANK)
        serve = serve_phase(args.seed, args.items, args.port, shape,
                            *served)
        dist["leg3"] = sharded_serve_leg(args.seed, args.port, *served,
                                         serve.pop("plain_answers"))
        dist["leg3"]["unsharded_p50_ms"] = serve["p50_ms_by_kind"]["plain"]
        log("distributed: " + json.dumps(dist))
        shutil.rmtree(WORK, ignore_errors=True)
        del served
        gc.collect()
    if "loadtest" in phases:
        log("loadtest: " + json.dumps(finish_legs(start_legs(
            ["loadtest"], args.seed, args.port))["loadtest"]))
    if "classify" in phases:
        log("classify: " + json.dumps(classify_phase(args.seed)))
    if "sessionrec" in phases:
        # leg 1 alone on the card, then leg 2 in its worker process
        report = sessionrec_phase(args.seed, None)
        report["cli"] = finish_legs(start_legs(["sessionrec"], args.seed,
                                               args.port))["sessionrec"]
        log("sessionrec: " + json.dumps(report))
    cli = op_cli = None
    if phases & {"lifecycle", "operator"}:
        lifecycle = lifecycle_phase(args.seed, args.port)
        cli, op_cli = lifecycle["multiserve_cli"], lifecycle["operator_cli"]
    if phases & {"serve", "obs", "fleet", "multitenant", "operator"}:
        served = build_model(args.seed, args.items, SERVE_USERS,
                             SERVE_RANK)
        if phases & {"serve", "obs", "operator"}:
            serve = serve_phase(args.seed, args.items, args.port, shape,
                                *served)
        if "obs" in phases:
            log("obs: " + json.dumps(obs_phase(args.seed, shape, *served)))
        if "operator" in phases:
            log("operator: " + json.dumps(operator_phase(
                args.seed, shape, served[0], serve["plain_answers"], serve,
                op_cli)))
        if phases & {"fleet", "multitenant"}:
            blob = served_blob(*served)
        if "fleet" in phases:
            log("fleet: " + json.dumps(fleet_phase(args.seed, *served,
                                                   blob)))
        if "multitenant" in phases:
            log("multitenant: " + json.dumps(multitenant_phase(
                args.seed, *served, blob, cli=cli)))
        shutil.rmtree(WORK, ignore_errors=True)
        del served
        gc.collect()
    print(f"chip_smoke: partial run ({args.only}): no result",
          file=sys.stderr)
    return 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--items", type=int, default=10_000_000,
                    help="catalogue size of the serve phase (cut only to "
                         "fit the time limit; at least 4194304)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--only", default=None, metavar="PHASE[,PHASE]",
                    help="run only these of serve, obs, lifecycle, fleet, "
                         "multitenant, classify, sessionrec, loadtest, "
                         "distributed, operator, evlog, check after the "
                         "build "
                         "and the "
                         "kernels phase (a partial run: it prints no "
                         "result and exits 4)")
    args = ap.parse_args()
    if args.items < 1 << 22:
        ap.error("--items below 4194304 is not a cut this smoke allows")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "predictionio_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(predictionio_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    try:
        # 1. env
        card = card_line()
        resolve_device(None)
        name = torch.cuda.get_device_name(0)
        log(f"env: {card} | torch {torch.__version__} | CUDA "
            f"{torch.version.cuda} | device {name}")
        # 2. build, and meanwhile the batchpredict phase's leg 1 (no
        #    kernel) in a process of its own
        t0 = time.perf_counter()
        if args.only:
            logs = kernels.build_all()
        else:
            bench_leg = start_legs(["bp_bench", "evlog_codec", "check"],
                                   args.seed, args.port)
            try:
                logs = kernels.build_all()
            except BaseException:
                stop_legs(bench_leg)
                raise
        build_s = time.perf_counter() - t0
        for src, out in logs.items():
            for line in out.splitlines():
                # ptxas: each instantiation's mangled name (its template
                # argument as Li<K>E), then its registers and spills
                if any(w in line for w in ("Compiling entry function",
                                           "registers", "spill")) \
                        or "error" in line.lower():
                    log(f"build: {src}: {line.strip()}")
        log(f"build: {sorted(logs) or 'cached'} in {build_s:.3f} s")
        if not args.only:
            build_legs = finish_legs(bench_leg)
            bp_bench = build_legs["bp_bench"]
            evlog = {"codec": build_legs["evlog_codec"]}
            checked = build_legs["check"]
            log(f"build: with batchpredict's, evlog's and check's legs 1 "
                f"beside it {time.perf_counter() - t0:.3f} s")
            # 18. distributed, legs 1-2 and 4-7 (two processes on the
            #     card, their launches counted in each), with nothing
            #     else running
            t_dist = time.perf_counter()
            distributed = finish_legs(start_legs(
                ["distributed"], args.seed, args.port))["distributed"]
            distributed["legs_1_2_window_s"] = time.perf_counter() - t_dist
            # 15. classify: naive Bayes, logistic regression and the
            #     forest at the spam width, then the template through the
            #     CLI; no kernel of the repo lies on its path
            classify = classify_phase(args.seed)
            check(not any(classify["launches"].values()),
                  f"classify: launched {classify['launches']}")
            log("classify: " + json.dumps(classify))
            gc.collect()
            torch.cuda.empty_cache()
        # 3. kernels
        rows, max_err, shape = kernels_phase(args.seed, args.items)
        if args.only:
            return partial_run(args, shape)
        chunk_rows, chunk_err = kernels_chunk_rows(args.seed, args.items)
        eng_rows, eng_err = kernels_engine_shapes(args.seed)
        tie_rows = kernels_tie_rows(args.seed)
        spd_rows, spd_err = spd_kernels_phase(args.seed)
        # 21. check, leg 2: the entry module's dry run over two positions
        #     of the card (B1 counted from zero around it)
        checked["dryrun"] = check_dryrun()
        log("check: " + json.dumps(checked))
        # 5, 9 (leg 1) and 13 (leg 3): the lifecycle (its CLI processes
        #    count their own launches), the three engines through the CLI
        #    and an orchestrated cycle, each in a process of its own,
        #    while this process runs phases 4, 9 (leg 2), 10 (legs 1-2)
        #    and 6 (leg 2)
        t_legs = time.perf_counter()
        legs = start_legs(["lifecycle", "ecommerce", "similarproduct",
                           "recommended_user", "orchestrate", "sessionrec",
                           "evlog"], args.seed, args.port)
        try:
            # 4. train (the training path: counts zeroed just before
            #    each train, read just after)
            t0 = time.perf_counter()
            train, held = train_phase(spd_rows)
            log(f"train: phase took {time.perf_counter() - t0:.3f} s")
            # 18. distributed, leg 1 against the one-process train
            distributed["twin"] = distributed_twin(
                distributed, held.pop("full_UV"), held["data"].digest)
            # 9. engines, leg 2 (the width leg) on the train phase's
            #    arrays
            t0 = time.perf_counter()
            eng_width = engines_width_leg(args.seed, held)
            log(f"engines: width leg took {time.perf_counter() - t0:.3f} s")
            # 10. eval, legs 2 (on the train phase's arrays) and 1; leg 3
            #     runs inside the lifecycle (the CLI's processes count)
            t0 = time.perf_counter()
            eval_width = eval_width_leg(held)
            del held
            gc.collect()
            torch.cuda.empty_cache()
            eval_grid = eval_grid_leg()
            eval_legs_s = time.perf_counter() - t0
            log(f"eval: legs 1-2 took {eval_legs_s:.3f} s")
            # 16. sessionrec, leg 1 (the model at full width; its
            #     launches counted from zero around it); leg 2 runs
            #     through the CLI in a process of its own
            t0 = time.perf_counter()
            sessionrec = sessionrec_phase(args.seed, None)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"sessionrec: leg 1 took {time.perf_counter() - t0:.3f} s")
            # 6. foldin, leg 2, on the serve cell's model (built once,
            #    here); leg 1 runs inside the lifecycle (its deploy
            #    process counts)
            t0 = time.perf_counter()
            served = build_model(args.seed, args.items, SERVE_USERS,
                                 SERVE_RANK)
            log(f"foldin: serve cell's model built in "
                f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            width = foldin_width_leg(args.seed, *served)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"foldin: width leg took {time.perf_counter() - t0:.3f} s")
        except BaseException:
            stop_legs(legs)
            raise
        background = finish_legs(legs)
        lifecycle = background.pop("lifecycle")
        sessionrec["cli"] = background.pop("sessionrec")
        log("sessionrec: " + json.dumps(sessionrec))
        evlog["store"] = background.pop("evlog")
        log("evlog: " + json.dumps(evlog))
        legs_s = time.perf_counter() - t_legs
        log(f"lifecycle: phase took {lifecycle['leg_s']:.3f} s; with the "
            f"train, engines, eval and fold-in legs beside it "
            f"{legs_s:.3f} s")
        evals = {"grid": eval_grid, "width": eval_width,
                 "cli": lifecycle["eval_cli"], "legs_1_2_s": eval_legs_s}
        log("eval: " + json.dumps(evals))
        # 6. foldin: B1 alone at the shapes both legs' applies gave it
        shapes = [(r["K"], r["S"]) for split in (
            lifecycle["foldin"]["apply_split"], width["apply_split"],
            width["item_fold"]["apply_split"])
            for r in split["b1_by_shape"]] + [(SERVE_RANK, 1),
                                                (SERVE_RANK, 256)]
        b1_rows = foldin_b1_rows(args.seed, shapes)
        # 7. serve (the counts are those of the serving process, zero
        #    just before the queries and read just after)
        serve = serve_phase(args.seed, args.items, args.port, shape,
                            *served)
        # 12. obs, on the same model: the deploy's legs count their own
        #     launches, this process's from zero just before them
        obs = obs_phase(args.seed, shape, *served)
        log("obs: " + json.dumps(obs))
        # 19. operator, leg 2: the same model's deploy under server.json's
        #     key, TLS and serving section, analyze and the consoles (leg
        #     1 ran inside the lifecycle)
        operator = operator_phase(args.seed, shape, served[0],
                                  serve["plain_answers"], serve,
                                  lifecycle["operator_cli"])
        log("operator: " + json.dumps(operator))
        # 18. distributed, leg 3: the same model under two scorer shards,
        #     in this process and through deploy (the serve phase's file)
        t0 = time.perf_counter()
        distributed["leg3"] = sharded_serve_leg(
            args.seed, args.port, *served, serve.pop("plain_answers"))
        distributed["leg3"]["leg_s"] = time.perf_counter() - t0
        distributed["leg3"]["unsharded_p50_ms"] = \
            serve["p50_ms_by_kind"]["plain"]
        shutil.rmtree(WORK, ignore_errors=True)
        log("distributed: " + json.dumps(distributed))
        # 8. canary, on the same model in this process (its CLI leg ran
        #    inside the lifecycle, on v2)
        t0 = time.perf_counter()
        canary = canary_phase(args.seed, *served)
        canary["feedback"] = lifecycle["feedback"]
        canary["phase_s"] = time.perf_counter() - t0
        log("canary: " + json.dumps(canary))
        # 11. batchpredict, leg 2 on the serve cell's model (its last
        #     user); leg 1 ran beside the build, leg 3 inside the
        #     lifecycle
        t0 = time.perf_counter()
        bp_width = bp_width_leg(args.seed, *served)
        bp_s = time.perf_counter() - t0
        # 13. fleet: a router over replicas of the same model (leg 2),
        #     the router tier alone (leg 1); leg 3, an orchestrated cycle,
        #     ran beside the train phase; each replica and the
        #     orchestrator count their own launches
        blob = served_blob(*served)
        fleet = fleet_phase(args.seed, *served, blob,
                            orchestrate=background.pop("orchestrate"))
        log("fleet: " + json.dumps(fleet))
        # 14. multitenant: two tenants over the same model (leg 2), the
        #     reference bench's three families (leg 1); leg 3 ran inside
        #     the lifecycle
        multitenant = multitenant_phase(args.seed, *served, blob,
                                        cli=lifecycle["multiserve_cli"])
        log("multitenant: " + json.dumps(multitenant))
        del served, blob
        gc.collect()
        torch.cuda.empty_cache()
        # 17. loadtest: the partition curve, the sustained storm and the
        #     maintenance commands, in a process of its own (the fleet
        #     sets process-wide knobs), alone on the card
        t0 = time.perf_counter()
        loadtest = finish_legs(start_legs(["loadtest"], args.seed,
                                          args.port))["loadtest"]
        loadtest["with_process_s"] = time.perf_counter() - t0
        log("loadtest: " + json.dumps(loadtest))
        batchpredict = {"width": bp_width, "bench": bp_bench,
                        "cli": lifecycle["batchpredict_cli"],
                        "kernel_rows": chunk_rows,
                        "legs_1_2_s": bp_s + bp_bench["leg_s"]}
        log("batchpredict: " + json.dumps(batchpredict))
        # 9. engines, leg 1 (the three engines through the CLI) ran
        #    beside the train phase
        engines = dict(background, **eng_width)
        engines["legs_window_s"] = legs_s
        log("engines: " + json.dumps(engines))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # the served queries' shape: one query per batch, unmasked, the
    # serving shortlist's candidates per tile
    main_row = next(r for r in rows if r["B"] == 1 and not r["masked"]
                    and r["c"] == shape["c"]["plain"])
    line = {"kernels": [{
        "name": "shortlist_topc",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/shortlist.cu",
        "replaces": "predictionio_tpu/ops/scoring.py:885",
        "launches": serve["shortlist_launches"],
        "max_abs_err": max(max_err, eng_err, chunk_err),
        "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": "composite: torch.matmul over dequantized f32 factors "
                   "+ torch.topk per tile",
        "plan": main_row["plan"],
        "shape": dict(shape, B=1, c=shape["c"]["plain"], masked=False),
        "launches_by_path": {
            "serve": serve["shortlist_launches"],
            "foldin_width_stream": width["stream_launches"]["shortlist"],
            "canary": canary["b2_launches"],
            "engines_similarproduct_cli":
                engines["similarproduct"]["b2_launches"],
            "engines_similar_width":
                engines["similar_width"]["b2_launches"],
            "batchpredict": bp_width["launches"]
            + lifecycle["batchpredict_cli"]["b2_launches"],
            "obs": obs["b2_launches"],
            "fleet_replicas": fleet["replicas"]["b2_launches"],
            "fleet_orchestrate": fleet["orchestrate"]["b2_launches"],
            "multitenant": multitenant["width"]["b2_launches"],
            "sessionrec": sessionrec_launches(sessionrec, "shortlist"),
            "loadtest_storm": loadtest["launches"]["shortlist"],
            "distributed_sharded_in_process":
                distributed["leg3"]["in_process"]["b2_launches"],
            "distributed_sharded_http":
                distributed["leg3"]["http"]["b2_launches"],
            "operator_https_deploy": operator["serve"]["b2_launches"],
            "evlog_deploy": evlog["store"]["b2_launches"]},
        "foldin_scored_queries": width["scored_probes"],
        "chunk_rows": chunk_rows,
        "engine_shapes": eng_rows,
        "tie_rows": tie_rows,
    }, spd_line(spd_rows, spd_err, train, lifecycle, width, b1_rows,
                canary, engines, evals, fleet, sessionrec, loadtest,
                distributed, evlog["store"], checked["dryrun"])]}
    log(json.dumps(line))
    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
