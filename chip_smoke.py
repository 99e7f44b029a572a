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
                   ROLLED_BACK. Leg 2, after the lifecycle, on the serve
                   cell's model (built once, in this process):
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
                   Leg 1, after the canary phase, each engine through the
                   CLI on its own sqlite store (events written with
                   ``insert_batch``, the engine.json naming the
                   reference's factory string): e-commerce at
                   cfg_ecommerce's shape (bench.py:741-760; 2,000 x
                   1,500, 200,000 views and buys, 4 categories, 10
                   unavailable items; rank 10, 10 iterations), its query
                   paths (known users, categories, whiteList, blackList,
                   an unknown user's recent views, popularity) against a
                   numpy recompute from the stored model; a second
                   variant with unseenOnly deployed with ``PIO_FOLDIN=1``,
                   8 new users x 8 views and 5 buys of one item folded in
                   (rows against a plain-solve recompute, popularity + 5,
                   B1 launches = the controller's solves); similar-product
                   at cfg_cooccurrence's ML-1M shape (bench.py:665-676;
                   1,000,000 views and 100,000 likes/dislikes; als,
                   likealgo and cooccurrence in one engine) deployed
                   under ``PIO_SCORER_MODE=twostage`` with shortlist 1024
                   (the default 512 demotes its als catalog, in both
                   packages; both gates reported), 40 plain queries
                   from 8 concurrent clients (the micro-batcher forms
                   batches) and a categories and a whiteList query (the
                   exact lane), each the first algorithm's exact
                   recompute, B2 launches = 2 x the fused batches, both
                   scorers active; recommended-user at the smoke's own
                   shape (6,040 users, 200,000 follows without
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
                   10 (16 full chunks, B2 at B = 1,024, c 2), then 2
                   chunks in which 1 query in 6 carries a one-item
                   blackList (a dense [1,024, 10M] mask a chunk, c 16);
                   each part: B2 launches equal to its chunks, no lane
                   fallback, the scorer still on twostage, 64 spread
                   rows (every masked row of the first masked chunk too)
                   equal to an exact recompute on the card (ids up to
                   ties, scores within 1e-4) with recall@10 >= 0.99;
                   rows/s and the split: read/decode, score, B2 (CUDA
                   events), uploads, rescore, serialize, file writes.
                   Leg 1, after it: the reference bench's
                   cfg_batch_predict shape (bench.py:2251-2300; 5,000
                   users x 2,000 items, rank 32, num 50, 40,000 queries,
                   chunk 1,024, exact scorer) through
                   ``run_batch_predict(loaded=...)``, inline, pipelined
                   and as a 2-process fleet on the one card (ready/go
                   rendezvous, manifest merge), best of 2 each:
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
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import queue
import shutil
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
    return report


def train_phase(spd_rows):
    import torch

    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, _init_item_factors, block_starts,
    )

    c = ML20M
    t0 = time.perf_counter()
    users, items, ratings = synthetic_ratings(c["n_users"], c["n_items"],
                                              c["nnz"], seed=c["seed"])
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = ALSData.build(users, items, ratings, c["n_users"], c["n_items"])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = data.to(DEV)
    upload_s = time.perf_counter() - t0
    log(f"train: {c['nnz']} ratings, {c['n_users']} x {c['n_items']}: "
        f"synthesis {synth_s:.3f} s, build_s {build_s:.3f}, upload_s "
        f"{upload_s:.3f} (rows by user {tuple(data.by_user.tgt.shape)}, "
        f"by item {tuple(data.by_item.tgt.shape)})")
    dev = torch.device(DEV)
    params = ALSParams(rank=c["rank"], num_iterations=c["iters"],
                       reg=c["reg"], chunk_size=c["chunk"])
    init_V = _init_item_factors(data.n_items, data.n_items_pad, params.rank,
                                params.seed, dev).cpu().numpy()
    full = _train_leg("full", data, params, init_V, users, items, ratings,
                      2 * c["iters"])
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
    sub = _train_leg("subspace", data, sub_params, sub_V, users, items,
                     ratings, 2 * sc["iters"] * n_blocks)
    sub_ms = by.get((sc["block"], c["n_users"]), 0.0) + \
        by.get((sc["block"], c["n_items"]), 0.0)
    sub["kernel_share"] = sub_ms * n_blocks / (2 * sub["half_sweep_ms"])

    rc = FULL_R64
    r64_params = ALSParams(rank=rc["rank"], num_iterations=rc["iters"],
                           reg=c["reg"], chunk_size=c["chunk"])
    r64_V = _init_item_factors(data.n_items, data.n_items_pad, rc["rank"],
                               params.seed, dev).cpu().numpy()
    r64 = _train_leg("full_r64", data, r64_params, r64_V, users, items,
                     ratings, 2 * rc["iters"])
    r64["kernel_share"] = (by[(rc["rank"], c["n_users"])]
                           + by[(rc["rank"], c["n_items"])]) \
        / (2 * r64["half_sweep_ms"])
    summary = {"full": full, "subspace": sub, "full_r64": r64,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log("train: " + json.dumps({"summary": summary}))
    # the engines phase's width leg reuses the arrays and the uploaded
    # layout
    return summary, {"users": users, "items": items, "ratings": ratings,
                     "data": data}


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
    (B1 2 x groups x iterations), then ``--sequential`` on its ranks at
    the first reg (2 x candidates x folds x iterations), picking the
    batched run's best of those two; a failing evaluation leaves
    EVALFAILED."""
    import numpy as np

    from predictionio_tpu_torch.storage.registry import Storage

    c = EVAL_CLI
    best_path = work / "best.json"
    (work / "smoke_eval.py").write_text(
        f"BEST = {str(best_path)!r}\nAPP = {app!r}\n"
        f"FOLDS = {c['folds']}\nITERS = {c['iters']}\n" + _EVAL_MODULE)
    env = dict(env, PYTHONPATH=os.pathsep.join(
        [str(work)] + [p for p in [env.get("PYTHONPATH")] if p]))
    grid = [f"rank={','.join(map(str, c['ranks']))}",
            f"reg={','.join(map(str, c['regs']))}"]

    def run(*extra):
        t0 = time.perf_counter()
        out = _cli(["eval", "smoke_eval:evaluation", "--device", DEV,
                    *extra], env)
        line = json.loads(out[-1])
        line["wall_s"] = time.perf_counter() - t0
        return line

    batched = run("--grid", grid[0], "--grid", grid[1])
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
    # the ranks at the first reg: the pair differs in rank, not only in
    # the ridge, so their scores are apart by more than the run-to-run
    # noise of near-tied top-10 edges
    sequential = run("--grid", grid[0], "--grid", f"reg={c['regs'][0]}",
                     "--sequential")
    log("lifecycle: eval sequential " + json.dumps(sequential))
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
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "eval",
         "smoke_eval:failing", "--device", DEV], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600)
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


def check_top10(client, model, users, tag: str):
    """Each user's served top-10 against the exact top-10 of ``model``'s
    factors on the card: same ids up to ties within 1e-4, scores within
    1e-4. Returns (max score error, latencies in ms)."""
    import numpy as np
    import torch

    U = torch.from_numpy(model.U).to(DEV)
    V = torch.from_numpy(model.V).to(DEV)
    check(bool(torch.isfinite(U).all() and torch.isfinite(V).all()),
          f"{tag}: trained factors are not finite")
    max_err, lat = 0.0, []
    for user in users:
        status, body, dt = client.call("POST", "/queries.json",
                                       {"user": user, "num": 10})
        check(status == 200, f"{tag}: query for {user} answered {status}")
        lat.append(dt * 1e3)
        got = body["itemScores"]
        vals, idx = torch.topk(V @ U[model.user_index(user)], 10)
        want_ids = [str(model.item_vocab[j]) for j in idx.tolist()]
        vals = vals.cpu().numpy()
        got_ids = [x["item"] for x in got]
        check(len(got) == 10, f"{tag}: {user} got {len(got)} items")
        err = np.abs(np.array([x["score"] for x in got]) - vals)
        max_err = max(max_err, float(err.max()))
        check(bool((err <= 1e-4 * np.maximum(1.0, np.abs(vals))).all()),
              f"{tag}: {user}'s scores differ from the exact top-10 by "
              f"{float(err.max())}")
        for a, b_, v in zip(got_ids, want_ids, vals):
            tied = np.abs(vals - v) <= 1e-4 * max(1.0, abs(v))
            check(a == b_ or a in {want_ids[j]
                                   for j in np.flatnonzero(tied)},
                  f"{tag}: {user} served {got_ids}, exact {want_ids}")
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
                             "0"], env, tag="lifecycle")
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
        ingest_report = {
            "events": n1, "requests": len(lat), "clients": 8,
            "events_per_s": n1 / wall, "wall_s": wall,
            "request_p50_ms": float(np.percentile(lat, 50)),
            "request_p99_ms": float(np.percentile(lat, 99))}
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
        # 8. the canary phase's CLI leg, on v2 and the same store
        feedback = feedback_leg(seed, env, variant, key, port, app_id, m2)
        # 9. the eval phase's CLI leg, on the same store
        t0 = time.perf_counter()
        eval_cli = eval_cli_leg(env, work, "SmokeApp")
        eval_cli["leg_s"] = time.perf_counter() - t0
        # 10. the batchpredict phase's CLI leg, on the same store
        t0 = time.perf_counter()
        bp_cli = batchpredict_cli_leg(env, work, variant, key, port)
        bp_cli["leg_s"] = time.perf_counter() - t0
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
                  "feedback": feedback, "eval_cli": eval_cli,
                  "batchpredict_cli": bp_cli}
        log("lifecycle: " + json.dumps(report))
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


def _applies_after(ctl, n: int):
    """The controller's logged applies after its n-th."""
    return [a for a in ctl.apply_log.copy() if a["apply"] > n]


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
        a0 = ctl.applies
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
        launches = kernels.counts()
        stream_applies = _applies_after(ctl, a0)
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
        # from seed + 1 and seed + 2, stored as blobs
        inst1 = instance(1)
        rel1 = record_release(inst1, 0.0)
        factors = {1: (U, V)}
        t0 = time.perf_counter()
        for n in (2, 3):
            _, _, Un, Vn = build_model(seed + n - 1, n_items, n_users, rank)
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
        applies = _applies_after(ctl, applies0)
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
    bench's top-k scoring config (trained ALS factor Gramians decay)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    spec = np.power(10.0, -1.5 * np.arange(rank) / max(1, rank - 1)
                    ).astype(np.float32)
    V = rng.standard_normal((n_items, rank), dtype=np.float32)
    V *= spec
    U = rng.standard_normal((n_users, rank), dtype=np.float32)
    U *= spec
    users = np.array([f"u{i:06d}" for i in range(n_users)])
    return users, item_ids(n_items), U, V


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

    def __init__(self, args, env: dict, tag: str = "serve"):
        self.tag = tag
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             *args], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            text=True)
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
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
        return serve
    finally:
        server.stop()
        shutil.rmtree(WORK, ignore_errors=True)


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
#: cfg_cooccurrence's ML-1M shape (bench.py:665-676) under the
#: similar-product engine's three algorithms
SIMILAR = dict(n_users=6040, n_items=3706, nnz=1_000_000, seed=2,
               likes=100_000, like_seed=3, rank=10, iters=10, n=20,
               categories=4, queries=40, black=10, clients=8,
               shortlist=1024)
#: the deploy's scorer shortlist (engine.json ``scorer``). The reference
#: default, 512, demotes the als catalog at this shape to exact in both
#: packages (scan rank 8 of 10: probe recall 0.9875 on an NVIDIA H100
#: 80GB HBM3, 700 W, 0.9625 on the CPU for the CPU-trained factors;
#: tests/test_torch_engines.py); 1024 keeps both ALS scorers on B2. The
#: phase reports both gates on the stored factors.
#: recommended-user: the reference names no bench shape for it; this
#: one is the smoke's own (ML-1M's users following each other)
FOLLOW = dict(n_users=6040, nnz=200_000, seed=6, rank=10, iters=10,
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


def engines_cli_legs(seed: int, port: int):
    """Leg 1 of the engines phase: the three engines through the CLI,
    each on its own store, removed afterwards."""
    from predictionio_tpu_torch.storage.registry import Storage

    out = {}
    try:
        for name, leg in (("ecommerce", ecommerce_leg),
                          ("similarproduct", similar_leg),
                          ("recommended_user", follow_leg)):
            t0 = time.perf_counter()
            out[name] = leg(seed, port, WORK / "engines" / name)
            out[name]["leg_s"] = time.perf_counter() - t0
    finally:
        Storage.reset()
        shutil.rmtree(WORK / "engines", ignore_errors=True)
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
        from predictionio_tpu_torch.models.als import ALSData

        c = ML20M
        users, items, ratings = synthetic_ratings(
            c["n_users"], c["n_items"], c["nnz"], seed=c["seed"])
        held = {"users": users, "items": items,
                "data": ALSData.build(users, items, ratings, c["n_users"],
                                      c["n_items"]).to(DEV)}
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
BP_BENCH = dict(n_users=5000, n_items=2000, rank=32, num=50,
                queries=40_000, chunk=1024, shards=2, reps=2, seed=11)
#: leg 2, the serve cell's model through B2: unmasked queries (16 full
#: chunks of num 10), masked chunks (1 query in 6 with a one-item
#: blackList), rows held to an exact recompute per part
BP_WIDTH = dict(chunk=1024, queries=16_384, masked_chunks=2, num=10,
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
    2-process fleet on the one card (manifest merge), best of 2 each;
    the three outputs hold the same answers. No Pallas kernel runs
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
    chunks of plain queries, then 2 chunks in which 1 query in 6 carries
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


def spd_line(spd_rows, spd_err, train, lifecycle, width, b1_rows,
             canary, engines, evals) -> dict:
    """B1's entry of the kernels line: times at the shape of the main
    path's larger half-sweep (S = users, K = rank) and the launches of
    the ML-20M train and of the eval phase's sweeps (each counted from
    zero); beside them the fold-in launches of both legs and of the
    canary's held fold-in, the engines' trains and e-commerce's fold-in,
    B1's times at the applies' shapes and at the eval sweeps'."""
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
    return {
        "name": "spd_solve",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/spd_solve.cu",
        "replaces": "predictionio_tpu/ops/linalg.py:106",
        "launches": train["full"]["launches"] + sum(eval_launches.values()),
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
            **eval_launches},
        "eval_shapes": [r for r in spd_rows if r["eval"]],
        "foldin": {
            "at_apply_shapes": b1_rows,
            "K10_lifecycle_applies": fl["apply_split"]["b1_by_shape"],
            "K64_width_applies": width["apply_split"]["b1_by_shape"],
            "K64_solver": {k: {"S256": v["b1_at_S256"], "S1": v["b1_at_S1"]}
                           for k, v in width["solver"].items()}},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--items", type=int, default=10_000_000,
                    help="catalogue size of the serve phase (cut only to "
                         "fit the time limit; at least 4194304)")
    ap.add_argument("--port", type=int, default=0)
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
        # 2. build
        t0 = time.perf_counter()
        logs = kernels.build_all()
        for src, out in logs.items():
            for line in out.splitlines():
                # ptxas: each instantiation's mangled name (its template
                # argument as Li<K>E), then its registers and spills
                if any(w in line for w in ("Compiling entry function",
                                           "registers", "spill")) \
                        or "error" in line.lower():
                    log(f"build: {src}: {line.strip()}")
        log(f"build: {sorted(logs) or 'cached'} in "
            f"{time.perf_counter() - t0:.3f} s")
        # 3. kernels
        rows, max_err, shape = kernels_phase(args.seed, args.items)
        chunk_rows, chunk_err = kernels_chunk_rows(args.seed, args.items)
        eng_rows, eng_err = kernels_engine_shapes(args.seed)
        tie_rows = kernels_tie_rows(args.seed)
        spd_rows, spd_err = spd_kernels_phase(args.seed)
        # 4. train (the training path: counts zeroed just before each
        #    train, read just after)
        t0 = time.perf_counter()
        train, held = train_phase(spd_rows)
        log(f"train: phase took {time.perf_counter() - t0:.3f} s")
        # 9. engines, leg 2 (the width leg) on the train phase's arrays
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
        # 5. lifecycle (the train CLI's process counts its own launches)
        t0 = time.perf_counter()
        lifecycle = lifecycle_phase(args.seed, args.port)
        log(f"lifecycle: phase took {time.perf_counter() - t0:.3f} s")
        evals = {"grid": eval_grid, "width": eval_width,
                 "cli": lifecycle["eval_cli"], "legs_1_2_s": eval_legs_s}
        log("eval: " + json.dumps(evals))
        # 6. foldin, leg 2, on the serve cell's model (built once, here);
        #    leg 1 ran inside the lifecycle (its deploy process counted)
        t0 = time.perf_counter()
        served = build_model(args.seed, args.items, SERVE_USERS, SERVE_RANK)
        log(f"foldin: serve cell's model built in "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        width = foldin_width_leg(args.seed, *served)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"foldin: width leg took {time.perf_counter() - t0:.3f} s")
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
        # 8. canary, on the same model in this process (its CLI leg ran
        #    inside the lifecycle, on v2)
        t0 = time.perf_counter()
        canary = canary_phase(args.seed, *served)
        canary["feedback"] = lifecycle["feedback"]
        canary["phase_s"] = time.perf_counter() - t0
        log("canary: " + json.dumps(canary))
        # 11. batchpredict, leg 2 on the serve cell's model (its last
        #     user), then leg 1; leg 3 ran inside the lifecycle
        t0 = time.perf_counter()
        bp_width = bp_width_leg(args.seed, *served)
        del served
        gc.collect()
        bp_bench = bp_bench_leg()
        batchpredict = {"width": bp_width, "bench": bp_bench,
                        "cli": lifecycle["batchpredict_cli"],
                        "kernel_rows": chunk_rows,
                        "legs_1_2_s": time.perf_counter() - t0}
        log("batchpredict: " + json.dumps(batchpredict))
        # 9. engines, leg 1: the three engines through the CLI
        t0 = time.perf_counter()
        engines = engines_cli_legs(args.seed, args.port)
        engines.update(eng_width)
        engines["cli_legs_s"] = time.perf_counter() - t0
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
            + lifecycle["batchpredict_cli"]["b2_launches"]},
        "foldin_scored_queries": width["scored_probes"],
        "chunk_rows": chunk_rows,
        "engine_shapes": eng_rows,
        "tie_rows": tie_rows,
    }, spd_line(spd_rows, spd_err, train, lifecycle, width, b1_rows,
                canary, engines, evals)]}
    log(json.dumps(line))
    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
