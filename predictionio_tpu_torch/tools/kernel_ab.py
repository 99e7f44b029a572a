"""Same-card A/B of a hand-written kernel against another checkout.

    python3 -m predictionio_tpu_torch.tools.kernel_ab --kernel KERNEL \\
        --base DIR [--shapes SHAPES] [--pairs N] [--out FILE]

``DIR`` is a checkout of another commit of this repository (unpack one
with ``git archive``). Each side runs in a process of its own, from its
own checkout and with the kernels built from that checkout's sources,
in the order base, this, this, base, base, this, ... (``--pairs`` pairs),
on the same card and with the same seeded inputs.

``--kernel spd_solve`` (B1, ``csrc/spd_solve.cu``): systems built like a
half-sweep's (the Gramian of random factors over up to 24 ratings, its
ridge 0.01 * max(cnt, 1), about 1% of segments empty). Per shape (K, S)
each process records, each three times: ``call_ms``,
``ops.linalg.spd_solve`` as that checkout's trains call it (the ridge and
the 1e-6 jitter passed to the wrapper where it takes them, else summed
into A beforehand, outside the timing); ``solve_ms``,
``ops.linalg.batched_spd_solve`` as that checkout's half-sweep calls it
(``(gram, b, diag=lam)``, or ``(gram + lam I, b)`` with the sum inside
the timing); ``device_ms``, the wrapper's calls captured in a CUDA graph
and replayed. ``--shapes small`` is K in {10, 16, 32, 64} x S in {1,
129}; ``grid`` adds S in {27000, 138000}, the rows of ``chip_smoke.py``'s
kernels phase; ``train`` times instead the ALS train of
``chip_smoke.py``'s train phase (the ML-20M shape, ``full`` solver) at
rank 10 for 20 iterations and at rank 64 for 3, each after one uncounted
train: ``half_sweep_ms``, three trains a process.

``--kernel shortlist`` (B2, ``csrc/shortlist.cu``): int8 tiles in [-127,
127], scales in [0.5, 1.5) / 127, standard normal query rows, a 30% mask,
at the shapes of ``chip_smoke.py``'s B2 rows. ``--shapes serve``: 10M
items, scan rank 32, tiles of 16384, B in {1, 8, 64}, c in {1, 2, 4, 16},
with and without a mask; ``engines``: (3706 items, T 4096, c 512 and
1024) and (27,000 items, T 16384, c 256), R 8 and 10, B in {1, 8, 64},
with and without a mask; ``all`` (the default) both. Per row each
process records ``ms`` (``ops.scoring.shortlist_topc`` by CUDA events
over back-to-back calls after a warm-up, the wrapper's host time
included) and ``device_ms`` (the calls in a CUDA graph, no host time).

The script prints the card's name and power limit, one JSON line per
process and case, and a summary per case and metric: each side's
medians, process by process, and the ratio of their medians. ``--out``
writes the same lines to a file. ``event_ms`` and ``graph_ms`` are the
timers ``chip_smoke.py`` uses too.
"""

# pio: ignore-file[PIO100]: a command-line tool; its report is its stdout

from __future__ import annotations

import argparse
import inspect
import json
import os
import pathlib
import statistics
import subprocess
import sys

SPD_SHAPES = {
    "small": [(k, s) for k in (10, 16, 32, 64) for s in (1, 129)],
    "grid": [(k, s) for k in (10, 16, 32, 64)
             for s in (1, 129, 27_000, 138_000)],
}
#: chip_smoke.py's ML-20M train: users, items, ratings, seed, reg, chunk
ML20M = dict(n_users=138_000, n_items=27_000, nnz=20_000_000, seed=20,
             reg=0.01, chunk=16_384)
#: (rank, iterations) of each timed train
TRAINS = [(10, 20), (64, 3)]
JITTER = 1e-6
REPEATS = 3

#: B2 rows: (n_items, T, R, B, c, masked)
SERVE = [(10_000_000, 16_384, 32, b, c, m) for b in (1, 8, 64)
         for c in (1, 2, 4, 16) for m in (False, True)]
ENGINES = [(n, t, r, b, c, m)
           for n, t, c in ((3706, 4096, 512), (3706, 4096, 1024),
                           (27_000, 16_384, 256))
           for r in (8, 10) for b in (1, 8, 64) for m in (False, True)]
SHORTLIST_SHAPES = {"serve": SERVE, "engines": ENGINES,
                    "all": SERVE + ENGINES}
KERNELS = {"spd_solve": ("small", ("small", "grid", "train")),
           "shortlist": ("all", tuple(SHORTLIST_SHAPES))}


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    runs after ``warmup`` (CUDA events: the host's time to issue each
    call counts wherever it exceeds the device's)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn()``, without its host time:
    ``launches`` calls captured in one CUDA graph, the graph replayed
    ``reps`` times. At small shapes a call's host time (the wrapper's
    checks, the allocation, the launch) exceeds the kernel's, and
    :func:`event_ms` reads the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    ms = event_ms(graph.replay, iters=reps) / launches
    del graph
    return ms


def _spd_inputs(s: int, k: int, g):
    """(gram, lam, b) built like a half-sweep's on the card."""
    import torch

    n = 24
    cnt = torch.randint(1, n + 1, (s,), generator=g, device="cuda")
    cnt[torch.rand((s,), generator=g, device="cuda") < 0.01] = 0
    if s > 1:
        cnt[0] = 0
    w = (torch.arange(n, device="cuda")[None, :] < cnt[:, None]).float()
    f = torch.randn((s, n, k), generator=g, device="cuda") / k ** 0.5
    r = torch.randint(1, 6, (s, n), generator=g, device="cuda").float()
    fw_t = (f * w[..., None]).transpose(1, 2)
    gram = torch.bmm(fw_t, f).contiguous()
    b = torch.bmm(fw_t, r[..., None])[..., 0].contiguous()
    return gram, 0.01 * cnt.clamp_min(1).float(), b


def _train_lines():
    """The ALS trains of chip_smoke.py's train phase, with this
    checkout's ``models.als`` (the same calls it makes)."""
    import time

    import numpy as np
    import torch

    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, _init_item_factors, train_als,
    )

    c = ML20M
    rng = np.random.default_rng(c["seed"])      # chip_smoke.synthetic_ratings
    users = rng.integers(0, c["n_users"], c["nnz"]).astype(np.int32)
    items = rng.integers(0, c["n_items"], c["nnz"]).astype(np.int32)
    raw = np.einsum("nk,nk->n", rng.normal(size=(c["n_users"], 4))[users],
                    rng.normal(size=(c["n_items"], 4))[items])
    ratings = np.clip(np.round(2.5 + raw), 1, 5).astype(np.float32)
    data = ALSData.build(users, items, ratings, c["n_users"],
                         c["n_items"]).to("cuda")
    for rank, iters in TRAINS:
        params = ALSParams(rank=rank, num_iterations=iters, reg=c["reg"],
                           chunk_size=c["chunk"])
        init_V = _init_item_factors(data.n_items, data.n_items_pad, rank,
                                    params.seed, torch.device("cuda")
                                    ).cpu().numpy()
        times = []
        for i in range(REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_als(data, params, device="cuda", init_V=init_V)
            if i:
                times.append((time.perf_counter() - t0) / (2 * iters) * 1e3)
        yield {"case": f"train_r{rank}", "half_sweep_ms": times}


def _spd_lines(shapes):
    import torch

    from predictionio_tpu_torch.ops import linalg

    takes_diag = "diag" in inspect.signature(linalg.spd_solve).parameters
    g = torch.Generator(device="cuda").manual_seed(2)
    for k, s in shapes:
        gram, lam, b = _spd_inputs(s, k, g)
        eye = torch.eye(k, device="cuda")
        if takes_diag:
            def call():
                return linalg.spd_solve(gram, b, lam, JITTER)

            def solve():
                return linalg.batched_spd_solve(gram, b, diag=lam)
        else:
            summed = gram + (lam + JITTER)[:, None, None] * eye

            def call():
                return linalg.spd_solve(summed, b)

            def solve():
                return linalg.batched_spd_solve(
                    gram + lam[:, None, None] * eye, b)
        iters, warm = (10, 2) if s >= 27_000 else (200, 20)
        yield {"case": f"K={k} S={s}", "takes_diag": takes_diag,
               "call_ms": [event_ms(call, iters, warm)
                           for _ in range(REPEATS)],
               "solve_ms": [event_ms(solve, iters, warm)
                            for _ in range(REPEATS)],
               "device_ms": [graph_ms(call, 10 if s >= 27_000 else 50)
                             for _ in range(REPEATS)]}


def _shortlist_lines(rows):
    import torch

    from predictionio_tpu_torch.ops.scoring import shortlist_topc

    dev = torch.device("cuda")
    key = tiles = scales = None
    for n, t, r, b, c, masked in rows:
        nt = -(-n // t)
        if key != (n, t, r):
            key = (n, t, r)
            tiles = scales = None
            torch.cuda.empty_cache()
            g = torch.Generator(device=dev).manual_seed(n + t + r)
            tiles = torch.randint(-127, 128, (nt, t, r), generator=g,
                                  device=dev, dtype=torch.int8)
            scales = (0.5 + torch.rand((nt, t), generator=g,
                                       device=dev)) / 127.0
        g = torch.Generator(device=dev).manual_seed(b * 1000 + c)
        u = torch.randn((b, r), generator=g, device=dev)
        mask = (torch.rand((b, nt * t), generator=g, device=dev) < 0.3
                if masked else None)

        def fn():
            return shortlist_topc(u, tiles, scales, n, mask, c)

        big = n * b > 10_000_000
        yield {"case": json.dumps([n, t, r, b, c, masked]),
               "ms": [event_ms(fn, 5 if big else 20, 2)],
               "device_ms": [graph_ms(fn, 4 if big else 20)]}


def worker(kernel: str, shapes: str, side: str, order: int) -> None:
    """Time one checkout (the working directory) and print its lines."""
    root = os.getcwd()
    sys.path.insert(0, root)
    from predictionio_tpu_torch.ops import kernels

    if not pathlib.Path(kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {kernels.__file__}, not from {root}")
    kernels.build_all()
    if kernel == "shortlist":
        lines = _shortlist_lines(SHORTLIST_SHAPES[shapes])
    elif shapes == "train":
        lines = _train_lines()
    else:
        lines = _spd_lines(SPD_SHAPES[shapes])
    for line in lines:
        print(json.dumps({"side": side, "order": order, **line}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), required=True)
    ap.add_argument("--base", help="checkout of the commit to compare with")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--shapes")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=2, metavar=("SIDE", "ORDER"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    default, allowed = KERNELS[args.kernel]
    shapes = args.shapes or default
    if shapes not in allowed:
        ap.error(f"--shapes for {args.kernel}: one of {', '.join(allowed)}")
    if args.worker:
        worker(args.kernel, shapes, args.worker[0], int(args.worker[1]))
        return 0
    if not args.base:
        ap.error("--base is required")
    here = pathlib.Path(__file__).resolve().parents[2]
    dirs = {"base": pathlib.Path(args.base).resolve(), "this": here}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = [f"card: {card}"]
    print(out[0], flush=True)
    rows = []
    for p in range(args.pairs):
        for i, side in enumerate(("base", "this") if p % 2 == 0
                                 else ("this", "base")):
            proc = subprocess.run(
                [sys.executable, __file__, "--kernel", args.kernel,
                 "--shapes", shapes, "--worker", side, str(2 * p + i)],
                cwd=dirs[side], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-3000:] + proc.stderr[-3000:],
                      file=sys.stderr)
                return 1
            for text in proc.stdout.splitlines():
                if text.startswith("{"):
                    print(text, flush=True)
                    out.append(text)
                    rows.append(json.loads(text))
    cases = list(dict.fromkeys(r["case"] for r in rows))
    metrics = {"shortlist": ("ms", "device_ms"),
               "spd_solve": (("half_sweep_ms",) if shapes == "train"
                             else ("call_ms", "solve_ms", "device_ms"))
               }[args.kernel]
    for case in cases:
        for metric in metrics:
            summary = {"case": case, "metric": metric}
            for side in ("base", "this"):
                summary[side] = [
                    statistics.median(r[metric]) for r in rows
                    if r["side"] == side and r["case"] == case]
            summary["ratio_of_medians"] = (statistics.median(summary["this"])
                                           / statistics.median(summary["base"]))
            text = "summary " + json.dumps(summary)
            print(text, flush=True)
            out.append(text)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
