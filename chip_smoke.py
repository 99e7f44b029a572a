#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--items 10000000] [--port 0]

Phases, each reported on its own line:

1. ``env``     — the card (``nvidia-smi`` name and power limit), CUDA and
                 torch versions.
2. ``build``   — compiles every kernel under ``predictionio_tpu_torch/csrc``
                 with nvcc for sm_90a (set-up time).
3. ``kernels`` — holds each hand-written kernel against its plain PyTorch
                 version on the card: the shortlist kernel at the serving
                 shapes (rank 32, tile 16384, 10M items so the last tile
                 is ragged), B in {1, 8, 64}, c in {1, 16} and every c
                 the serve phase's query kinds run at (the scorer's own
                 rule, ``twostage_cand``), with and without an exclusion
                 mask. vals within rtol 1e-5 / atol 1e-5 (f32 sums run
                 in another order); ids equal wherever the plain
                 version's neighbouring values differ by more than that.
4. ``serve``   — builds an ALS model at full width from ``--seed`` (10M
                 items x rank 64, 138,493 users, factors with a
                 geometrically decaying spectrum), saves it, deploys it
                 with ``python -m predictionio_tpu_torch.cli.main deploy``
                 under ``PIO_SCORER_MODE=twostage`` (tile 16384,
                 shortlist ``SHORTLIST``) and POSTs ``/queries.json``:
                 plain, blackList, whiteList, unknown user and num
                 above the shortlist. It checks that the
                 scorer serves twostage (not parity-demoted) at the
                 shapes the kernels phase checked, that the server's
                 launch counts are zero once it is warm (it zeroes
                 them just before it takes traffic) and that the
                 shortlist kernel launched for every scored query,
                 recall@10 >= 0.99 against an exact top-10 computed on
                 the card, served scores equal to the exact f32 scores
                 within 1e-4, and that blacklisted items are absent.

Then it prints one JSON line describing each kernel (times from this
run, CUDA events), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Without a CUDA device, or outside a checkout of the repo, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
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
# outside the tensor cores (the shortlist kernel's exact-f32 products)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL = 1e-5

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


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs."""
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


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def shortlist_bound_ms(b: int, n_items: int, r: int, cand: int, nt: int,
                       masked: bool):
    """Least time for the shortlist function on these inputs: every
    input byte read once and every output byte written once over HBM
    bandwidth, or its f32 multiply-adds over the f32 peak."""
    bytes_ = (n_items * r + n_items * 4 + b * r * 4
              + (b * n_items if masked else 0) + b * nt * cand * 8)
    ops = 2.0 * b * n_items * r + b * n_items   # dot products + scale
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
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
                bound, bound_by = shortlist_bound_ms(b, n_items, r, cand,
                                                     nt, masked)
                row = {"B": b, "c": cand, "masked": masked,
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": err}
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
    """The deploy CLI in a subprocess; stdout lines are relayed."""

    def __init__(self, model_path: pathlib.Path, port: int, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             "deploy", "--model", str(model_path), "--port", str(port)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, text=True)
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
            check(left > 0, "query server did not come up in time")
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                continue
            check(line != "", f"query server exited (rc {self.proc.poll()})")
            log("serve: [server] " + line.rstrip())
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

    def call(self, method: str, path: str, body=None):
        data = json.dumps(body).encode() if body is not None else None
        t0 = time.perf_counter()
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        payload = json.loads(resp.read())
        return resp.status, payload, time.perf_counter() - t0


def serve_phase(seed: int, n_items: int, port: int, shape: dict):
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.workflow.serialization import save_model

    rank, n_users = 64, 138_493
    t0 = time.perf_counter()
    users, items, U, V = build_model(seed, n_items, n_users, rank)
    WORK.mkdir(parents=True, exist_ok=True)
    model_path = WORK / "als_model.npz"
    save_model(model_path, ALSModel.from_arrays(users, items, U, V))
    log(f"serve: model {n_items} items x rank {rank}, {n_users} users, "
        f"built and saved in {time.perf_counter() - t0:.3f} s")

    env = dict(os.environ, PIO_SCORER_MODE="twostage",
               PIO_SCORER_TILE_ITEMS=str(TILE),
               PIO_SCORER_SHORTLIST=str(SHORTLIST))
    server = Server(model_path, port, env)
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
                if "registers" in line or "error" in line.lower():
                    log(f"build: {src}: {line.strip()}")
        log(f"build: {sorted(logs) or 'cached'} in "
            f"{time.perf_counter() - t0:.3f} s")
        # 3. kernels
        rows, max_err, shape = kernels_phase(args.seed, args.items)
        # 4. serve (the main path: the counts are those of the serving
        #    process, zero just before the queries and read just after)
        serve = serve_phase(args.seed, args.items, args.port, shape)
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
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": "composite: torch.matmul over dequantized f32 factors "
                   "+ torch.topk per tile",
        "shape": dict(shape, B=1, c=shape["c"]["plain"], masked=False),
    }]}
    log(json.dumps(line))
    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
