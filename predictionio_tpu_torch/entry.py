"""Entry points of the port: a forward step and a multi-position
dry run (the counterpart of the repository root's ``__graft_entry__.py``).

``entry()`` returns the flagship forward step, ALS top-K scoring (one
user vector against the item factors, the items the user has seen sent
to -inf, the top 10), with example arguments drawn from the reference's
numpy seed, so both packages score the same inputs.

``dryrun_multichip(n)`` runs one step of each flagship training path over
an ``n``-position mesh (``parallel/mesh``) on tiny shapes: the sharded ALS
train (users and items a shard a position, one iteration through the
batched SPD solve) and the session transformer over a ``("data",
"model")`` mesh, the batch on ``data`` and the weights on ``model``. The
positions may repeat one device, as the CPU tests' meshes do. It returns
what it checked.

Both run on the card (``cuda``) unless the caller asks for the CPU with
``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("pio.torch.entry")

#: the forward step's shape: the ML-100k catalogue at rank 64, top 10
N_ITEMS, RANK, NUM = 1682, 64, 10


def entry(device: DeviceLike = None):
    """``(fn, example_args)``: ``fn(user_vec, item_factors, seen_mask)``
    gives ``(scores, ids)`` of the top ``NUM`` items."""
    dev = resolve_device(device)

    def forward(user_vec, item_factors, seen_mask):
        scores = item_factors @ user_vec
        scores = scores.masked_fill(seen_mask, float("-inf"))
        top = torch.topk(scores, NUM)
        return top.values, top.indices

    rng = np.random.default_rng(0)
    example_args = (
        torch.as_tensor(rng.normal(size=(RANK,)), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(rng.normal(size=(N_ITEMS, RANK)),
                        dtype=torch.float32, device=dev),
        torch.zeros((N_ITEMS,), dtype=torch.bool, device=dev),
    )
    return forward, example_args


def dryrun_multichip(n_positions: int,
                     device: DeviceLike = None) -> dict:
    """One sharded ALS step over a 1-D mesh of ``n_positions`` and one
    seqrec dp x tp step over an ``(n/2, 2)`` mesh (``(n, 1)`` for an
    odd ``n``), every position on ``device``; returns the factor shapes,
    the meshes and the recommendations' count."""
    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, train_als,
    )
    from predictionio_tpu_torch.models.seqrec import (
        SeqRecParams, train_seqrec,
    )
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    mesh = make_mesh(devices=[dev] * n_positions)

    # tiny synthetic ratings: 64 users x 48 items, low rank
    rng = np.random.default_rng(0)
    n_users, n_items, rank = 64, 48, 4
    u_lat = rng.normal(size=(n_users, rank)).astype(np.float32)
    v_lat = rng.normal(size=(n_items, rank)).astype(np.float32)
    mask = rng.random((n_users, n_items)) < 0.3
    users, items = np.nonzero(mask)
    ratings = (u_lat @ v_lat.T)[users, items].astype(np.float32)
    data = ALSData.build(users.astype(np.int32), items.astype(np.int32),
                         ratings, n_users, n_items, n_shards=n_positions)
    params = ALSParams(rank=8, num_iterations=1, chunk_size=64)
    U, V = train_als(data, params, mesh=mesh)
    if U.shape != (n_users, 8) or V.shape != (n_items, 8) \
            or not (np.isfinite(U).all() and np.isfinite(V).all()):
        raise RuntimeError(f"sharded ALS step gave U{U.shape} V{V.shape}, "
                           "or factors that are not finite")
    logger.info("dryrun_multichip(%d): sharded ALS step OK, U%s V%s",
                n_positions, U.shape, V.shape)

    shape = ((n_positions // 2, 2) if n_positions % 2 == 0
             else (n_positions, 1))
    mesh2 = make_mesh(shape, ("data", "model"),
                      devices=[dev] * n_positions)
    sessions = [[f"i{(s + j) % 12:02d}" for j in range(6)]
                for s in range(24)]
    sp = SeqRecParams(d_model=16, n_heads=2, n_layers=1, max_len=8,
                      epochs=1, batch_size=8)
    model = train_seqrec(mesh2, sessions, sp, device=dev)
    recs = model.recommend_next(["i01", "i02"], 3)
    if not recs:
        raise RuntimeError("the seqrec dp x tp step produced no "
                           "recommendations")
    logger.info("dryrun_multichip(%d): seqrec dp x tp step OK on mesh %s",
                n_positions, dict(mesh2.shape))
    return {"positions": n_positions, "device": str(dev),
            "als": {"U": list(U.shape), "V": list(V.shape)},
            "seqrec": {"mesh": dict(mesh2.shape), "recs": len(recs)}}


def main(argv: Optional[list] = None) -> int:
    """``python -m predictionio_tpu_torch.entry [N] [--device cpu]``:
    the forward step, then the dry run over N positions (default 2)."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(prog="python -m predictionio_tpu_torch.entry")
    ap.add_argument("positions", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    scores, ids = fn(*example_args)
    report = dryrun_multichip(args.positions, args.device)
    report["entry"] = {"ids": ids.tolist(), "scores": scores.tolist()}
    sys.stdout.write(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
