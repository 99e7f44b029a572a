"""Child process of the port's multi-process tests (not a test module).

Each of N processes runs this program with the repo root on
``PYTHONPATH``: it joins a ``torch.distributed`` gloo group
(``parallel/distributed.initialize_distributed``), then runs one phase
on the CPU and prints ``RESULT <json>`` for the parent to compare
against the JAX package and a one-process run.

    python tests/torch_distributed_child.py <phase> <pid> <nproc> <port> <dir>

Phases:

* ``collectives`` — every collective of ``parallel/collectives`` over a
  (2, 2) mesh whose "data" axis crosses the processes, ``exchange_rows``,
  ``allgather_object``, ``global_vocab`` and ``broadcast_one_to_all``;
* ``als`` — ``ALSData.build(...).put(mesh)`` and ``train_als`` on a
  2-position process mesh from the parent's initial factors; a
  checkpointed train whose resume process 0's snapshot decides; the
  partitioned read of a sqlite store through ``training_scan`` into
  ``build_distributed``; the recommendation engine's DataSource and
  ``ALSAlgorithm.train``, and its replicated fallback;
* ``models`` — over the 2-position process mesh: the naive Bayes count
  (its mesh branch), logistic regression and the forest, each process
  then predicting its own whole X; ``cooccurrence_topn_distributed`` on
  a disjoint half of the events in each process; ``run_sweep`` (one
  group a process); seqrec over a data 1 x model 2 mesh;
* ``engines`` — the classification engine's three algorithms, the
  similar-product cooccurrence algorithm and the session engine's
  algorithm, each trained on ``mesh_of(ctx)`` (the process mesh).

It imports neither jax nor the JAX package.
"""

import json
import os
import sys


def make_toy_ratings():
    """The shared deterministic rating set: (users, items, ratings,
    n_users, n_items), the reference test's toy set."""
    import numpy as np

    rng = np.random.default_rng(7)
    n_users, n_items = 48, 32
    mask = rng.random((n_users, n_items)) < 0.4
    users, items = np.nonzero(mask)
    u_lat = rng.normal(size=(n_users, 3)).astype(np.float32)
    v_lat = rng.normal(size=(n_items, 3)).astype(np.float32)
    ratings = (u_lat @ v_lat.T)[users, items].astype(np.float32)
    return (users.astype(np.int32), items.astype(np.int32), ratings,
            n_users, n_items)


def blocks_input():
    """The collectives' global input: a [8, 6] array whose (2, 2) mesh
    blocks are [4, 3] (position (i, j) holds rows 4i.., columns 3j..)."""
    import numpy as np

    return np.arange(48, dtype=np.float32).reshape(8, 6) * 1.5 - 7.0


def exchange_input(pid):
    """Rows each process sends: [n, 2] int32 payloads and destinations."""
    import numpy as np

    rng = np.random.default_rng(100 + pid)
    n = 11 + 5 * pid
    payload = np.stack([np.full(n, pid, np.int32),
                        np.arange(n, dtype=np.int32)], axis=1)
    dest = rng.integers(0, 2, n).astype(np.int32)
    return dest, payload


def _collectives(pid, nproc):
    import numpy as np
    import torch

    from predictionio_tpu_torch.parallel import collectives as C
    from predictionio_tpu_torch.parallel.mesh import Mesh
    from predictionio_tpu_torch.parallel.shuffle import (
        allgather_object, exchange_rows, global_vocab,
    )

    # two positions a process on its CPU: flat position 2 * pid + j, so
    # "data" crosses the processes and "model" stays in each
    cpu = torch.device("cpu")
    devs = np.empty(4, dtype=object)
    devs[:] = [cpu] * 4
    mesh = Mesh(devs.reshape(2, 2),
                np.asarray([0, 0, 1, 1]).reshape(2, 2), ("data", "model"),
                process_index=pid)
    g = torch.from_numpy(blocks_input())
    blocks = [g[4 * pid:4 * pid + 4, 3 * j:3 * j + 3].clone()
              for j in range(2)]
    out = {}
    for axis in ("data", "model"):
        n = mesh.shape[axis]
        res = {
            "psum": C.psum(blocks, mesh, axis),
            "pmean": C.pmean(blocks, mesh, axis),
            "all_gather": C.all_gather(blocks, mesh, axis),
            "all_gather_stacked": C.all_gather(blocks, mesh, axis,
                                               tiled=False),
            "reduce_scatter": C.reduce_scatter(blocks, mesh, axis),
            "all_to_all": C.all_to_all(blocks, mesh, axis),
            "ring_pass": C.ring_pass(blocks, mesh, axis, n),
            "ring_pass_rev": C.ring_pass(blocks, mesh, axis, n,
                                         reverse=True),
            "ring_reduce": C.ring_reduce(blocks, mesh, axis, n),
        }
        out[axis] = {k: [t.tolist() for t in v] for k, v in res.items()}
    dest, payload = exchange_input(pid)
    got = exchange_rows(dest, payload)
    objs = allgather_object({"pid": pid})
    vocab = global_vocab(np.asarray([f"v{pid}", "shared", f"w{pid}"],
                                    dtype=object))
    bcast = C.broadcast_one_to_all((np.full(3, pid, np.int64),))[0]
    return {"collectives": out, "exchange": got.tolist(),
            "objects": objs, "vocab": vocab.tolist(),
            "broadcast": bcast.tolist()}


def _configure_store(db_path):
    from predictionio_tpu_torch.storage.registry import Storage

    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": db_path}},
        "repositories": {
            "METADATA": {"NAME": "pio", "SOURCE": "DB"},
            "EVENTDATA": {"NAME": "pio", "SOURCE": "DB"},
            "MODELDATA": {"NAME": "pio", "SOURCE": "DB"},
        },
    })


def _als(pid, nproc, work):
    import types

    import numpy as np
    import torch

    from predictionio_tpu_torch.data.eventstore import (
        EventStoreClient, clear_cache, property_column,
    )
    from predictionio_tpu_torch.data.ingest import training_scan
    from predictionio_tpu_torch.models.als import (
        ALSData, ALSParams, build_distributed, train_als,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.parallel.mesh import make_mesh
    from predictionio_tpu_torch.parallel.shuffle import (
        allgather_object, global_vocab,
    )
    from predictionio_tpu_torch.workflow.checkpoint import Checkpointer

    mesh = make_mesh(device="cpu")
    assert mesh.size == nproc and mesh.spans_processes
    users, items, ratings, n_users, n_items = make_toy_ratings()
    init_V = np.load(os.path.join(work, "init_V.npy"))
    params = ALSParams(rank=4, num_iterations=3, chunk_size=64)
    data = ALSData.build(users, items, ratings, n_users, n_items,
                         n_shards=nproc).put(mesh)
    kernels.reset_counts()
    U, V = train_als(data, params, init_V=init_V, mesh=mesh)
    res = {"U": U.tolist(), "V": V.tolist()}

    # checkpoint resume across processes: per-process (not shared)
    # snapshot directories, so process 0's snapshot decides for both
    ck = Checkpointer(os.path.join(work, f"ck{pid}"), interval=2)
    train_als(data, params, init_V=init_V, mesh=mesh, checkpointer=ck)
    more = ALSParams(rank=4, num_iterations=5, chunk_size=64)
    stats = {}
    U5, V5 = train_als(data, more, init_V=init_V, mesh=mesh,
                       checkpointer=ck, stats=stats)
    U5s, V5s = train_als(data, more, init_V=init_V, mesh=mesh)
    res.update(
        ck_files=sorted(os.listdir(ck.directory))
        if os.path.isdir(ck.directory) else [],
        resumed_half_sweeps=stats["half_sweeps"],
        resume_diff=float(max(np.abs(U5 - U5s).max(),
                              np.abs(V5 - V5s).max())))

    # the partitioned read: process 0's snapshot, a strict subset here
    _configure_store(os.path.join(work, "engine.db"))
    clear_cache()
    scan = training_scan("DistApp", sharded=True, entity_type="user",
                         event_names=["rate"], target_entity_type="item",
                         columns=("entity_id", "target_entity_id",
                                  "properties"))
    cols = scan.columns
    uid, iid = cols["entity_id"], cols["target_entity_id"]
    vals = property_column(cols["properties"], "rating")
    local_n = len(vals)
    total_n = sum(allgather_object(local_n))
    uvocab, ivocab = global_vocab(uid), global_vocab(iid)
    sdata = build_distributed(mesh, np.searchsorted(uvocab, uid),
                              np.searchsorted(ivocab, iid), vals,
                              len(uvocab), len(ivocab))
    sU, sV = train_als(sdata, params, mesh=mesh)
    res.update(store_local_n=local_n, store_total_n=total_n,
               store_shard=list(scan.shard[:2]),
               store_digest=sdata.digest, store_U=sU.tolist(),
               store_V=sV.tolist(), exchange=sdata.exchange)

    # the engine path: the DataSource's sharded read, ALSAlgorithm.train
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, DataSourceParams,
        RecommendationDataSource, RecommendationPreparator,
    )

    ds = RecommendationDataSource(DataSourceParams(app_name="DistApp"))
    td = ds.read_training(None)
    pd = RecommendationPreparator().prepare(None, td)
    algo = ALSAlgorithm(AlgorithmParams(rank=4, num_iterations=3))
    ctx = types.SimpleNamespace(mesh=mesh, device=torch.device("cpu"),
                                checkpointer=None)
    model = algo.train(ctx, pd)
    queries = [str(u) for u in model.user_vocab[:10]]
    answers = [[(i, float(s)) for i, s in model.recommend(u, 5)]
               for u in queries]

    # a store that cannot partition: replicated read, strided local slice
    real = EventStoreClient.read_snapshot
    EventStoreClient.read_snapshot = staticmethod(lambda *a, **k: None)
    try:
        clear_cache()
        td2 = ds.read_training(None)
        model2 = algo.train(ctx, RecommendationPreparator().prepare(None,
                                                                    td2))
    finally:
        EventStoreClient.read_snapshot = real
    res.update(engine_local_rows=len(td.columns.users),
               engine_U=model.U.tolist(), engine_V=model.V.tolist(),
               engine_users=model.user_vocab.tolist(),
               engine_items=model.item_vocab.tolist(),
               engine_answers=answers,
               degrade_rows=len(td2.columns.users),
               degrade_U=model2.U.tolist())
    res["launches"] = kernels.counts()
    return res


def nb_data(n=400, f=30, seed=12):
    """Poisson counts [n, f] and two labels (the models phase's NB)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.poisson(1.0, size=(n, f)).astype(np.float32)
    y = np.where(rng.random(n) < 0.4, "spam", "ham")
    return X, y


def logreg_data(seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(117, 5)).astype(np.float32)
    y = np.where(X @ rng.normal(size=(5,)) > 0, "pos", "neg")
    return X, y


def forest_data(seed=4):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(150, 4)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0, "hi", "lo")
    return X, y


def cooc_events(seed=8, nu=60, ni=300, n=3000):
    """(users, items, n_users, n_items) with duplicates; process ``p``
    of two takes the events at ``p::2``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, nu, n).astype(np.int32),
            rng.integers(0, ni, n).astype(np.int32), nu, ni)


def sweep_grid():
    """The models phase's sweep: its fold split and candidates (two
    rank groups, one a process)."""
    import numpy as np

    from predictionio_tpu_torch.models.als import ALSParams

    users, items, ratings, n_users, n_items = make_toy_ratings()
    fold_of = (np.arange(len(ratings)) % 3).astype(np.int32)
    cands = [ALSParams(rank=r, num_iterations=3, reg=g, chunk_size=64)
             for r in (2, 3) for g in (0.05, 0.1)]
    return (users, items, ratings, fold_of, n_users, n_items), cands


def seqrec_sessions(n=48, n_items=14, seed=7):
    """Cyclic sessions over an ``n_items`` catalog (V = 15, padded to 16
    under tp 2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[f"i{(int(rng.integers(0, n_items)) + j) % n_items:02d}"
             for j in range(int(rng.integers(3, 12)))] for _ in range(n)]


#: the models phase's seqrec widths
SEQREC = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=2,
              batch_size=8)


def _models(pid, nproc):
    import numpy as np

    from predictionio_tpu_torch.models import forest, logreg, naive_bayes
    from predictionio_tpu_torch.models.als_sweep import (
        build_sweep_data, run_sweep,
    )
    from predictionio_tpu_torch.models.cooccurrence import (
        cooccurrence_topn_distributed,
    )
    from predictionio_tpu_torch.models.seqrec import (
        SeqRecParams, train_seqrec,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    assert mesh.size == nproc and mesh.spans_processes
    res = {}
    naive_bayes.DEVICE_MIN_SIZE = 0          # the mesh branch at this size
    X, y = nb_data()
    nb = naive_bayes.train_multinomial_nb(X, y, mesh=mesh)
    res.update(nb_log_prob=nb.log_prob.tolist(),
               nb_log_prior=nb.log_prior.tolist(),
               nb_predict=nb.predict(X).tolist(),
               nb_branches=dict(nb.branches))
    X, y = logreg_data()
    lr = logreg.train_logreg(X, y, logreg.LogRegParams(
        iterations=60, learning_rate=0.2), mesh=mesh)
    res.update(lr_W=lr.W.tolist(), lr_b=lr.b.tolist(),
               lr_predict=lr.predict(X).tolist())
    X, y = forest_data()
    fm = forest.train_forest(X, y, forest.ForestParams(
        num_trees=7, max_depth=3, max_bins=16, seed=5), mesh=mesh)
    res.update(forest_nodes=[fm.feat.tolist(), fm.thr.tolist(),
                             fm.leaf.tolist()],
               forest_predict=fm.predict(X).tolist())
    users, items, nu, ni = cooc_events()
    vals, ids = cooccurrence_topn_distributed(
        mesh, users[pid::nproc], items[pid::nproc], nu, ni, 5)
    res.update(cooc_vals=vals.tolist(), cooc_ids=ids.tolist())
    args, cands = sweep_grid()
    kernels.reset_counts()
    sweep = run_sweep(build_sweep_data(*args), cands, device="cpu")
    res.update(sweep_rmse=[c.heldout_rmse for c in sweep.candidates],
               sweep_groups=[c.group for c in sweep.candidates],
               sweep_batches=sweep.batch_sizes)
    losses = []
    sm = train_seqrec(make_mesh((1, nproc), ("data", "model"), device="cpu"),
                      seqrec_sessions(), SeqRecParams(**SEQREC),
                      losses=losses)
    res.update(seqrec_losses=losses,
               seqrec_params={k: v.tolist() for k, v in sm.params.items()},
               seqrec_recs=sm.recommend_next(["i03", "i04", "i05"], 5))
    return res


def _engines(pid, nproc):
    import types

    import numpy as np
    import torch

    from predictionio_tpu_torch.engines import (
        classification, sessionrec, similarproduct,
    )
    from predictionio_tpu_torch.engines.common import InteractionColumns
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    ctx = types.SimpleNamespace(mesh=make_mesh(device="cpu"),
                                device=torch.device("cpu"),
                                checkpointer=None)
    X, y = forest_data()
    pd = classification.PreparedData(points=[
        classification.LabeledVector(label=float(lab == "hi"),
                                     features=tuple(map(float, x[:3])))
        for x, lab in zip(X, y)])
    res = {}
    for name, algo in (
            ("naive", classification.NaiveBayesAlgorithm()),
            ("logreg", classification.LogisticRegressionAlgorithm(
                classification.LogisticRegressionParams(iterations=20))),
            ("forest", classification.RandomForestAlgorithm(
                classification.ForestParams(num_trees=3, max_depth=2,
                                            max_bins=8)))):
        pd_abs = pd if name != "naive" else classification.PreparedData(
            points=[classification.LabeledVector(
                label=p.label, features=tuple(abs(v) for v in p.features))
                for p in pd.points])
        model = algo.train(ctx, pd_abs)
        res[name] = [algo.predict(model, classification.Query(
            attr0=a, attr1=b, attr2=c)).label
            for a, b, c in np.abs(X[:10, :3]).tolist()]
    users, items, _nu, _ni = cooc_events(n=400, nu=20, ni=30)
    views = InteractionColumns(
        users=np.asarray([f"u{u}" for u in users], object),
        items=np.asarray([f"i{i}" for i in items], object))
    co = similarproduct.CooccurrenceAlgorithm().train(
        ctx, similarproduct.PreparedData(users={}, items={}, views=views,
                                         likes=views))
    res["cooccurrence"] = {str(k): v for k, v in
                           co.model.top_cooccurrences.items()}
    sr = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams(
        **dict(SEQREC, epochs=1))).train(
        ctx, sessionrec.TrainingData(sessions=seqrec_sessions()))
    res["sessionrec"] = sr.recommend_next(["i03", "i04"], 3)
    return res


def main() -> None:
    phase, pid, nproc, port, work = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4],
                                     sys.argv[5])
    from predictionio_tpu_torch.parallel.distributed import (
        initialize_distributed, process_count, process_index,
    )

    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid,
                           timeout_s=120)
    assert (process_index(), process_count()) == (pid, nproc)
    result = {"pid": pid}
    result.update({"collectives": lambda: _collectives(pid, nproc),
                   "als": lambda: _als(pid, nproc, work),
                   "models": lambda: _models(pid, nproc),
                   "engines": lambda: _engines(pid, nproc)}[phase]())
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "predictionio_tpu"
                 or m.startswith("predictionio_tpu."))
    result["forbidden_modules"] = bad
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
