"""Command line of the port (``argparse``; the reference's ``pio`` uses
click), with the reference's commands, flags and exit codes:

    python -m predictionio_tpu_torch.cli.main app new NAME [--id N]
        [--description D] [--access-key K]
    python -m predictionio_tpu_torch.cli.main app list
    python -m predictionio_tpu_torch.cli.main accesskey new APP
        [--key K] [--event NAME ...]
    python -m predictionio_tpu_torch.cli.main accesskey list [APP]
    python -m predictionio_tpu_torch.cli.main eventserver [--ip] [--port 7070]
    python -m predictionio_tpu_torch.cli.main template list
    python -m predictionio_tpu_torch.cli.main template get NAME [DIRECTORY]
    python -m predictionio_tpu_torch.cli.main import --appname APP
        [--channel C] --input events.jsonl
    python -m predictionio_tpu_torch.cli.main train [-v engine.json]
        [--batch B] [--skip-sanity-check] [--stop-after-read]
        [--stop-after-prepare] [--checkpoint-dir D]
        [--checkpoint-interval N] [--out M.npz] [--device cpu]
    python -m predictionio_tpu_torch.cli.main eval EVALUATION_PATH
        [PARAMS_GENERATOR_PATH] [--batch B] [--grid NAME=V1,V2 ...]
        [--k-fold N] [--query-num N] [--sequential] [--device cpu]
    python -m predictionio_tpu_torch.cli.main deploy [-v engine.json]
        [--engine-instance-id ID | --release SEL | --model M.npz]
        [--ip localhost] [--port 8000] [--accesskey K] [--device cpu]
        [--feedback --event-server-app APP] [--log-url URL]
        [--log-prefix P]
    python -m predictionio_tpu_torch.cli.main multiserve
        --tenant NAME=engine.json [--tenant ...] [--ip localhost]
        [--port 8800] [--accesskey K] [--device cpu]
    python -m predictionio_tpu_torch.cli.main batchpredict [-v engine.json]
        --input Q.jsonl --output P.jsonl [--engine-instance-id ID |
        --release SEL] [--chunk-size N] [--output-format jsonl]
        [--input-format jsonl] [--device cpu]
    python -m predictionio_tpu_torch.cli.main undeploy [--ip localhost]
        [--port 8000] [--accesskey K]
    python -m predictionio_tpu_torch.cli.main releases [-v engine.json]
        [--status S]
    python -m predictionio_tpu_torch.cli.main rollback [--ip localhost]
        [--port 8000] [--accesskey K]
    python -m predictionio_tpu_torch.cli.main router [-v engine.json]
        [--ip localhost] [--port P] [--replicas N] [--replica-url URL ...]
        [--accesskey K] [--device cpu]
    python -m predictionio_tpu_torch.cli.main orchestrate [-v engine.json]
        [--once] [--force] [--cycles N] [--server HOST:PORT]
        [--accesskey K] [--state-dir D] [--eval-class EVAL] [--device cpu]
    python -m predictionio_tpu_torch.cli.main status [--fleet PATH]

The engine.json's ``engineFactory`` names one of the ported engines
(recommendation, ecommerce, similarproduct, recommended_user,
classification, sessionrec) by the reference's factory string or the
port's own.
``template get NAME`` scaffolds an engine.json for one of them.

``train`` runs ``workflow.train.run_train``: an EngineInstance (INIT,
then COMPLETED), the model blob in the model store under its id, and the
variant's next release; it prints one JSON line — users, items, nnz and
rank, or labels, features and trees, or items and d_model, of the
first algorithm's model
(null where its kind has none) and each model's, the seconds of the whole train (event read and records
included) and of the host-side data build, the kernel launch counts,
the training read's scan-cache hits and misses, the instance id and the
release version. ``--out`` also writes the
first model as an ``.npz`` file.

``eval`` runs ``workflow.evaluate.run_evaluation``: the evaluation
(``module:name`` or ``module.name``, an Evaluation, its class or a
factory) over its own params list or the generator's, crossed with the
``--grid`` values; an EvaluationInstance (INIT, then EVALCOMPLETED or
EVALFAILED) and the best variant's ``best.json``. It prints the
reference's lines, then one JSON line: the sweep's mode, groups, units
per launch and seconds, the best candidate and its score, the kernel
launch counts, the scan-cache hits and misses and the wall seconds.
``--sequential`` forces the per-candidate loop
(``PIO_EVAL_VECTORIZE=0``).

``deploy`` serves the latest COMPLETED instance of the variant, or
``--engine-instance-id``, or a release (``--release`` id, ``3`` or
``v3``), or a model file (``--model``). It reads the engine.json's
top-level ``scorer`` and ``foldin`` sections as ``pio deploy`` does (env
> engine.json > server.json; ``PIO_FOLDIN=1`` starts online fold-in)
and server.json's ``deploy`` section (< ``PIO_DEPLOY_*`` /
``PIO_CANARY_*``: the canary defaults of ``POST /deploy.json``), warms
the serving path up, then serves. ``--feedback`` with
``--event-server-app`` records every answer as a ``predict`` event of
that app (the answer carries its ``prId``); ``--log-url`` receives each
failed query's error, prefixed by ``--log-prefix``. Models run on
``cuda`` unless ``--device cpu`` is given.

``multiserve`` hosts N engine variants in one process
(``server/multitenant``): each ``--tenant NAME=engine.json`` serves the
latest COMPLETED instance of that variant, with its release and its
engine.json ``scorer``, ``foldin`` and ``slo`` sections, at
``/t/NAME/queries.json`` (its other routes under ``/t/NAME/``), under
the device-memory budget and admission knobs of ``PIO_MT_*`` /
server.json ``multitenant``. SIGTERM stops it.

``batchpredict`` scores a JSON-lines file of queries offline with the
latest COMPLETED instance of the variant, or ``--engine-instance-id``, or
``--release`` (``workflow.batch_predict.run_batch_predict``: pipelined,
the engine.json ``batchpredict`` section and ``PIO_BATCHPREDICT_*`` as
the reference reads them). It pins the engine.json ``scorer`` section
first, as ``deploy`` does, so that batch runs and serving score alike.
Run one process a shard with ``PIO_PROCESS_ID`` / ``PIO_NUM_PROCESSES``
into one ``--output``: the last to finish merges the fragments. It
prints the reference's lines, then one JSON line: written, invalid,
chunks, pad waste, seconds, rows/s, lane, lane fallbacks, the kernel
launch counts, the worker and whether this process merged. A fault of
the card or of a kernel fails the command (non-zero exit).

``undeploy`` stops a running query server (``POST /stop``).

``rollback`` asks a running query server to roll back
(``POST /rollback.json``) and prints what it serves now.

``router`` spawns ``--replicas`` ``deploy`` replicas of the variant on
``PIO_ROUTER_BASE_PORT + rank`` (or fronts ``--replica-url`` replicas)
and serves them behind one port (``server/router``): the spread,
health ejection, retries on another replica, fleet-sequenced
``/deploy.json`` and ``/rollback.json``, and the autoscaler
(``PIO_FLEET_*``). SIGTERM stops the router and its replicas.

``orchestrate`` runs the continuous-training loop over the variant
(``deploy/orchestrator``); ``--once`` exits 1 unless its cycle
promoted.

``status`` checks every storage backend, or prints a fleet view.

The storage is the one ``PIO_STORAGE_*`` configures (``storage/registry``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: the engines the port serves, by module name under ``engines``
_ENGINES = ("recommendation", "ecommerce", "similarproduct",
            "recommended_user", "classification", "sessionrec")


def _fail(msg: str) -> None:
    print(f"[ERROR] {msg}", flush=True)
    sys.exit(1)


def _engine_of(variant: dict):
    """The port's engine for the variant's ``engineFactory``: the
    engine module named before the factory function, dotted or with a
    colon as the reference's ``load_class`` reads it, so the reference's
    string (``predictionio_tpu.engines.<name>:engine``) and the port's
    own (``predictionio_tpu_torch.engines.<name>:engine``) both map to
    ``predictionio_tpu_torch.engines.<name>``, by string and never by
    importing the reference; no factory means the recommendation
    engine."""
    import importlib

    factory = variant.get("engineFactory") or ""
    name = (factory.replace(":", ".").split(".")[-2:-1] or [""])[0]
    if factory and name not in _ENGINES:
        raise SystemExit(f"[ERROR] engineFactory {factory!r}: only the "
                         f"{'/'.join(_ENGINES)} engines are ported")
    return importlib.import_module(
        f"predictionio_tpu_torch.engines.{name or 'recommendation'}"
    ).engine()


def _model_summary(model) -> dict:
    """Sizes of a trained or loaded model of any ported engine (None
    where the kind has no such side): users, items and rank of an ALS
    model; labels, features and trees of a classifier; items and
    d_model of a session model."""
    inner = getattr(model, "model", model)      # cooccurrence wraps one
    users = getattr(inner, "user_vocab", None)
    items = getattr(inner, "item_vocab", None)
    V = getattr(model, "V", None)
    labels = getattr(model, "label_vocab", getattr(model, "classes", None))
    feat = getattr(model, "feat", None)
    info = getattr(model, "train_info", None) or {}
    # a forest's thresholds [F, B-1], NB's log_prob [L, F], logreg's W [F, L]
    features = None
    if hasattr(model, "thresholds"):
        features = int(model.thresholds.shape[0])
    elif hasattr(model, "log_prob"):
        features = int(model.log_prob.shape[1])
    elif hasattr(model, "W"):
        features = int(model.W.shape[0])
    return {"kind": type(model).__name__,
            "users": None if users is None else len(users),
            "items": None if items is None else len(items),
            "rank": None if V is None else int(V.shape[1]),
            "labels": None if labels is None else len(labels),
            "features": features,
            "trees": None if feat is None else int(feat.shape[0]),
            "d_model": getattr(getattr(model, "hyper", None), "d_model",
                               None),
            "nnz": info.get("nnz"), "build_s": info.get("build_s")}


def _ingest_counts() -> dict:
    """This process's training-read cache hits and misses
    (``pio_ingest_cache_{hits,misses}_total``, summed over apps)."""
    from predictionio_tpu_torch.obs.registry import default_registry

    out = {}
    for key in ("hits", "misses"):
        metric = default_registry().get(f"pio_ingest_cache_{key}_total")
        out[key] = 0 if metric is None else int(
            sum(v for _labels, v in metric.samples()))
    return out


def _load_variant(path: str):
    """(engine, variant dict, engine id, variant id) of an engine.json;
    the engine id is the engineFactory string, as the reference records
    it."""
    if not os.path.exists(path):
        _fail(f"{path} does not exist. Aborting.")
    with open(path) as f:
        variant = json.load(f)
    engine = _engine_of(variant)
    engine_id = variant.get("engineFactory") or type(engine).__name__
    return engine, variant, engine_id, variant.get("id", "default")


# -- engine templates (Console.scala:595-605) --------------------------------

#: the templates of the ported engines: name -> (engine module, datasource
#: params, algorithms) of the engine.json ``template get`` scaffolds
_TEMPLATES = {
    "recommendation": ("recommendation", {"app_name": "MyApp"},
                       [{"name": "als",
                         "params": {"rank": 10, "num_iterations": 20,
                                    "reg": 0.01, "seed": 3}}]),
    "similarproduct": ("similarproduct", {"app_name": "MyApp"},
                       [{"name": "als",
                         "params": {"rank": 10, "num_iterations": 20}}]),
    "classification": ("classification", {"app_name": "MyApp"},
                       [{"name": "naive", "params": {"reg": 1.0}}]),
    "ecommerce": ("ecommerce", {"app_name": "MyApp"},
                  [{"name": "ecomm",
                    "params": {"app_name": "MyApp", "rank": 10}}]),
    "sessionrec": ("sessionrec", {"app_name": "MyApp"},
                   [{"name": "seqrec",
                     "params": {"d_model": 64, "n_heads": 2, "n_layers": 2,
                                "max_len": 32, "epochs": 10}}]),
    "recommendeduser": ("recommended_user", {"app_name": "MyApp"},
                        [{"name": "als",
                          "params": {"rank": 10, "num_iterations": 20}}]),
}


def _template_factory(module: str) -> str:
    return f"predictionio_tpu_torch.engines.{module}:engine"


def template_list(_args) -> int:
    """The built-in engine templates and their engineFactory."""
    for name, (module, _ds, _algos) in _TEMPLATES.items():
        print(f"[INFO] {name:<16} {_template_factory(module)}")
    sys.stdout.flush()
    return 0


def template_get(args) -> int:
    """Scaffold ``DIRECTORY/engine.json`` (default: a directory named
    after the template) for a built-in template; the write is atomic."""
    if args.name not in _TEMPLATES:
        _fail(f"Unknown template {args.name}. "
              f"Known: {', '.join(_TEMPLATES)}")
    module, ds_params, algos = _TEMPLATES[args.name]
    target_dir = args.directory or args.name
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(target_dir, "engine.json")
    # temp-write + rename: a crash leaves the previous file or none,
    # never half of one
    tmp = f"{target}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"id": "default",
                       "description": f"{args.name} engine",
                       "engineFactory": _template_factory(module),
                       "datasource": {"params": ds_params},
                       "algorithms": algos}, f, indent=2)
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    print(f"[INFO] Engine template {args.name} written to {target}",
          flush=True)
    return 0


# -- apps and keys (commands/App.scala, commands/AccessKey.scala) -----------

def app_new(args) -> int:
    from predictionio_tpu_torch.storage.base import AccessKey, App
    from predictionio_tpu_torch.storage.registry import Storage

    apps = Storage.get_meta_data_apps()
    if apps.get_by_name(args.name):
        _fail(f"App {args.name} already exists. Aborting.")
    new_id = apps.insert(App(id=args.id, name=args.name,
                             description=args.description))
    if new_id is None:
        _fail("Unable to create new app.")
    Storage.get_events().init_channel(new_id)
    key = Storage.get_meta_data_access_keys().insert(
        AccessKey(key=args.access_key, appid=new_id, events=()))
    if key is None:
        Storage.get_events().remove_channel(new_id)
        apps.delete(new_id)
        _fail(f"Access key {args.access_key} already exists. Aborting.")
    print("[INFO] Created a new app:")
    print(f"[INFO]         Name: {args.name}")
    print(f"[INFO]           ID: {new_id}")
    print(f"[INFO] Access Key: {key}", flush=True)
    return 0


def app_list(_args) -> int:
    from predictionio_tpu_torch.storage.registry import Storage

    apps = Storage.get_meta_data_apps().get_all()
    keys = Storage.get_meta_data_access_keys()
    print(f"[INFO] {'Name':<20} | {'ID':<4} | Access Key")
    for a in sorted(apps, key=lambda x: x.name):
        for k in keys.get_by_appid(a.id) or [None]:
            print(f"[INFO] {a.name:<20} | {a.id:<4} | {k.key if k else ''}")
    print(f"[INFO] Finished listing {len(apps)} app(s).", flush=True)
    return 0


def accesskey_new(args) -> int:
    from predictionio_tpu_torch.storage.base import AccessKey
    from predictionio_tpu_torch.storage.registry import Storage

    a = Storage.get_meta_data_apps().get_by_name(args.app_name)
    if a is None:
        _fail(f"App {args.app_name} does not exist. Aborting.")
    k = Storage.get_meta_data_access_keys().insert(
        AccessKey(key=args.key, appid=a.id, events=tuple(args.event)))
    if k is None:
        _fail("Unable to create access key.")
    print(f"[INFO] Created new access key: {k}", flush=True)
    return 0


def accesskey_list(args) -> int:
    from predictionio_tpu_torch.storage.registry import Storage

    keys = Storage.get_meta_data_access_keys()
    if args.app_name:
        a = Storage.get_meta_data_apps().get_by_name(args.app_name)
        if a is None:
            _fail(f"App {args.app_name} does not exist. Aborting.")
        listing = keys.get_by_appid(a.id)
    else:
        listing = keys.get_all()
    for k in listing:
        events = ",".join(k.events) if k.events else "(all)"
        print(f"[INFO] {k.key} | app {k.appid} | {events}")
    print(f"[INFO] Finished listing {len(listing)} access key(s).",
          flush=True)
    return 0


# -- events (EventServer.scala, commands/Import.scala) ----------------------

def eventserver(args) -> int:
    from predictionio_tpu_torch.server.event_server import run_event_server

    print(f"[INFO] Creating Event Server at {args.ip}:{args.port}",
          flush=True)

    def ready(port):
        print(f"[INFO] Event Server listening on http://{args.ip}:{port}",
              flush=True)

    run_event_server(args.ip, args.port, on_ready=ready, stats=args.stats)
    return 0


#: events per insert of ``import`` (the reference's batch)
IMPORT_BATCH = 5000


def import_events(args) -> int:
    from predictionio_tpu_torch.data.event import Event, validate_event
    from predictionio_tpu_torch.data.eventstore import resolve_app
    from predictionio_tpu_torch.storage.base import StorageError
    from predictionio_tpu_torch.storage.registry import Storage

    if args.appname:
        try:
            app_id, channel_id = resolve_app(args.appname, args.channel)
        except StorageError as e:
            _fail(f"{e}. Aborting.")
    elif args.appid is not None:
        app_id, channel_id = args.appid, None
    else:
        _fail("--appid or --appname is required.")
    store = Storage.get_events()
    store.init_channel(app_id, channel_id)
    batch, total = [], 0
    with open(args.input) as f:      # streamed: one batch in memory
        for line in f:
            line = line.strip()
            if not line:
                continue
            e = Event.from_json(line)
            validate_event(e)
            batch.append(e)
            if len(batch) >= IMPORT_BATCH:
                store.insert_batch(batch, app_id, channel_id)
                total += len(batch)
                batch = []
    if batch:
        store.insert_batch(batch, app_id, channel_id)
        total += len(batch)
    print(f"[INFO] Imported {total} events.", flush=True)
    return 0


# -- train / deploy / releases (commands/Engine.scala) ----------------------

def train(args) -> int:
    from predictionio_tpu_torch.core.engine import (
        StopAfterPrepareInterruption, StopAfterReadInterruption,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.workflow.context import (
        WorkflowContext, WorkflowParams,
    )
    from predictionio_tpu_torch.workflow.serialization import save_model
    from predictionio_tpu_torch.workflow.train import run_train

    engine, variant, engine_id, variant_id = _load_variant(args.variant)
    engine_params = engine.engine_params_from_json(variant)
    if engine_params.data_source_params is None:
        _fail(f"{args.variant}: a train needs the datasource section "
              "(its appName)")
    runtime_conf = {}
    if args.checkpoint_dir:
        runtime_conf["checkpoint_dir"] = args.checkpoint_dir
        runtime_conf["checkpoint_interval"] = str(args.checkpoint_interval)
    wp = WorkflowParams(batch=args.batch,
                        skip_sanity_check=args.skip_sanity_check,
                        stop_after_read=args.stop_after_read,
                        stop_after_prepare=args.stop_after_prepare,
                        runtime_conf=runtime_conf)
    # the device first: without a card (and without --device cpu) this
    # raises before anything is written
    ctx = WorkflowContext.create(mode="Training", batch=args.batch,
                                 workflow_params=wp, device=args.device)
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        instance, result = run_train(engine, engine_params,
                                     engine_factory=engine_id,
                                     engine_variant=variant_id,
                                     workflow_params=wp, ctx=ctx)
    except StopAfterReadInterruption:
        print("[INFO] Training interrupted by --stop-after-read.",
              flush=True)
        return 0
    except StopAfterPrepareInterruption:
        print("[INFO] Training interrupted by --stop-after-prepare.",
              flush=True)
        return 0
    train_s = time.perf_counter() - t0
    model = result.models[0]
    if args.out:
        save_model(args.out, model)
    release = _release_of(instance)
    print(f"[INFO] Training completed. Engine instance: {instance.id}"
          + (f" (release v{release.version})" if release else ""),
          flush=True)
    summary = _model_summary(model)
    print(json.dumps({
        "users": summary["users"], "items": summary["items"],
        "nnz": summary["nnz"], "rank": summary["rank"],
        "labels": summary["labels"], "features": summary["features"],
        "trees": summary["trees"], "d_model": summary["d_model"],
        "device": str(ctx.device), "train_s": train_s,
        "build_s": summary["build_s"],
        "models": [_model_summary(m) for m in result.models],
        "launches": kernels.counts(), "ingest": _ingest_counts(),
        "out": args.out, "instance": instance.id,
        "release": release.version if release else None}), flush=True)
    return 0


def _evaluation_of(path: str):
    """The evaluation a path names: an Evaluation, an Evaluation class
    (instantiated), or a factory (called)."""
    from predictionio_tpu_torch.core.base import load_class
    from predictionio_tpu_torch.core.evaluation import Evaluation

    evaluation = load_class(path)
    if isinstance(evaluation, type):
        return evaluation()
    if callable(evaluation) and not isinstance(evaluation, Evaluation):
        return evaluation()
    return evaluation


def _params_of(evaluation, generator_path: Optional[str]):
    """The engine params list: the generator's, else the evaluation's."""
    from predictionio_tpu_torch.core.base import load_class

    if generator_path:
        gen = load_class(generator_path)
        if isinstance(gen, type):
            gen = gen()
        elif callable(gen) and not hasattr(gen, "engine_params_list"):
            gen = gen()
        return list(gen.engine_params_list)
    return list(getattr(evaluation, "engine_params_list", []))


def eval_cmd(args) -> int:
    """Run an evaluation sweep (Console.scala:232)."""
    import dataclasses

    from predictionio_tpu_torch.core.evaluation import (
        VECTORIZE_ENV, expand_param_grid,
    )
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.workflow.context import (
        WorkflowContext, WorkflowParams,
    )
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    wp = WorkflowParams(batch=args.batch)
    # the device first: without a card (and without --device cpu) this
    # raises before anything is loaded or written
    ctx = WorkflowContext.create(mode="Evaluation", batch=args.batch,
                                 workflow_params=wp, device=args.device)
    evaluation = _evaluation_of(args.evaluation_path)
    params_list = _params_of(evaluation, args.params_generator_path)
    if not params_list:
        _fail("No engine params to evaluate. Aborting.")
    try:
        params_list = expand_param_grid(params_list, args.grid)
    except ValueError as e:
        _fail(f"{e}. Aborting.")
    overrides = {k: v for k, v in (("kFold", args.k_fold),
                                   ("queryNum", args.query_num))
                 if v is not None}
    if overrides:
        patched = []
        for ep in params_list:
            ds = ep.data_source_params
            if not hasattr(ds, "eval_params"):
                _fail("--k-fold/--query-num need a datasource with "
                      "eval_params. Aborting.")
            ds = dataclasses.replace(
                ds, eval_params={**(ds.eval_params or {}), **overrides})
            patched.append(dataclasses.replace(ep, data_source_params=ds))
        params_list = patched
    old_vectorize = os.environ.get(VECTORIZE_ENV)
    if args.sequential:
        os.environ[VECTORIZE_ENV] = "0"
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        result = run_evaluation(
            evaluation, params_list,
            evaluation_class=args.evaluation_path,
            params_generator_class=args.params_generator_path or "",
            workflow_params=wp, ctx=ctx)
    except Exception as e:
        _fail(f"Evaluation failed: {type(e).__name__}: {e}")
    finally:
        if args.sequential:
            if old_vectorize is None:
                os.environ.pop(VECTORIZE_ENV, None)
            else:
                os.environ[VECTORIZE_ENV] = old_vectorize
    eval_s = time.perf_counter() - t0
    sweep = result.sweep or {}
    if sweep.get("mode") == "batched":
        print(f"[INFO] Sweep ran device-batched: {len(params_list)} "
              f"candidates in {sweep.get('compileGroups')} compile "
              f"group(s), batch sizes {sweep.get('batchSizes')}")
    for i, detail in enumerate(result.candidate_details):
        _ep, score, _others = result.engine_params_scores[i]
        print(f"[INFO]   #{i}: score={score} "
              f"wall={detail.get('wallTimeS')}s "
              f"group={detail.get('group')}"
              + (" <- best" if i == result.best_idx else ""))
    print(f"[INFO] {result.to_one_liner()}")
    print("[INFO] Evaluation completed.", flush=True)
    print(json.dumps({
        "mode": sweep.get("mode"), "candidates": len(params_list),
        "groups": sweep.get("compileGroups"),
        "batch_sizes": sweep.get("batchSizes"),
        "seconds": sweep.get("seconds"),
        "best_idx": result.best_idx, "best_score": result.best_score,
        "best_params": result.best_engine_params.to_json_dict(),
        "scores": [[s, o] for _ep, s, o in result.engine_params_scores],
        "device": str(ctx.device), "launches": kernels.counts(),
        "ingest": _ingest_counts(), "eval_s": eval_s}), flush=True)
    return 0


def _release_of(instance):
    """The release registered for an instance, if any (instances
    trained before releases existed deploy without one)."""
    from predictionio_tpu_torch.deploy.releases import release_of_instance
    from predictionio_tpu_torch.storage.registry import Storage

    return release_of_instance(Storage.get_meta_data_releases(), instance)


def _instance_to_deploy(args, engine_id: str, variant_id: str):
    """(instance, release) the deploy flags select."""
    from predictionio_tpu_torch.deploy.releases import resolve_release
    from predictionio_tpu_torch.storage.registry import Storage

    instances = Storage.get_meta_data_engine_instances()
    release = None
    if args.release:
        release = resolve_release(Storage.get_meta_data_releases(),
                                  engine_id, "1", variant_id, args.release)
        if release is None:
            _fail(f"Release {args.release} not found (see `releases`). "
                  "Aborting.")
        instance = instances.get(release.instance_id)
        if instance is None or instance.status != "COMPLETED":
            _fail(f"Release v{release.version} points at instance "
                  f"{release.instance_id}, which is not deployable. "
                  "Aborting.")
    elif args.engine_instance_id:
        instance = instances.get(args.engine_instance_id)
        if instance is None or instance.status != "COMPLETED":
            _fail(f"Engine instance {args.engine_instance_id} is not "
                  "deployable. Aborting.")
    else:
        instance = instances.get_latest_completed(engine_id, "1",
                                                  variant_id)
        if instance is None:
            _fail("No COMPLETED engine instance found. Run `train` first. "
                  "Aborting.")
    return instance, release or _release_of(instance)


def deploy(args) -> int:
    from predictionio_tpu_torch.deploy.warm import DeployError
    from predictionio_tpu_torch.server.query_server import (
        create_query_server, run_query_server,
    )
    from predictionio_tpu_torch.storage.base import EngineInstance
    from predictionio_tpu_torch.obs.registry import (
        MetricsRegistry, default_registry,
    )
    from predictionio_tpu_torch.obs.slo import slo_spec_from_server_json
    from predictionio_tpu_torch.obs.telemetry import build_recorder
    from predictionio_tpu_torch.utils.server_config import (
        deploy_config, foldin_config, scorer_config, telemetry_config,
    )
    from predictionio_tpu_torch.workflow.serialization import load_model
    from predictionio_tpu_torch.workflow.train import load_for_deploy

    t0 = time.perf_counter()
    release = None
    if args.model:
        variant = {}
        if args.variant:
            with open(args.variant) as f:
                variant = json.load(f)
        engine = _engine_of(variant)
        engine_params = engine.engine_params_from_json(
            variant if variant.get("algorithms") else
            {"algorithms": [{"name": "als", "params": {}}]})
        model = load_model(args.model, device=args.device)
        result = engine.prepare_deploy(engine_params, [model])
        instance = EngineInstance(
            id=os.path.basename(args.model), status="COMPLETED",
            engine_id=variant.get("engineFactory") or type(engine).__name__,
            engine_version="1", engine_variant=variant.get("id", "default"))
    else:
        engine, variant, engine_id, variant_id = _load_variant(
            args.variant or "engine.json")
        instance, release = _instance_to_deploy(args, engine_id, variant_id)
        print(f"[INFO] Deploying engine instance {instance.id}"
              + (f" (release v{release.version})" if release else "")
              + f" at {args.ip}:{args.port}", flush=True)
        try:
            result, _ctx = load_for_deploy(engine, instance,
                                           device=args.device)
        except DeployError as e:
            _fail(f"{e}. Aborting.")
        model = result.models[0]
    scfg = scorer_config(variant.get("scorer"))
    fic = foldin_config(variant.get("foldin"))
    summary = _model_summary(model)
    shape = (f"{summary['labels']} labels x {summary['features']} "
             f"features" + (f", {summary['trees']} trees"
                            if summary["trees"] else "")
             if summary["labels"] is not None else
             f"{summary['items']} items, d_model {summary['d_model']}"
             if summary["d_model"] is not None else
             f"{summary['users']} users x {summary['items']} items, rank "
             f"{summary['rank']}")
    print(f"[INFO] Loaded {instance.id}: {summary['kind']}, {shape}, on "
          f"{getattr(model, 'device', None)} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    # durable telemetry (env > engine.json "telemetry" > server.json;
    # PIO_TELEMETRY=0 off) in the store query_server-<port>, and the
    # server.json "slo" objectives (PIO_SLO=0 off)
    registry = MetricsRegistry()
    telemetry = build_recorder(
        "query_server", telemetry_config(variant.get("telemetry")),
        instance=str(args.port), registries=[registry, default_registry()])
    server = create_query_server(engine, result, instance,
                                 registry=registry, telemetry=telemetry,
                                 slo_spec=slo_spec_from_server_json(),
                                 scorer_config=scfg, release=release,
                                 access_key=args.accesskey,
                                 foldin_config=fic,
                                 deploy_config=deploy_config(),
                                 feedback=args.feedback,
                                 feedback_app_name=args.event_server_app,
                                 log_url=args.log_url,
                                 log_prefix=args.log_prefix)
    report = server.warm()
    print(f"[INFO] Warm-up: batches {report.buckets} in "
          f"{report.seconds:.3f} s; scorer mode {scfg.mode}", flush=True)
    if fic.enabled:
        print(f"[INFO] Online fold-in enabled: apply interval "
              f"{fic.apply_interval_s:g}s, max pending {fic.max_pending} "
              "rows", flush=True)

    def ready(port):
        print(f"[INFO] Query server listening on http://{args.ip}:{port}",
              flush=True)

    run_query_server(server, args.ip, args.port, on_ready=ready)
    return 0


def multiserve(args) -> int:
    """Serve N engine variants from one process under one device-memory
    budget (``server/multitenant``): per-tenant routes at
    ``/t/NAME/queries.json``, LRU warm eviction and reload under
    ``PIO_MT_DEVICE_BUDGET_BYTES``, per-tenant scorer residency, and
    SLO-burn admission."""
    from predictionio_tpu_torch.deploy.warm import DeployError
    from predictionio_tpu_torch.server.multitenant import (
        DEFAULT_PORT, TenantSpec, run_multitenant_server,
    )
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.server_config import (
        foldin_config, scorer_config,
    )
    from predictionio_tpu_torch.workflow.train import load_for_deploy

    port = DEFAULT_PORT if args.port is None else args.port
    specs = []
    instances = Storage.get_meta_data_engine_instances()
    for entry in args.tenant_specs:
        name, sep, variant_path = entry.partition("=")
        if not sep or not name or not variant_path:
            _fail(f"--tenant wants NAME=VARIANT_PATH, got {entry!r}. "
                  "Aborting.")
        engine, variant, engine_id, variant_id = _load_variant(variant_path)
        instance = instances.get_latest_completed(engine_id, "1",
                                                  variant_id)
        if instance is None:
            _fail(f"Tenant {name!r}: no COMPLETED engine instance for "
                  f"{variant_path}. Run `train` first. Aborting.")
        release = _release_of(instance)
        scfg = scorer_config(variant.get("scorer"))
        try:
            result, _ctx = load_for_deploy(engine, instance,
                                           device=args.device)
        except DeployError as e:
            _fail(f"Tenant {name!r}: {e}. Aborting.")
        print(f"[INFO] Tenant {name!r}: instance {instance.id}"
              + (f" (release v{release.version})" if release else "")
              + f", scorer {scfg.mode}", flush=True)
        specs.append(TenantSpec(
            name=name, engine=engine, train_result=result,
            instance=instance, release=release, scorer_config=scfg,
            foldin_config=foldin_config(variant.get("foldin")),
            slo=variant.get("slo")))
    print(f"[INFO] Hosting {len(specs)} tenant(s) at {args.ip}:{port}",
          flush=True)

    def ready(bound):
        print(f"[INFO] Multi-tenant server listening on "
              f"http://{args.ip}:{bound}", flush=True)

    try:
        run_multitenant_server(specs, ip=args.ip, port=port,
                               on_ready=ready, access_key=args.accesskey)
    except ValueError as e:         # a tenant name the host refuses
        _fail(f"{e}. Aborting.")
    return 0


def batchpredict(args) -> int:
    """Offline batch scoring (Console.scala:331, BatchPredict.scala:71)."""
    from predictionio_tpu_torch.deploy.releases import resolve_release
    from predictionio_tpu_torch.deploy.warm import DeployError
    from predictionio_tpu_torch.ops import kernels
    from predictionio_tpu_torch.ops.scoring import set_process_scorer_config
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.utils.server_config import (
        batchpredict_config, scorer_config,
    )
    from predictionio_tpu_torch.workflow.batch_predict import (
        check_formats, run_batch_predict,
    )

    # the device first: without a card (and without --device cpu) this
    # raises before anything is read or written
    device = resolve_device(args.device)
    engine, variant, engine_id, variant_id = _load_variant(args.variant)
    variant_conf = variant.get("batchpredict")
    try:
        check_formats(args.input_path, args.output_path, args.input_format,
                      args.output_format, batchpredict_config(variant_conf))
    except ValueError as e:
        _fail(f"{e}. Aborting.")
    # offline scoring honors the same scorer-mode chain as serving, so
    # batch runs and the query server score alike
    scfg = scorer_config(variant.get("scorer"))
    set_process_scorer_config(scfg)
    if scfg.mode != "exact":
        print(f"[INFO] Scoring kernel {scfg.mode} (tile "
              f"{scfg.tile_items} items)", flush=True)
    instances = Storage.get_meta_data_engine_instances()
    if args.release:
        release = resolve_release(Storage.get_meta_data_releases(),
                                  engine_id, "1", variant_id, args.release)
        if release is None:
            _fail(f"Release {args.release} not found (see `releases`). "
                  "Aborting.")
        instance = instances.get(release.instance_id)
        if instance is not None and instance.status == "COMPLETED":
            print(f"[INFO] Scoring with release v{release.version} "
                  f"(instance {release.instance_id})", flush=True)
    elif args.engine_instance_id:
        instance = instances.get(args.engine_instance_id)
    else:
        instance = instances.get_latest_completed(engine_id, "1",
                                                  variant_id)
    if instance is None or instance.status != "COMPLETED":
        _fail("No COMPLETED engine instance found. Aborting.")
    kernels.reset_counts()
    try:
        report = run_batch_predict(
            engine, instance, args.input_path, args.output_path,
            chunk_size=args.chunk_size, output_format=args.output_format,
            input_format=args.input_format, variant_conf=variant_conf,
            device=device)
    except DeployError as e:
        _fail(f"{e}. Aborting.")
    if report.merged:
        print(f"[INFO] Wrote {report.total_written} predictions to "
              f"{report.output_path}")
        if report.fleet:
            totals = report.fleet.get("counterTotals", {})
            scored = totals.get("pio_batchpredict_queries_total")
            print(f"[INFO] Fleet view ({len(report.fleet.get('processes', []))}"
                  f" process(es)) -> {report.output_path}.fleet.json"
                  + (f"; fleet queries scored {scored:g}"
                     if scored is not None else ""))
    else:
        rank, size = report.worker
        print(f"[INFO] Shard {rank}/{size} wrote {report.written} "
              f"predictions to fragment {report.output_path} "
              "(awaiting merge by the last shard)")
    if report.invalid or (report.total_invalid or 0):
        n_bad = report.total_invalid if report.merged else report.invalid
        print(f"[WARN] Skipped {n_bad} invalid queries "
              f"-> {report.errors_path}")
    if report.trace_id:
        print(f"[INFO] Trace id {report.trace_id} (in the .fleet.json of "
              "a sharded run)")
    print(json.dumps({
        "written": report.written, "invalid": report.invalid,
        "total_written": report.total_written,
        "total_invalid": report.total_invalid,
        "chunks": report.chunks, "pad_waste": report.pad_waste,
        "seconds": report.seconds,
        "rows_per_second": report.rows_per_second,
        "lane": report.lane, "lane_fallbacks": report.lane_fallbacks,
        "launches": kernels.counts(), "worker": list(report.worker),
        "merged": report.merged, "output": report.output_path,
        "errors": report.errors_path, "instance": instance.id,
        "device": str(device)}), flush=True)
    return 0


def releases(args) -> int:
    from predictionio_tpu_torch.storage.registry import Storage

    _engine, _variant, engine_id, variant_id = _load_variant(args.variant)
    listing = Storage.get_meta_data_releases().get_for_variant(
        engine_id, "1", variant_id)
    if args.status:
        listing = [r for r in listing if r.status == args.status.upper()]
    print(f"[INFO] {'Ver':<5} | {'Status':<11} | "
          f"{'Instance':<32} | {'Created':<20} | Model")
    for r in listing:
        size = (f"{r.model_size_bytes / 1024:.0f}KiB"
                if r.model_size_bytes else "-")
        digest = r.model_digest[:12] if r.model_digest else "-"
        print(f"[INFO] v{r.version:<4} | {r.status:<11} | "
              f"{r.instance_id:<32} | "
              f"{r.created_time.strftime('%Y-%m-%d %H:%M:%S'):<20} | "
              f"{digest} {size}")
    print(f"[INFO] Finished listing {len(listing)} release(s).", flush=True)
    return 0


def rollback(args) -> int:
    """``POST /rollback.json`` to a running query server."""
    import urllib.error
    import urllib.request

    url = f"http://{args.ip}:{args.port}/rollback.json"
    if args.accesskey:
        url += f"?accessKey={args.accesskey}"
    try:
        with urllib.request.urlopen(
                urllib.request.Request(url, data=b"", method="POST"),
                timeout=60) as r:
            out = json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            message = json.loads(e.read().decode()).get("message", str(e))
        except Exception:
            message = str(e)
        _fail(f"Rollback failed: {message}")
    except OSError as e:
        _fail(f"Unable to reach query server: {e}")
    version, seconds = out.get("releaseVersion"), out.get("seconds")
    print(f"[INFO] {out.get('message', 'Rolled back')}: now serving "
          f"instance {out.get('engineInstanceId')}"
          + (f" (release v{version})" if version else "")
          + (f" in {seconds * 1e3:.3f} ms" if seconds is not None else ""),
          flush=True)
    return 0


def undeploy(args) -> int:
    """``POST /stop`` to a running query server (Console.scala:318)."""
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    if args.accesskey:
        url += f"?accessKey={args.accesskey}"
    try:
        with urllib.request.urlopen(
                urllib.request.Request(url, data=b"", method="POST"),
                timeout=10) as r:
            print(f"[INFO] {r.read().decode()}", flush=True)
    except Exception as e:
        _fail(f"Unable to undeploy: {e}")
    return 0


# -- observability (cli/main.py:888-1198 of the reference) ------------------

def _parse_duration_s(text) -> float:
    """'30m' / '2h' / '45s' / '1d' / plain seconds -> float seconds."""
    text = str(text).strip().lower()
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    try:
        if text and text[-1] in units:
            return float(text[:-1]) * units[text[-1]]
        return float(text)
    except ValueError:
        _fail(f"{text!r} is not a duration (try 30m, 2h, 45s)")


def _get_json(url: str) -> dict:
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read().decode())
    except Exception as e:
        _fail(f"Unable to read {url}: {e}")


def traces(args) -> int:
    """Read a live server's flight recorder (GET /debug/traces.json)."""
    import urllib.parse

    params = {"limit": str(args.limit)}
    if args.trace_id:
        params["traceId"] = args.trace_id
    if args.since:
        params["sinceS"] = str(_parse_duration_s(args.since))
    doc = _get_json(f"http://{args.ip}:{args.port}/debug/traces.json?"
                    + urllib.parse.urlencode(params))
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True), flush=True)
        return 0
    for t in doc.get("traces", []):
        spans = " ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in (t.get("spans") or {}).items())
        print(f"[INFO] {t.get('traceId', '?')[:12]} "
              f"{t.get('name')} {t.get('durationSec', 0) * 1e3:.1f}ms "
              f"[{t.get('status')}] proc={t.get('process')}"
              + (f" | {spans}" if spans else ""), flush=True)
    if args.show_events:
        for e in doc.get("events", []):
            tid = (e.get("traceId") or "-")[:12]
            rest = {k: v for k, v in e.items()
                    if k not in ("kind", "ts", "traceId", "process")}
            print(f"[INFO] event {e.get('kind')} trace={tid} {rest}",
                  flush=True)
    print(f"[INFO] {len(doc.get('traces', []))} trace record(s), "
          f"{len(doc.get('events', []))} lifecycle event(s).", flush=True)
    return 0


def profile(args) -> int:
    """Capture a bounded device profile from a live query server (POST
    /debug/profile): a torch.profiler trace plus the per-family
    dispatch table."""
    import urllib.error
    import urllib.request

    url = f"http://{args.ip}:{args.port}/debug/profile"
    if args.accesskey:
        url += f"?accessKey={args.accesskey}"
    body = json.dumps({"seconds": args.seconds,
                       **({"dir": args.outdir} if args.outdir else {})}
                      ).encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=args.seconds + 30) as r:
            out = json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            message = json.loads(e.read().decode()).get("message", str(e))
        except Exception:
            message = str(e)
        _fail(f"Profile failed: {message}")
    except Exception as e:
        _fail(f"Unable to reach query server: {e}")
    print(f"[INFO] Captured {out.get('seconds')}s device profile "
          f"-> {out.get('traceDir')}", flush=True)
    dispatch = out.get("dispatch") or {}
    if dispatch:
        print("[INFO] Dispatch seconds by kernel family "
              "(cumulative since process start):", flush=True)
        for family, secs in dispatch.items():
            print(f"[INFO]   {family:<24} {secs:.3f}s", flush=True)
    else:
        print("[INFO] No dispatch attribution recorded yet "
              "(PIO_DISPATCH_ATTRIBUTION=0, or nothing dispatched).",
              flush=True)
    return 0


def slo(args) -> int:
    """Read a live query server's SLO burn-rate evaluation (/slo.json)."""
    doc = _get_json(f"http://{args.ip}:{args.port}/slo.json")
    if not doc.get("enabled"):
        print("[INFO] SLO engine disabled "
              '(configure server.json {"slo": {...}}).', flush=True)
        return 0
    state = "BREACHED" if doc.get("breached") else "ok"
    print(f"[INFO] SLO status: {state}", flush=True)
    for obj in doc.get("objectives", []):
        mark = "BREACHED" if obj.get("breached") else "ok"
        if obj.get("window") == "cold":
            mark += " (cold: history does not span the window yet)"
        windows = ", ".join(
            f"{int(w['seconds'])}s burn {w['burn']:.2f}/{w['burnThreshold']}"
            for w in obj.get("windows", []))
        print(f"[INFO]   {obj['name']} ({obj['kind']}): {mark} "
              f"[{windows}]", flush=True)
    return 0


def capacity(args) -> int:
    """Read a live server's device-memory ledger (GET /capacity.json)."""
    doc = _get_json(f"http://{args.ip}:{args.port}/capacity.json")
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True), flush=True)
        return 0

    def _mb(n):
        return f"{float(n or 0) / (1 << 20):.1f}MiB"

    proc = doc.get("process") or {}
    print(f"[INFO] process: device {_mb(proc.get('deviceBytes'))} "
          f"across {int(proc.get('deviceArrays') or 0)} array(s), "
          f"watermark {_mb(proc.get('deviceWatermarkBytes'))}, "
          f"host RSS {_mb(proc.get('hostRssBytes'))}", flush=True)
    units = doc.get("units") or []
    for u in units:
        print(f"[INFO] unit {u.get('role')}: resident "
              f"{_mb(u.get('residentBytes'))} (scorer "
              f"{_mb(u.get('scorerBytes'))}) release "
              f"v{u.get('release')} instance "
              f"{u.get('engineInstanceId')}", flush=True)
        for m in u.get("models") or []:
            print(f"[INFO]   {m.get('model')}: factors "
                  f"{_mb(m.get('modelFactorBytes'))} + scorer "
                  f"{_mb(m.get('scorerFactorBytes'))} + shortlist "
                  f"{_mb(m.get('shortlistBytes'))}", flush=True)
    if not units:
        print("[INFO] no serving units reported (the event server "
              "answers process-level only).", flush=True)
    return 0


def _history_reader(dirpath):
    from predictionio_tpu_torch.obs import fleet
    from predictionio_tpu_torch.utils.server_config import telemetry_config

    root = dirpath or telemetry_config().root_dir()
    return root, fleet.history_reader(root)


def metrics_series(args) -> int:
    """List the persisted series: name, labels, sample count, range."""
    root, reader = _history_reader(args.dirpath)
    listing = reader.series(name=args.name)
    for info in listing:
        if not info.points:
            continue
        span = (info.points[-1][0] - info.points[0][0]) / 1000.0
        print(f"[INFO] {info.name} {info.labels} [{info.kind}] "
              f"{len(info.points)} sample(s) over {span:.0f}s", flush=True)
    print(f"[INFO] {len(listing)} series in {root}.", flush=True)
    return 0


def metrics_query(args) -> int:
    """Range-query a metric's persisted history, merged across every
    local process's store (each labeled with its ``process``)."""
    root, reader = _history_reader(args.dirpath)
    name = args.metric
    since_ms = int((time.time() - _parse_duration_s(args.since)) * 1000)
    labels = {}
    for spec in args.label_filters:
        if "=" not in spec:
            _fail(f"--label expects KEY=VALUE, got {spec!r}")
        k, v = spec.split("=", 1)
        labels[k] = v
    labels = labels or None
    if args.quantile is not None:
        value = reader.quantile_over_time(name, args.quantile,
                                          labels=labels, since_ms=since_ms)
        if args.as_json:
            print(json.dumps({"name": name, "quantile": args.quantile,
                              "value": value}), flush=True)
        elif value is None:
            print(f"[INFO] no histogram data for {name} in the window "
                  f"(root {root}).", flush=True)
        else:
            print(f"[INFO] {name} p{args.quantile * 100:g} over "
                  f"{args.since}: {value:.6g}", flush=True)
        return 0
    if args.as_rate:
        rates = reader.rate(name, labels=labels, since_ms=since_ms)
        if args.as_json:
            print(json.dumps({"name": name, "series": rates}), flush=True)
            return 0
        for r in rates:
            print(f"[INFO] {name} {r['labels']}: {r['rate']:.4g}/s "
                  f"(+{r['increase']:.6g} over {r['seconds']:.0f}s)",
                  flush=True)
        if not rates:
            print(f"[INFO] no data for {name} in the window (root "
                  f"{root}).", flush=True)
        return 0
    series = reader.series(name=name, labels=labels, since_ms=since_ms)
    if args.as_json:
        out = []
        for info in series:
            points = ([[ts, sum(c), s] for ts, c, s in info.points]
                      if info.kind == "histogram"
                      else [[ts, v] for ts, v in info.points])
            out.append({"labels": info.labels, "kind": info.kind,
                        "points": points})
        print(json.dumps({"name": name, "series": out}), flush=True)
        return 0
    shown = 0
    for info in series:
        if not info.points:
            continue
        shown += 1
        if info.kind == "histogram":
            first, last = info.points[0], info.points[-1]
            print(f"[INFO] {name} {info.labels} [histogram]: count "
                  f"{sum(first[1]):g} -> {sum(last[1]):g} over "
                  f"{len(info.points)} sample(s)", flush=True)
        else:
            values = [p[1] for p in info.points]
            print(f"[INFO] {name} {info.labels} [{info.kind}]: "
                  f"{values[0]:g} -> {values[-1]:g} over {len(values)} "
                  f"sample(s)", flush=True)
    if not shown:
        print(f"[INFO] no data for {name} in the window (root {root}).",
              flush=True)
    return 0


# -- the serving fleet (router), continuous training (orchestrate) and
#    status ----------------------------------------------------------------

def router(args) -> int:
    """Serve a replicated fleet behind one router (``server/router``):
    spawn N ``deploy`` replicas under the worker-env contract (one trace
    id spans router -> replica -> device), spread queries with the
    error-diffusion splitter, sequence fleet cutovers, and autoscale on
    the SLO burn signal when server.json/env enable it. The router
    itself computes nothing and never touches the card; each replica
    runs on ``--device`` (default ``cuda``)."""
    import subprocess

    from predictionio_tpu_torch.server.router import run_router
    from predictionio_tpu_torch.utils.server_config import router_config

    cfg = router_config()
    if args.port is not None:
        cfg.port = args.port
    if args.replicas is not None:
        cfg.replicas = max(1, args.replicas)

    spawn = None
    if not args.replica_urls:
        from predictionio_tpu_torch.parallel.distributed import worker_env

        def spawn(rank):
            """One replica = one ``deploy`` subprocess on base_port +
            rank, carrying the router's trace context and the
            PIO_PROCESS_ID/PIO_NUM_PROCESSES contract."""
            from predictionio_tpu_torch.server.router import ReplicaHandle

            port_r = cfg.base_port + rank
            argv = [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                    "deploy", "--variant", args.variant, "--ip", args.ip,
                    "--port", str(port_r)]
            if args.accesskey:
                argv += ["--accesskey", args.accesskey]
            if args.device:
                argv += ["--device", args.device]
            env = worker_env(rank, max(cfg.replicas, rank + 1),
                             base=dict(os.environ))
            proc = subprocess.Popen(argv, env=env)
            print(f"[INFO] Spawned replica {rank} (pid {proc.pid}) on "
                  f"{args.ip}:{port_r}", flush=True)
            return ReplicaHandle(rank=rank,
                                 url=f"http://{args.ip}:{port_r}",
                                 proc=proc)

    print(f"[INFO] Router starting at {args.ip}:{cfg.port} over "
          + (f"{len(args.replica_urls)} existing replica(s)"
             if args.replica_urls else f"{cfg.replicas} replica(s)"),
          flush=True)

    def ready(port):
        print(f"[INFO] Router listening on http://{args.ip}:{port}",
              flush=True)

    run_router(config=cfg, ip=args.ip, spawn=spawn,
               replica_urls=tuple(args.replica_urls), on_ready=ready)
    return 0


def orchestrate(args) -> int:
    """Continuous-training orchestrator: the closed Lambda loop
    (``deploy/orchestrator``). Recurring train -> eval gate ->
    batchpredict smoke -> SLO-judged canary -> promote over the release
    registry, with crash-safe phase state (kill it anywhere; the next
    start converges), data-driven retrain triggers (ingest volume,
    fold-in pressure, SLO burn) and jittered backoff on failure. The
    workflows run on ``--device`` (default ``cuda``)."""
    from predictionio_tpu_torch.deploy.orchestrator import (
        build_orchestrator,
    )

    from predictionio_tpu_torch.utils.device import resolve_device

    # the device first: without a card (and without --device cpu) this
    # raises before anything is read or written
    resolve_device(args.device)
    if not os.path.exists(args.variant):
        _fail(f"{args.variant} does not exist. Aborting.")
    orch = build_orchestrator(args.variant, eval_path=args.eval_class,
                              server=args.server,
                              access_key=args.accesskey,
                              state_dir=args.state_dir, device=args.device)
    cfg = orch.cfg
    print(f"[INFO] Orchestrating {orch.engine_id}/{orch.engine_variant} "
          f"(state in {orch.store.state_dir})", flush=True)
    print(f"[INFO] Triggers: ingest>={cfg.min_ingest_events or 'off'}"
          f" foldin>={cfg.foldin_pending_max or 'off'}"
          f" slo={'on' if cfg.slo_trigger else 'off'}; "
          f"cooldown {cfg.cooldown_s:g}s, check every "
          f"{cfg.interval_s:g}s", flush=True)
    print("[INFO] Canary plane: "
          + (f"live server {args.server}" if args.server
             else "release registry"), flush=True)
    if args.once or args.force:
        action = orch.recover()
        if action:
            print(f"[INFO] Recovery: {action}", flush=True)
        doc = orch.tick(force=args.force)
        if doc is None:
            print("[INFO] No trigger fired; nothing to do.", flush=True)
            return 0
        _echo_cycle(doc)
        return 0 if doc.outcome == "promoted" else 1
    try:
        done = orch.run(cycles=args.cycles)
    except KeyboardInterrupt:
        print("[INFO] Orchestrator stopped.", flush=True)
        return 0
    print(f"[INFO] Orchestrator exiting after {done} cycle(s).", flush=True)
    return 0


def _echo_cycle(doc) -> None:
    print(f"[INFO] Cycle {doc.cycle_id} ({doc.trigger}): "
          f"{doc.outcome} — {doc.reason}", flush=True)
    if doc.candidate_release_version:
        print(f"[INFO]   candidate release "
              f"v{doc.candidate_release_version}"
              + (f" | eval score {doc.eval_score}"
                 if doc.eval_score is not None else ""), flush=True)
    trace = (doc.trace or ":").split(":")[0]
    print(f"[INFO]   trace id {trace} (follow with `traces "
          f"--trace-id {trace}` on a live server)", flush=True)


def status(args) -> int:
    """Verify the storage configuration (Console.scala:435,
    Management.scala:99); with ``--fleet``, print a sharded run's merged
    per-process metric view, or a telemetry root's stores."""
    if args.fleet_path:
        return _print_fleet(args.fleet_path)
    from predictionio_tpu_torch.storage.registry import Storage

    print("[INFO] Inspecting predictionio_tpu_torch installation...",
          flush=True)
    try:
        Storage.verify_all_data_objects()
    except Exception as e:
        _fail(f"Unable to connect to all storage backends: {e}")
    print("[INFO] All storage backends are properly configured.",
          flush=True)
    print("[INFO] Your system is all ready to go.", flush=True)
    return 0


def _print_fleet(path) -> int:
    """The merged fleet view: per-process counters, exact fleet totals,
    and the trace ids spanning the run. A directory is read as a
    durable-telemetry root instead (``obs/fleet.history_reader``): one
    summary line per process store."""
    if os.path.isdir(path):
        return _print_fleet_history(path)
    if not path.endswith(".fleet.json") and not os.path.exists(path):
        path = f"{path}.fleet.json"
    elif os.path.isfile(f"{path}.fleet.json"):
        path = f"{path}.fleet.json"
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        _fail(f"cannot read fleet view {path}: {e}")
    print(f"[INFO] Fleet view {path}: "
          f"{len(doc.get('processes', []))} process(es) "
          f"{doc.get('processes')}", flush=True)
    totals = doc.get("counterTotals", {})
    metrics = doc.get("metrics", {})
    for name in sorted(totals):
        print(f"[INFO] {name} fleet total: {totals[name]:g}")
        for sample in metrics.get(name, {}).get("samples", []):
            labels = sample.get("labels", {})
            proc = labels.get("process", "?")
            rest = {k: v for k, v in labels.items() if k != "process"}
            suffix = f" {rest}" if rest else ""
            print(f"[INFO]   process {proc}{suffix}: "
                  f"{sample.get('value'):g}")
    trace_ids = []
    for t in doc.get("traces", []):
        tid = t.get("traceId")
        if tid and tid not in trace_ids:
            trace_ids.append(tid)
    for tid in trace_ids:
        spans = [t for t in doc.get("traces", [])
                 if t.get("traceId") == tid]
        procs = sorted({t.get("process", "?") for t in spans})
        print(f"[INFO] trace {tid}: {len(spans)} span(s) across "
              f"processes {procs}")
    sys.stdout.flush()
    return 0


def _print_fleet_history(root) -> int:
    """Fleet-wide history summary over a telemetry root: the merged
    per-process stores (one ``process`` label per service directory)."""
    import datetime as _dt

    from predictionio_tpu_torch.obs import fleet

    reader = fleet.history_reader(root)
    by_process = {}
    for info in reader.series():
        if not info.points:
            continue
        proc = info.labels.get("process", "?")
        count, newest = by_process.get(proc, (0, 0))
        by_process[proc] = (count + 1, max(newest, info.points[-1][0]))
    if not by_process:
        print(f"[INFO] No telemetry stores under {root}.", flush=True)
        return 0
    print(f"[INFO] Telemetry root {root}: {len(by_process)} process "
          "store(s)")
    for proc, (count, newest) in sorted(by_process.items()):
        when = _dt.datetime.fromtimestamp(newest / 1000.0)
        print(f"[INFO]   {proc}: {count} series, newest sample "
              f"{when.strftime('%Y-%m-%d %H:%M:%S')}")
    for _ts, e in reader.events()[-10:]:
        print(f"[INFO]   event {e.get('kind')} "
              f"proc={e.get('process', '?')} "
              f"trace={(e.get('traceId') or '-')[:12]}")
    sys.stdout.flush()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.cli.main")
    sub = p.add_subparsers(dest="command", required=True)

    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_command", required=True)
    a = app.add_parser("new", help="create an app, its event table and "
                                   "an access key")
    a.add_argument("name")
    a.add_argument("--id", type=int, default=0, help="preferred app id")
    a.add_argument("--description", default=None)
    a.add_argument("--access-key", default="",
                   help="use this access key instead of generating one")
    a.set_defaults(func=app_new)
    app.add_parser("list", help="list apps and their keys").set_defaults(
        func=app_list)

    keys = sub.add_parser("accesskey", help="manage access keys"
                          ).add_subparsers(dest="key_command", required=True)
    k = keys.add_parser("new", help="add an access key to an app")
    k.add_argument("app_name")
    k.add_argument("--key", default="")
    k.add_argument("--event", action="append", default=[],
                   help="allowed event name (repeatable; default: all)")
    k.set_defaults(func=accesskey_new)
    k = keys.add_parser("list", help="list access keys")
    k.add_argument("app_name", nargs="?", default=None)
    k.set_defaults(func=accesskey_list)

    tp = sub.add_parser("template", help="engine templates"
                        ).add_subparsers(dest="template_command",
                                         required=True)
    tp.add_parser("list", help="list the built-in engine templates"
                  ).set_defaults(func=template_list)
    tg = tp.add_parser("get", help="scaffold an engine.json for a "
                                   "built-in template")
    tg.add_argument("name")
    tg.add_argument("directory", nargs="?", default=None)
    tg.set_defaults(func=template_get)

    e = sub.add_parser("eventserver", help="serve the event REST API")
    e.add_argument("--ip", default="localhost")
    e.add_argument("--port", default=7070, type=int)
    e.add_argument("--stats", action="store_true",
                   help="keep ingest statistics at /stats.json")
    e.set_defaults(func=eventserver)

    i = sub.add_parser("import", help="import events from a JSON-lines "
                                      "file")
    i.add_argument("--appid", type=int, default=None)
    i.add_argument("--appname", default=None)
    i.add_argument("--channel", default=None)
    i.add_argument("--input", required=True,
                   help="JSON-lines file of events")
    i.set_defaults(func=import_events)

    t = sub.add_parser("train", help="train an engine variant from its "
                                     "app's events and record it")
    t.add_argument("--variant", "-v", default="engine.json",
                   help="engine.json (datasource, preparator, algorithms)")
    t.add_argument("--batch", default="", help="batch label")
    t.add_argument("--skip-sanity-check", action="store_true")
    t.add_argument("--stop-after-read", action="store_true")
    t.add_argument("--stop-after-prepare", action="store_true")
    t.add_argument("--checkpoint-dir", default=None,
                   help="mid-training checkpoint/resume directory")
    t.add_argument("--checkpoint-interval", default=10, type=int,
                   help="iterations between snapshots")
    t.add_argument("--out", default=None,
                   help="also write the model to this .npz")
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.set_defaults(func=train)

    v = sub.add_parser("eval", help="run an evaluation sweep and record "
                                    "it")
    v.add_argument("evaluation_path",
                   help="module:name of an Evaluation (or its class or "
                        "a factory)")
    v.add_argument("params_generator_path", nargs="?", default=None,
                   help="module:name of an EngineParamsGenerator "
                        "(default: the evaluation's own params list)")
    v.add_argument("--batch", default="", help="batch label")
    v.add_argument("--grid", action="append", default=[],
                   metavar="NAME=V1,V2",
                   help="cross-product override of the algorithm params, "
                        "e.g. --grid rank=8,12 --grid reg=0.01,0.1 "
                        "(repeatable)")
    v.add_argument("--k-fold", type=int, default=None,
                   help="override the datasource's kFold eval param")
    v.add_argument("--query-num", type=int, default=None,
                   help="override the datasource's queryNum eval param")
    v.add_argument("--sequential", action="store_true",
                   help="the per-candidate loop instead of the batched "
                        "sweep")
    v.add_argument("--device", default=None, help="cuda (default) or cpu")
    v.set_defaults(func=eval_cmd)

    d = sub.add_parser("deploy", help="serve a trained instance over "
                                      "HTTP")
    d.add_argument("--variant", "-v", default=None,
                   help="engine.json (default: engine.json; with --model "
                        "optional)")
    d.add_argument("--engine-instance-id", default=None,
                   help="deploy this instance instead of the latest")
    d.add_argument("--release", default=None,
                   help="deploy this release (id, version or vN)")
    d.add_argument("--model", default=None,
                   help="serve this .npz model file instead of a stored "
                        "instance")
    d.add_argument("--ip", default="localhost")
    d.add_argument("--port", default=8000, type=int)
    d.add_argument("--accesskey", default=None,
                   help="key required by /stop, /reload and the deploy "
                        "API")
    d.add_argument("--feedback", action="store_true",
                   help="record query/prediction events")
    d.add_argument("--event-server-app", default=None,
                   help="app name for feedback events")
    d.add_argument("--log-url", default=None,
                   help="POST serving errors to this URL "
                        "(CreateServer remoteLog)")
    d.add_argument("--log-prefix", default="",
                   help="prefix prepended to remote log payloads")
    d.add_argument("--device", default=None, help="cuda (default) or cpu")
    d.set_defaults(func=deploy)

    m = sub.add_parser("multiserve", help="host several engine variants "
                       "in one process under one device-memory budget")
    m.add_argument("--tenant", "-t", dest="tenant_specs", action="append",
                   required=True, metavar="NAME=VARIANT_PATH",
                   help="co-host the latest COMPLETED instance of this "
                        "variant as tenant NAME (repeatable)")
    m.add_argument("--ip", default="localhost")
    m.add_argument("--port", default=None, type=int,
                   help="port (default 8800; 0 picks a free one)")
    m.add_argument("--accesskey", default=None,
                   help="key guarding every tenant's /stop, /reload and "
                        "deploy API")
    m.add_argument("--device", default=None, help="cuda (default) or cpu")
    m.set_defaults(func=multiserve)

    b = sub.add_parser("batchpredict", help="score a file of queries "
                                             "offline")
    b.add_argument("--variant", "-v", default="engine.json")
    b.add_argument("--input", dest="input_path", required=True,
                   help="queries: one JSON object per line")
    b.add_argument("--output", dest="output_path", required=True,
                   help="predictions: JSON-lines")
    b.add_argument("--engine-instance-id", default=None)
    b.add_argument("--release", default=None,
                   help="score with this release (id, version or vN)")
    b.add_argument("--chunk-size", type=int, default=None,
                   help="maximal scoring bucket (default: the batchpredict "
                        "section / PIO_BATCHPREDICT_CHUNK_SIZE; 1024)")
    b.add_argument("--output-format", choices=["jsonl"], default=None)
    b.add_argument("--input-format", choices=["jsonl"], default=None)
    b.add_argument("--device", default=None, help="cuda (default) or cpu")
    b.set_defaults(func=batchpredict)

    u = sub.add_parser("undeploy", help="stop a deployed query server")
    u.add_argument("--ip", default="localhost")
    u.add_argument("--port", default=8000, type=int)
    u.add_argument("--accesskey", default=None)
    u.set_defaults(func=undeploy)

    r = sub.add_parser("releases", help="list the releases of an engine "
                                        "variant")
    r.add_argument("--variant", "-v", default="engine.json")
    r.add_argument("--status", default=None,
                   help="only releases in this status")
    r.set_defaults(func=releases)

    rb = sub.add_parser("rollback", help="roll a running query server "
                                         "back to its previous release")
    rb.add_argument("--ip", default="localhost")
    rb.add_argument("--port", default=8000, type=int)
    rb.add_argument("--accesskey", default=None)
    rb.set_defaults(func=rollback)

    tr = sub.add_parser("traces", help="read a live server's flight "
                                       "recorder (/debug/traces.json)")
    tr.add_argument("--ip", default="localhost")
    tr.add_argument("--port", default=8000, type=int)
    tr.add_argument("--trace-id", dest="trace_id", default=None,
                    help="only spans of this trace id")
    tr.add_argument("--limit", type=int, default=20,
                    help="most recent N trace records (default 20)")
    tr.add_argument("--since", default=None, metavar="30m",
                    help="only records newer than this (45s, 30m, 2h)")
    tr.add_argument("--events", dest="show_events", action="store_true",
                    help="also print lifecycle events")
    tr.add_argument("--json", dest="as_json", action="store_true",
                    help="raw /debug/traces.json body")
    tr.set_defaults(func=traces)

    pf = sub.add_parser("profile", help="capture a bounded device profile "
                                        "from a live query server")
    pf.add_argument("--ip", default="localhost")
    pf.add_argument("--port", default=8000, type=int)
    pf.add_argument("--accesskey", default=None)
    pf.add_argument("--seconds", type=float, default=2.0,
                    help="capture window (capped server-side at 60s)")
    pf.add_argument("--dir", dest="outdir", default=None,
                    help="trace output directory (server-side path)")
    pf.set_defaults(func=profile)

    so = sub.add_parser("slo", help="read a live query server's SLO "
                                    "burn-rate evaluation (/slo.json)")
    so.add_argument("--ip", default="localhost")
    so.add_argument("--port", default=8000, type=int)
    so.set_defaults(func=slo)

    cp = sub.add_parser("capacity", help="read a live server's "
                                         "device-memory ledger")
    cp.add_argument("--ip", default="localhost")
    cp.add_argument("--port", default=8000, type=int)
    cp.add_argument("--json", dest="as_json", action="store_true",
                    help="raw /capacity.json body")
    cp.set_defaults(func=capacity)

    mt = sub.add_parser("metrics", help="query the durable local "
                                        "telemetry stores").add_subparsers(
        dest="metrics_cmd", required=True)
    ms = mt.add_parser("series", help="list the persisted series")
    ms.add_argument("--dir", dest="dirpath", default=None,
                    help="telemetry root (default $PIO_HOME/telemetry or "
                         "PIO_TELEMETRY_DIR)")
    ms.add_argument("--name", default=None, help="only this metric")
    ms.set_defaults(func=metrics_series)
    mq = mt.add_parser("query", help="range-query a metric's history")
    mq.add_argument("metric")
    mq.add_argument("--since", default="1h", metavar="30m",
                    help="trailing window (45s, 30m, 2h, 1d; default 1h)")
    mq.add_argument("--rate", dest="as_rate", action="store_true",
                    help="per-second rate + increase over the window")
    mq.add_argument("--quantile", type=float, default=None,
                    help="histogram quantile over the window, e.g. 0.99")
    mq.add_argument("--label", dest="label_filters", action="append",
                    default=[], metavar="KEY=VALUE",
                    help="label filter (repeatable)")
    mq.add_argument("--dir", dest="dirpath", default=None,
                    help="telemetry root (default $PIO_HOME/telemetry or "
                         "PIO_TELEMETRY_DIR)")
    mq.add_argument("--json", dest="as_json", action="store_true")
    mq.set_defaults(func=metrics_query)
    ro = sub.add_parser("router", help="serve a replicated fleet of query "
                        "servers behind one router")
    ro.add_argument("--variant", "-v", default="engine.json")
    ro.add_argument("--ip", default="localhost")
    ro.add_argument("--port", default=None, type=int,
                    help="router port (default PIO_ROUTER_PORT / "
                         "server.json)")
    ro.add_argument("--replicas", default=None, type=int,
                    help="query-server replicas to spawn (default "
                         "PIO_ROUTER_REPLICAS / server.json)")
    ro.add_argument("--replica-url", dest="replica_urls", action="append",
                    default=[], help="front an existing replica instead of "
                    "spawning (repeatable); disables the spawner")
    ro.add_argument("--accesskey", default=None,
                    help="key forwarded to spawned replicas' deploy APIs")
    ro.add_argument("--device", default=None,
                    help="device of each spawned replica: cuda (default) "
                         "or cpu")
    ro.set_defaults(func=router)

    oc = sub.add_parser("orchestrate", help="continuous training: trigger "
                        "-> train -> eval -> smoke -> canary -> promote")
    oc.add_argument("--variant", "-v", default="engine.json")
    oc.add_argument("--once", action="store_true",
                    help="one trigger evaluation (and one cycle if it "
                         "fires), then exit")
    oc.add_argument("--force", action="store_true",
                    help="fire one manual cycle immediately (skips the "
                         "data-driven triggers and the cooldown window)")
    oc.add_argument("--cycles", type=int, default=None,
                    help="exit after this many completed cycles (default: "
                         "run forever)")
    oc.add_argument("--server", default=None, metavar="HOST:PORT",
                    help="drive a live query server's deploy API for the "
                         "canary phase (default: registry-only plane)")
    oc.add_argument("--accesskey", default=None)
    oc.add_argument("--state-dir", default=None,
                    help="crash-safe cycle-document directory (default "
                         "$PIO_HOME/orchestrator or PIO_ORCH_STATE_DIR)")
    oc.add_argument("--eval-class", default=None,
                    help="Evaluation path for the eval-gate phase (skipped "
                         "when absent)")
    oc.add_argument("--device", default=None, help="cuda (default) or cpu")
    oc.set_defaults(func=orchestrate)

    st = sub.add_parser("status", help="verify the storage configuration")
    st.add_argument("--fleet", dest="fleet_path", default=None,
                    help="show the merged fleet view of a sharded run (the "
                         "<output>.fleet.json a batchpredict merge commits, "
                         "or the output path), or a telemetry root")
    st.set_defaults(func=status)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
