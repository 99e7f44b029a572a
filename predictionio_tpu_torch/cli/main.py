"""Command line of the port (``argparse``; the reference's ``pio`` uses
click), with the reference's commands, flags and exit codes:

    python -m predictionio_tpu_torch.cli.main app new NAME [--id N]
        [--description D] [--access-key K]
    python -m predictionio_tpu_torch.cli.main app list
    python -m predictionio_tpu_torch.cli.main accesskey new APP
        [--key K] [--event NAME ...]
    python -m predictionio_tpu_torch.cli.main accesskey list [APP]
    python -m predictionio_tpu_torch.cli.main eventserver [--ip] [--port 7070]
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

The engine.json's ``engineFactory`` names one of the ported engines
(recommendation, ecommerce, similarproduct, recommended_user) by the
reference's factory string or the port's own.

``train`` runs ``workflow.train.run_train``: an EngineInstance (INIT,
then COMPLETED), the model blob in the model store under its id, and the
variant's next release; it prints one JSON line — users, items, nnz and
rank of the first algorithm's model (null where its kind has none) and
each model's, the seconds of the whole train (event read and records
included) and of the host-side data build, the kernel launch counts,
the instance id and the release version. ``--out`` also writes the
first model as an ``.npz`` file.

``eval`` runs ``workflow.evaluate.run_evaluation``: the evaluation
(``module:name`` or ``module.name``, an Evaluation, its class or a
factory) over its own params list or the generator's, crossed with the
``--grid`` values; an EvaluationInstance (INIT, then EVALCOMPLETED or
EVALFAILED) and the best variant's ``best.json``. It prints the
reference's lines, then one JSON line: the sweep's mode, groups, units
per launch and seconds, the best candidate and its score, the kernel
launch counts and the wall seconds. ``--sequential`` forces the
per-candidate loop (``PIO_EVAL_VECTORIZE=0``).

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
            "recommended_user")


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
    where the kind has no such side)."""
    inner = getattr(model, "model", model)      # cooccurrence wraps one
    users = getattr(inner, "user_vocab", None)
    items = getattr(inner, "item_vocab", None)
    V = getattr(model, "V", None)
    info = getattr(model, "train_info", None) or {}
    return {"kind": type(model).__name__,
            "users": None if users is None else len(users),
            "items": None if items is None else len(items),
            "rank": None if V is None else int(V.shape[1]),
            "nnz": info.get("nnz"), "build_s": info.get("build_s")}


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

    run_event_server(args.ip, args.port, on_ready=ready)
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
        "device": str(ctx.device), "train_s": train_s,
        "build_s": summary["build_s"],
        "models": [_model_summary(m) for m in result.models],
        "launches": kernels.counts(), "out": args.out,
        "instance": instance.id,
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
        "eval_s": eval_s}), flush=True)
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
    from predictionio_tpu_torch.utils.server_config import (
        deploy_config, foldin_config, scorer_config,
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
    print(f"[INFO] Loaded {instance.id}: {summary['kind']}, "
          f"{summary['users']} users x {summary['items']} items, rank "
          f"{summary['rank']}, on {getattr(model, 'device', None)} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    server = create_query_server(engine, result, instance,
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

    e = sub.add_parser("eventserver", help="serve the event REST API")
    e.add_argument("--ip", default="localhost")
    e.add_argument("--port", default=7070, type=int)
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
