"""Command line of the port (``argparse``; the reference's ``pio`` uses
click).

    python -m predictionio_tpu_torch.cli.main deploy --model M.npz \\
        [--variant engine.json] [--ip localhost] [--port 8000] \\
        [--device cpu]

``deploy`` loads an ALS model file (``workflow/serialization``), reads
the engine.json's algorithms and top-level ``scorer`` section as
``pio deploy`` does (env > engine.json > server.json for the scorer
knobs), warms the serving path up, then serves ``/queries.json``. The
model runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: the engines this slice of the port serves, by factory name
_ENGINES = ("recommendation",)


def _engine_of(variant: dict):
    from predictionio_tpu_torch.engines import recommendation

    factory = variant.get("engineFactory") or ""
    name = factory.replace(":", ".").split(".")[-2:-1]
    if factory and name != ["recommendation"]:
        raise SystemExit(f"[ERROR] engineFactory {factory!r}: only the "
                         f"{'/'.join(_ENGINES)} engine is ported")
    return recommendation.engine()


def deploy(args) -> int:
    from predictionio_tpu_torch.deploy.warm import EngineInstance
    from predictionio_tpu_torch.server.query_server import (
        create_query_server, run_query_server,
    )
    from predictionio_tpu_torch.utils.server_config import scorer_config
    from predictionio_tpu_torch.workflow.serialization import load_model

    variant = {}
    if args.variant:
        with open(args.variant) as f:
            variant = json.load(f)
    engine = _engine_of(variant)
    engine_params = engine.engine_params_from_json(
        variant if variant.get("algorithms") else
        {"algorithms": [{"name": "als", "params": {}}]})
    scfg = scorer_config(variant.get("scorer"))
    t0 = time.perf_counter()
    model = load_model(args.model, device=args.device)
    result = engine.prepare_deploy(engine_params, [model])
    instance = EngineInstance(
        id=os.path.basename(args.model),
        engine_variant=variant.get("id", "default"))
    print(f"[INFO] Loaded {args.model}: {len(model.user_vocab)} users x "
          f"{len(model.item_vocab)} items, rank {model.V.shape[1]}, on "
          f"{model.device} ({time.perf_counter() - t0:.3f} s)", flush=True)
    server = create_query_server(engine, result, instance,
                                 scorer_config=scfg)
    report = server.warm()
    print(f"[INFO] Warm-up: batches {report.buckets} in "
          f"{report.seconds:.3f} s; scorer mode {scfg.mode}", flush=True)

    def ready(port):
        print(f"[INFO] Query server listening on http://{args.ip}:{port}",
              flush=True)

    run_query_server(server, args.ip, args.port, on_ready=ready)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m predictionio_tpu_torch.cli.main")
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("deploy", help="serve an ALS model file over HTTP")
    d.add_argument("--model", required=True, help="model .npz file")
    d.add_argument("--variant", "-v", default=None,
                   help="engine.json (algorithms and scorer sections)")
    d.add_argument("--ip", default="localhost")
    d.add_argument("--port", default=8000, type=int)
    d.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    d.set_defaults(func=deploy)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
