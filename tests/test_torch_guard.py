"""The port stands alone: predictionio_tpu_torch (and chip_smoke.py) never
import jax or the JAX package, and its entry points never fall back to
the CPU on their own.

* a subprocess imports every module of the port and serves one query
  over HTTP on the CPU, then finds neither ``jax`` nor any
  ``predictionio_tpu`` module in ``sys.modules``; another writes events
  into a tiny sqlite store and trains from it through the train CLI on
  the CPU, a third creates an app through the CLI and ingests an event
  through the event server, a fourth serves with online fold-in on
  (``PIO_FOLDIN=1``) and applies once, and a fifth runs ``deploy
  --feedback --log-url`` through the CLI, answers a query and a failing
  one, then stops it with ``undeploy``, and two more train and deploy
  the e-commerce and similar-product engines through the CLI, and
  another runs ``eval`` through the CLI, batched then ``--sequential``,
  and another ``batchpredict`` through the CLI, whole and in two
  shards, each with the same finding;
* an AST scan finds no such import in the package (the staged-rollout
  modules ``obs/slo.py``, ``deploy/canary.py`` and ``server/plugins.py``,
  and the batch-predict slice's obs core, worker contract and kill
  points among them) or in chip_smoke.py;
* each entry point called without ``device=`` raises when CUDA is
  absent.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "predictionio_tpu_torch"

_CHILD = r"""
import asyncio, http.client, json, pkgutil, importlib, sys
import numpy as np
import predictionio_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.engines.recommendation import engine, default_engine_params
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.utils.server_config import ScorerConfig

rng = np.random.default_rng(0)
model = ALSModel.from_arrays(np.array(["u0", "u1"]), np.array(["a", "b", "c"]),
                             rng.standard_normal((2, 4)), rng.standard_normal((3, 4)),
                             device="cpu")
eng = engine()
result = eng.prepare_deploy(default_engine_params(), [model])
server = create_query_server(eng, result, EngineInstance(id="guard"),
                             scorer_config=ScorerConfig(mode="twostage", tile_items=128))

def query(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", "/queries.json", body=json.dumps({"user": "u1", "num": 2}))
    r = c.getresponse()
    return r.status, json.loads(r.read())

async def main():
    port = await server.start("127.0.0.1", 0)
    try:
        return await asyncio.get_running_loop().run_in_executor(None, query, port)
    finally:
        await server.close()

status, body = asyncio.run(main())
assert status == 200 and len(body["itemScores"]) == 2, (status, body)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_serving_one_query_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_TRAIN_CHILD = r"""
import json, os, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

tmp = sys.argv[1]
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "pio.db"),
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"})
app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
store = Storage.get_events()
store.init_channel(app_id)
store.insert_batch([
    Event(event="rate", entity_type="user", entity_id=f"u{u}",
          target_entity_type="item", target_entity_id=f"i{(u * 7 + j) % 9}",
          properties={"rating": float(1 + (u + j) % 5)})
    for u in range(12) for j in range(4)], app_id)
variant = os.path.join(tmp, "engine.json")
with open(variant, "w") as f:
    json.dump({"datasource": {"params": {"appName": "Guard"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 3, "numIterations": 2}}]}, f)
assert main(["train", "--variant", variant, "--out",
             os.path.join(tmp, "m.npz"), "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_training_from_a_store_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _TRAIN_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["nnz"] == 48
    assert lines[-1] == "[]", out.stdout


_EVENT_CHILD = r"""
import asyncio, http.client, json, os, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.storage.registry import Storage

tmp = sys.argv[1]
Storage.configure({"sources": {"DB": {"TYPE": "sqlite",
                                      "PATH": os.path.join(tmp, "es.db")}},
                   "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                                    for r in ("METADATA", "EVENTDATA",
                                              "MODELDATA")}})
assert main(["app", "new", "Guard", "--access-key", "k"]) == 0

def post(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", "/batch/events.json?accessKey=k", body=json.dumps([
        {"event": "rate", "entityType": "user", "entityId": "u",
         "targetEntityType": "item", "targetEntityId": "i",
         "properties": {"rating": 3}}]))
    r = c.getresponse()
    return r.status, json.loads(r.read())

async def run():
    server = EventServer()
    port = await server.start("127.0.0.1", 0)
    try:
        return await asyncio.get_running_loop().run_in_executor(None, post,
                                                                port)
    finally:
        await server.close()

status, body = asyncio.run(run())
assert status == 200 and body[0]["status"] == 201, (status, body)
assert len(list(Storage.get_events().find(1))) == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_event_server_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _EVENT_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_FOLDIN_CHILD = r"""
import asyncio, http.client, json, os, sys
import numpy as np
os.environ.update({"PIO_FOLDIN": "1", "PIO_FOLDIN_APPLY_INTERVAL_S": "3600"})
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.engines.recommendation import engine, default_engine_params
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import foldin_config

tmp = sys.argv[1]
Storage.configure({"sources": {"DB": {"TYPE": "sqlite",
                                      "PATH": os.path.join(tmp, "f.db")}},
                   "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                                    for r in ("METADATA", "EVENTDATA",
                                              "MODELDATA")}})
app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
Storage.get_events().init_channel(app_id)
rng = np.random.default_rng(0)
model = ALSModel.from_arrays(np.array(["u0", "u1"]), np.array(["a", "b", "c"]),
                             rng.standard_normal((2, 4)), rng.standard_normal((3, 4)),
                             device="cpu")
eng = engine()
result = eng.prepare_deploy(default_engine_params("Guard", rank=4), [model])
server = create_query_server(eng, result, EngineInstance(id="guard"),
                             foldin_config=foldin_config())

def query(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", "/queries.json", body=json.dumps({"user": "new", "num": 2}))
    r = c.getresponse()
    return r.status, json.loads(r.read())

async def main():
    port = await server.start("127.0.0.1", 0)
    loop = asyncio.get_running_loop()
    try:
        Storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id="new",
                  target_entity_type="item", target_entity_id=i,
                  properties={"rating": 4.0}) for i in ("a", "c")], app_id)
        stats = await loop.run_in_executor(server._deploy_executor,
                                           server._foldin.apply_pending)
        assert stats["users"] == 1, stats
        return await loop.run_in_executor(None, query, port)
    finally:
        await server.close()

status, body = asyncio.run(main())
assert status == 200 and len(body["itemScores"]) == 2, (status, body)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_foldin_deploy_and_apply_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _FOLDIN_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_DEPLOY_CHILD = r"""
import http.client, http.server, json, os, socket, sys, threading, time
import numpy as np
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.workflow.serialization import save_model

tmp = sys.argv[1]
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "d.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
Storage.get_events().init_channel(app_id)
rng = np.random.default_rng(0)
path = os.path.join(tmp, "m.npz")
save_model(path, ALSModel.from_arrays(
    np.array(["u0", "u1"]), np.array(["a", "b", "c"]),
    rng.standard_normal((2, 4)), rng.standard_normal((3, 4)), device="cpu"))
logged = []

class Sink(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        logged.append(self.rfile.read(int(self.headers["Content-Length"])))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass

sink = http.server.HTTPServer(("127.0.0.1", 0), Sink)
threading.Thread(target=sink.serve_forever, daemon=True).start()
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rc = []
deploy = threading.Thread(target=lambda: rc.append(main([
    "deploy", "--model", path, "--port", str(port), "--device", "cpu",
    "--feedback", "--event-server-app", "Guard", "--log-url",
    f"http://127.0.0.1:{sink.server_address[1]}/", "--log-prefix", "g:"])))
deploy.start()

def post(body):
    for _ in range(600):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/queries.json", body=json.dumps(body))
            r = c.getresponse()
            return r.status, json.loads(r.read())
        except ConnectionRefusedError:
            time.sleep(0.05)

status, body = post({"user": "u1", "num": 2})
assert status == 200 and body["prId"], (status, body)
assert post({"num": 2})[0] == 400
assert main(["undeploy", "--port", str(port)]) == 0
deploy.join(timeout=30)
assert rc == [0], rc
for _ in range(100):
    if logged:
        break
    time.sleep(0.05)
assert logged and logged[0].startswith(b"g:"), logged
events = list(Storage.get_events().find(app_id, entity_type="pio_pr"))
assert [e.entity_id for e in events] == [body["prId"]], events
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_deploy_feedback_log_and_undeploy_load_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DEPLOY_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_ENGINE_CHILD = r"""
import http.client, json, os, socket, sys, threading, time
engine_name, tmp = sys.argv[1], sys.argv[2]
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "e.db"),
    "PIO_ENTITY_CACHE_TTL_S": "0", "PIO_SCORER_MODE": "twostage",
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
store = Storage.get_events()
store.init_channel(app_id)
evs = [Event(event="$set", entity_type="item", entity_id=f"i{i}",
             properties={"categories": [f"c{i % 2}"]}) for i in range(9)]
evs += [Event(event="view" if (u + j) % 4 else "buy", entity_type="user",
              entity_id=f"u{u}", target_entity_type="item",
              target_entity_id=f"i{(u * 5 + j) % 9}")
        for u in range(12) for j in range(4)]
store.insert_batch(evs, app_id)
algos = ([{"name": "ecomm", "params": {"appName": "Guard", "rank": 3,
                                       "numIterations": 2}}]
         if engine_name == "ecommerce" else
         [{"name": "als", "params": {"rank": 3, "numIterations": 2}},
          {"name": "cooccurrence", "params": {"n": 3}}])
variant = os.path.join(tmp, "engine.json")
with open(variant, "w") as f:
    json.dump({"engineFactory": f"predictionio_tpu.engines.{engine_name}:engine",
               "datasource": {"params": {"appName": "Guard"}},
               "algorithms": algos}, f)
assert main(["train", "--variant", variant, "--device", "cpu"]) == 0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rc = []
deploy = threading.Thread(target=lambda: rc.append(main([
    "deploy", "--variant", variant, "--port", str(port), "--device", "cpu"])))
deploy.start()

def post(body):
    for _ in range(600):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/queries.json", body=json.dumps(body))
            r = c.getresponse()
            return r.status, json.loads(r.read())
        except ConnectionRefusedError:
            time.sleep(0.05)

query = ({"user": "u1", "num": 3} if engine_name == "ecommerce"
         else {"items": ["i1"], "num": 3})
status, body = post(query)
assert status == 200 and len(body["itemScores"]) == 3, (status, body)
assert main(["undeploy", "--port", str(port)]) == 0
deploy.join(timeout=30)
assert rc == [0], rc
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


@pytest.mark.parametrize("engine_name", ["ecommerce", "similarproduct"])
def test_engine_train_and_deploy_load_no_jax(tmp_path, engine_name):
    """``train`` and ``deploy`` of e-commerce and similar-product through
    the CLI, the engine.json naming the reference's factory string."""
    out = subprocess.run(
        [sys.executable, "-c", _ENGINE_CHILD, engine_name, str(tmp_path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.recommendation import (
    AlgorithmParams, DataSourceParams, PrecisionAtK, RMSEMetric, engine)
evaluation = Evaluation(engine=engine(), metric=PrecisionAtK(k=3),
                        other_metrics=[RMSEMetric()], output_path=BEST)
evaluation.engine_params_list = [EngineParams(
    data_source_params=DataSourceParams(app_name="Guard",
                                        eval_params={"kFold": 2}),
    algorithm_params_list=[("als", AlgorithmParams(num_iterations=2))])]
"""

_EVAL_CHILD = r"""
import json, os, sys
tmp, module = sys.argv[1], sys.argv[2]
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "ev.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
with open(os.path.join(tmp, "guard_eval.py"), "w") as f:
    f.write(f"BEST = {os.path.join(tmp, 'best.json')!r}\n" + module)
sys.path.insert(0, tmp)
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
store = Storage.get_events()
store.init_channel(app_id)
store.insert_batch([
    Event(event="rate", entity_type="user", entity_id=f"u{u}",
          target_entity_type="item", target_entity_id=f"i{(u * 7 + j) % 9}",
          properties={"rating": float(1 + (u + j) % 5)})
    for u in range(12) for j in range(4)], app_id)
for extra in ([], ["--sequential"]):
    assert main(["eval", "guard_eval:evaluation", "--grid", "rank=2,3",
                 "--device", "cpu", *extra]) == 0
assert len(Storage.get_meta_data_evaluation_instances().get_completed()) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_eval_cli_loads_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _EVAL_CHILD, str(tmp_path), _EVAL_MODULE],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["mode"] == "sequential"
    assert lines[-1] == "[]", out.stdout


_BATCHPREDICT_CHILD = r"""
import json, os, sys
tmp = sys.argv[1]
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "bp.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
store = Storage.get_events()
store.init_channel(app_id)
store.insert_batch([
    Event(event="rate", entity_type="user", entity_id=f"u{u}",
          target_entity_type="item", target_entity_id=f"i{(u * 7 + j) % 9}",
          properties={"rating": float(1 + (u + j) % 5)})
    for u in range(12) for j in range(4)], app_id)
variant = os.path.join(tmp, "engine.json")
with open(variant, "w") as f:
    json.dump({"datasource": {"params": {"appName": "Guard"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 3, "numIterations": 2}}]}, f)
assert main(["train", "--variant", variant, "--device", "cpu"]) == 0
inp, out = os.path.join(tmp, "q.jsonl"), os.path.join(tmp, "p.jsonl")
with open(inp, "w") as f:
    f.write("".join(json.dumps({"user": f"u{u}", "num": 3}) + "\n"
                    for u in range(14)) + "not json\n")
args = ["batchpredict", "--variant", variant, "--input", inp, "--output",
        out, "--device", "cpu", "--chunk-size", "4"]
assert main(args) == 0
single = open(out).read()
for rank in (0, 1):
    os.environ.update(PIO_PROCESS_ID=str(rank), PIO_NUM_PROCESSES="2")
    assert main(args) == 0
assert open(out).read() == single and len(single.splitlines()) == 14
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_batchpredict_cli_loads_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _BATCHPREDICT_CHILD, str(tmp_path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["merged"] is True
    assert lines[-1] == "[]", out.stdout


def test_scan_covers_the_batch_predict_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"workflow/batch_predict.py", "obs/registry.py",
            "obs/trace_context.py", "obs/tracing.py", "obs/batch_stats.py",
            "obs/fleet.py", "parallel/distributed.py",
            "storage/faults.py"} <= scanned


def test_scan_covers_the_evaluation_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"core/evaluation.py", "core/metrics.py",
            "core/cross_validation.py", "models/als_sweep.py",
            "workflow/evaluate.py"} <= scanned


def test_scan_covers_the_staged_rollout_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"obs/slo.py", "deploy/canary.py", "server/plugins.py",
            "server/query_server.py", "cli/main.py"} <= scanned


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "predictionio_tpu"
            or name.startswith("predictionio_tpu."))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib.import_module("jax...") and the like
            if _forbidden(node.value):
                found.append(node.value)
    assert not found, f"{path}: {found}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule is moot")


def _als_model(**kw):
    from predictionio_tpu_torch.models.als import ALSModel

    return ALSModel.from_arrays(np.array(["u"]), np.array(["i"]),
                                np.ones((1, 2)), np.ones((1, 2)), **kw)


def _load_model(tmp_path, **kw):
    from predictionio_tpu_torch.workflow.serialization import (
        load_model, save_model,
    )

    path = tmp_path / "m.npz"
    save_model(path, _als_model(device="cpu"))
    return load_model(path, **kw)


def _build_scorer(**kw):
    from predictionio_tpu_torch.ops.scoring import build_scorer
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    v = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    return build_scorer(v, ScorerConfig(mode="twostage"), **kw)


def _train_als():
    from predictionio_tpu_torch.models.als import ALSData, ALSParams, train_als

    data = ALSData.build(np.array([0, 1]), np.array([1, 0]),
                         np.array([3.0, 4.0], np.float32), 2, 2)
    return train_als(data, ALSParams(rank=2, num_iterations=1))


def _cli_train(tmp_path):
    from predictionio_tpu_torch.cli.main import main

    variant = tmp_path / "engine.json"
    variant.write_text('{"datasource": {"params": {"appName": "x"}}, '
                       '"algorithms": [{"name": "als"}]}')
    return main(["train", "--variant", str(variant), "--out",
                 str(tmp_path / "m.npz")])


def _run_train(tmp_path):
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.workflow.train import run_train

    return run_train(engine(), default_engine_params("x"))


def _load_for_deploy(tmp_path):
    from predictionio_tpu_torch.engines.recommendation import engine
    from predictionio_tpu_torch.storage.base import EngineInstance
    from predictionio_tpu_torch.workflow.train import load_for_deploy

    return load_for_deploy(engine(), EngineInstance(id="x"))


def _foldin_solver():
    from predictionio_tpu_torch.models.als import ALSParams, FoldInSolver

    return FoldInSolver(np.ones((3, 2), np.float32), ALSParams(rank=2))


def _cli_deploy(tmp_path):
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.workflow.serialization import save_model

    path = tmp_path / "m.npz"
    save_model(path, _als_model(device="cpu"))
    return main(["deploy", "--model", str(path), "--port", "0"])


def _train_cooccurrence():
    from predictionio_tpu_torch.models.cooccurrence import (
        train_cooccurrence,
    )

    return train_cooccurrence(np.array([0, 1, 1]), np.array([0, 0, 1]),
                              2, 2, 3)


def _run_sweep():
    from predictionio_tpu_torch.core.cross_validation import (
        fold_assignments,
    )
    from predictionio_tpu_torch.models.als import ALSParams
    from predictionio_tpu_torch.models.als_sweep import (
        build_sweep_data, run_sweep,
    )

    data = build_sweep_data(np.array([0, 1, 1, 0]), np.array([1, 0, 1, 0]),
                            np.array([3.0, 4.0, 2.0, 5.0], np.float32),
                            fold_assignments(2, 4), 2, 2)
    return run_sweep(data, [ALSParams(rank=2, num_iterations=1)])


def _run_evaluation():
    from predictionio_tpu_torch.core.evaluation import Evaluation
    from predictionio_tpu_torch.engines.recommendation import (
        PrecisionAtK, default_engine_params, engine,
    )
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    return run_evaluation(Evaluation(engine(), PrecisionAtK()),
                          [default_engine_params("x")])


def _cli_eval():
    from predictionio_tpu_torch.cli.main import main

    return main(["eval", "predictionio_tpu_torch.core.evaluation:Evaluation",
                 "predictionio_tpu_torch.core.evaluation:"
                 "EngineParamsGenerator"])


def _run_batch_predict(tmp_path):
    from predictionio_tpu_torch.engines.recommendation import engine
    from predictionio_tpu_torch.storage.base import EngineInstance
    from predictionio_tpu_torch.workflow.batch_predict import (
        run_batch_predict,
    )

    return run_batch_predict(engine(), EngineInstance(id="x"),
                             str(tmp_path / "q.jsonl"),
                             str(tmp_path / "p.jsonl"))


def _cli_batchpredict(tmp_path):
    from predictionio_tpu_torch.cli.main import main

    return main(["batchpredict", "--input", str(tmp_path / "q.jsonl"),
                 "--output", str(tmp_path / "p.jsonl")])


def _similarity_model():
    from predictionio_tpu_torch.engines.similarproduct import (
        SimilarityModel,
    )

    return SimilarityModel(item_vocab=np.array(["i"]),
                           V=np.ones((1, 2), np.float32), items={})


@pytest.mark.parametrize("entry", ["ALSModel.from_arrays", "load_model",
                                   "build_scorer", "cli deploy",
                                   "train_als", "cli train", "run_train",
                                   "load_for_deploy", "FoldInSolver",
                                   "train_cooccurrence", "SimilarityModel",
                                   "run_sweep", "run_evaluation",
                                   "cli eval", "run_batch_predict",
                                   "cli batchpredict"])
def test_entry_point_without_device_raises_without_card(no_card, tmp_path,
                                                        entry):
    call = {"ALSModel.from_arrays": lambda: _als_model(),
            "load_model": lambda: _load_model(tmp_path),
            "build_scorer": lambda: _build_scorer(),
            "cli deploy": lambda: _cli_deploy(tmp_path),
            "train_als": _train_als,
            "cli train": lambda: _cli_train(tmp_path),
            "run_train": lambda: _run_train(tmp_path),
            "load_for_deploy": lambda: _load_for_deploy(tmp_path),
            "FoldInSolver": _foldin_solver,
            "train_cooccurrence": _train_cooccurrence,
            "SimilarityModel": _similarity_model,
            "run_sweep": _run_sweep,
            "run_evaluation": _run_evaluation,
            "cli eval": _cli_eval,
            "run_batch_predict": lambda: _run_batch_predict(tmp_path),
            "cli batchpredict": lambda: _cli_batchpredict(tmp_path)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_explicit_cpu_is_honoured(tmp_path):
    assert _als_model(device="cpu").device == torch.device("cpu")
    assert _load_model(tmp_path, device="cpu").device == torch.device("cpu")
    assert _build_scorer(device="cpu").device == torch.device("cpu")
