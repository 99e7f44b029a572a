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
  shards, and another ``eventserver --stats``, a deploy with telemetry
  and an SLO spec, ``slo``, ``capacity``, ``traces`` and ``metrics
  series|query``, and another ``multiserve`` over two tenants, and
  another trains the three classification algorithms, deploys one and
  runs ``eval`` through the CLI, and another trains and deploys the
  sessionrec engine through the CLI, and another runs ``reshard`` and
  ``compact`` on a partitioned store and a storm through ``loadtest``,
  and another ``version``, the app, channel and access-key management
  commands, ``export``, ``analyze``, ``run``, ``adminserver`` and
  ``dashboard``, and another ``app new``, ``import`` and ``train``
  on an evlog event store (the native codec where g++ is present),
  and another ``check`` over the port's tree (without torch) and the
  entry module's forward step and dry run, and two processes in a gloo
  group run the collectives child (``tests/torch_distributed_child.py``)
  and ``train --mesh-shape 2`` through the CLI, each with the same
  finding;
* an AST scan finds no such import in the package (the staged-rollout
  modules ``obs/slo.py``, ``deploy/canary.py`` and ``server/plugins.py``,
  the batch-predict slice's obs core, worker contract and kill points,
  the observability plane, the classification slice, the sessionrec
  slice, the other event stores and the small library modules among
  them) or in chip_smoke.py;
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


_CLASSIFY_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.classification import (
    Accuracy, DataSourceParams, default_engine_params, engine)
evaluation = Evaluation(engine=engine(), metric=Accuracy(), output_path=None)
evaluation.engine_params_list = [EngineParams(
    data_source_params=DataSourceParams(app_name="Guard", eval_k=3),
    algorithm_params_list=default_engine_params(
        "Guard", a).algorithm_params_list)
    for a in ("naive", "logreg", "randomforest")]
"""

_CLASSIFY_CHILD = r"""
import http.client, json, os, socket, sys, threading, time
tmp, module = sys.argv[1], sys.argv[2]
os.environ.update({
    "PIO_HOME": tmp,
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "c.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
with open(os.path.join(tmp, "guard_cls_eval.py"), "w") as f:
    f.write(module)
sys.path.insert(0, tmp)
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
store = Storage.get_events()
store.init_channel(app_id)
store.insert_batch([
    Event(event="$set", entity_type="user", entity_id=f"u{u}",
          properties={"plan": float(u % 5 > u % 3), "attr0": float(u % 5),
                      "attr1": float(u % 3), "attr2": float(u % 2)})
    for u in range(30)], app_id)
variants = []
for algo in ("naive", "logreg", "randomforest"):
    variants.append(os.path.join(tmp, f"{algo}.json"))
    with open(variants[-1], "w") as f:
        json.dump({"id": algo, "engineFactory":
                   "predictionio_tpu.engines.classification:engine",
                   "datasource": {"params": {"appName": "Guard"}},
                   "algorithms": [{"name": algo, "params": {}}]}, f)
    assert main(["train", "--variant", variants[-1], "--device", "cpu"]) == 0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rc = []
deploy = threading.Thread(target=lambda: rc.append(main([
    "deploy", "--variant", variants[2], "--port", str(port), "--device",
    "cpu"])))
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

status, body = post({"attr0": 4.0, "attr1": 0.0, "attr2": 1.0})
assert status == 200 and set(body) == {"label"}, (status, body)
assert main(["undeploy", "--port", str(port)]) == 0
deploy.join(timeout=30)
assert rc == [0], rc
assert main(["eval", "guard_cls_eval:evaluation", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_classification_train_deploy_eval_load_no_jax(tmp_path):
    """``train`` of the three classification algorithms, ``deploy`` of
    the forest and ``eval`` (Accuracy, k = 3) through the CLI, the
    engine.json naming the reference's factory string."""
    out = subprocess.run(
        [sys.executable, "-c", _CLASSIFY_CHILD, str(tmp_path),
         _CLASSIFY_EVAL_MODULE],
        cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["candidates"] == 3
    assert lines[-1] == "[]", out.stdout


_SESSIONREC_CHILD = r"""
import datetime, http.client, json, os, socket, sys, threading, time
tmp = sys.argv[1]
os.environ.update({
    "PIO_HOME": tmp,
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "s.db"),
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
t0 = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
store.insert_batch([
    Event(event="view", entity_type="user", entity_id=f"u{u}",
          target_entity_type="item", target_entity_id=f"i{(u + j) % 9}",
          event_time=t0 + datetime.timedelta(minutes=u * 10 + j))
    for u in range(20) for j in range(5)], app_id)
assert main(["template", "get", "sessionrec", os.path.join(tmp, "tpl")]) == 0
with open(os.path.join(tmp, "tpl", "engine.json")) as f:
    variant = json.load(f)
variant.update(engineFactory="predictionio_tpu.engines.sessionrec:engine",
               datasource={"params": {"appName": "Guard"}})
variant["algorithms"][0]["params"].update(d_model=16, n_layers=1, epochs=2)
path = os.path.join(tmp, "engine.json")
with open(path, "w") as f:
    json.dump(variant, f)
assert main(["train", "--variant", path, "--device", "cpu"]) == 0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
rc = []
deploy = threading.Thread(target=lambda: rc.append(main([
    "deploy", "--variant", path, "--port", str(port), "--device", "cpu"])))
deploy.start()
for _ in range(600):
    try:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("POST", "/queries.json",
                  body=json.dumps({"items": ["i1", "i2"], "num": 3}))
        r = c.getresponse()
        status, body = r.status, json.loads(r.read())
        break
    except ConnectionRefusedError:
        time.sleep(0.05)
assert status == 200 and len(body["itemScores"]) == 3, (status, body)
assert main(["undeploy", "--port", str(port)]) == 0
deploy.join(timeout=30)
assert rc == [0], rc
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_sessionrec_train_and_deploy_load_no_jax(tmp_path):
    """``template get sessionrec``, ``train`` and ``deploy`` of the
    sessionrec engine through the CLI, the engine.json naming the
    reference's factory string."""
    out = subprocess.run(
        [sys.executable, "-c", _SESSIONREC_CHILD, str(tmp_path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


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


_OBS_CHILD = r"""
import http.client, json, os, socket, sys, threading, time
import numpy as np
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.workflow.serialization import save_model

tmp = sys.argv[1]
os.environ.update({
    "PIO_HOME": tmp, "PIO_TELEMETRY_INTERVAL_S": "0.2",
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "o.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
os.makedirs(os.path.join(tmp, "conf"))
with open(os.path.join(tmp, "conf", "server.json"), "w") as f:
    json.dump({"slo": {"objectives": [{"name": "p99", "kind": "latency",
                                       "thresholdS": 5.0}],
                       "evalIntervalS": 0.1}}, f)

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

def call(port, method, path, body=None):
    for _ in range(600):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request(method, path, body=None if body is None
                      else json.dumps(body))
            r = c.getresponse()
            return r.status, r.read()
        except ConnectionRefusedError:
            time.sleep(0.05)

assert main(["app", "new", "Guard", "--access-key", "k"]) == 0
es = free_port()
threading.Thread(target=main, args=(["eventserver", "--port", str(es),
                                     "--stats"],), daemon=True).start()
events = [{"event": "rate" if i % 3 else "buy", "entityType": "user",
           "entityId": f"u{i % 4}", "targetEntityType": "item",
           "targetEntityId": f"i{i}"} for i in range(9)]
status, _ = call(es, "POST", "/batch/events.json?accessKey=k", events)
assert status == 200
status, body = call(es, "GET", "/stats.json?accessKey=k")
stats = json.loads(body)
assert sum(e["count"] for e in stats["longLive"]) == 9, stats
status, body = call(es, "GET", "/metrics")
assert b'handler="/batch/events.json",status="200"} 1' in body, body

rng = np.random.default_rng(0)
path = os.path.join(tmp, "m.npz")
save_model(path, ALSModel.from_arrays(
    np.array(["u0", "u1"]), np.array(["a", "b", "c"]),
    rng.standard_normal((2, 4)), rng.standard_normal((3, 4)), device="cpu"))
qs = free_port()
rc = []
deploy = threading.Thread(target=lambda: rc.append(main([
    "deploy", "--model", path, "--port", str(qs), "--device", "cpu"])))
deploy.start()
for _ in range(5):
    assert call(qs, "POST", "/queries.json", {"user": "u1", "num": 2})[0] \
        == 200
time.sleep(0.5)
print("CLI-OUTPUT-BEGIN", flush=True)
assert main(["slo", "--port", str(qs)]) == 0
assert main(["capacity", "--json", "--port", str(qs)]) == 0
assert main(["traces", "--port", str(qs), "--limit", "3"]) == 0
assert main(["profile", "--port", str(qs), "--seconds", "0.2", "--dir",
             os.path.join(tmp, "profile")]) == 0
assert main(["undeploy", "--port", str(qs)]) == 0
deploy.join(timeout=30)
assert rc == [0], rc
tel = os.path.join(tmp, "telemetry")
assert main(["metrics", "series", "--dir", tel,
             "--name", "pio_query_duration_seconds"]) == 0
assert main(["metrics", "query", "pio_query_duration_seconds", "--dir",
             tel, "--json"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad), flush=True)
os._exit(0)
"""


def test_obs_cli_eventserver_stats_and_telemetry_load_no_jax(tmp_path):
    """``eventserver --stats``, a deploy with telemetry and an SLO spec,
    then ``slo``, ``capacity --json``, ``traces``, ``profile`` and
    ``metrics series|query`` through the CLI."""
    out = subprocess.run([sys.executable, "-c", _OBS_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    cli = lines[lines.index("CLI-OUTPUT-BEGIN") + 1:-1]
    assert cli[0] == "[INFO] SLO status: ok", cli
    assert cli[1].startswith("[INFO]   p99 (latency): ok"), cli
    doc_end = next(i for i, line in enumerate(cli) if line == "}")
    cap = json.loads("\n".join(cli[2:doc_end + 1]))
    assert cap["units"][0]["role"] == "active"
    assert set(cap["process"]) == {"deviceBytes", "deviceArrays",
                                   "deviceWatermarkBytes", "hostRssBytes"}
    rest = cli[doc_end + 1:]
    assert any("query_server POST /queries.json" in x for x in rest), rest
    assert any(x.startswith("[INFO] Captured") for x in rest), rest
    assert any(x.startswith("[INFO] pio_query_duration_seconds") and
               "[histogram]" in x for x in rest), rest
    series = json.loads(rest[-1])["series"]
    assert series and series[0]["points"][-1][1] == 5


_ROUTER_CHILD = r"""
import http.client, json, os, signal, sys, threading, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

mode, variant, router_port = sys.argv[1], sys.argv[2], int(sys.argv[3])
argv = ["router", "-v", variant, "--ip", "127.0.0.1",
        "--port", str(router_port)]
if mode == "url":
    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, doc):
            data = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send({"breached": False} if self.path.startswith("/slo")
                       else {"active": {"releaseVersion": 1}})

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self._send({"itemScores": [{"item": "a", "score": 1.0},
                                       {"item": "b", "score": 0.5}]})

        def log_message(self, *args):
            pass

    stub = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    argv += ["--replica-url", f"http://127.0.0.1:{stub.server_address[1]}"]
else:
    argv += ["--replicas", "1", "--device", "cpu"]

result = {}

def call(method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", router_port, timeout=30)
    c.request(method, path, body=None if body is None else json.dumps(body))
    r = c.getresponse()
    return r.status, json.loads(r.read())

def drive():
    try:
        deadline = time.time() + 150
        while time.time() < deadline:
            try:
                _, doc = call("GET", "/fleet/status.json")
                if doc["replicas"] and all(r["healthy"]
                                           for r in doc["replicas"]):
                    break
            except OSError:
                pass
            time.sleep(0.1)
        result["query"] = call("POST", "/queries.json",
                               {"user": "u1", "num": 2})
        torch = sys.modules.get("torch")
        result["torch_imported"] = torch is not None
        result["cuda_initialized"] = bool(
            torch is not None and torch.cuda.is_initialized())
        result["bad"] = sorted(
            m for m in sys.modules
            if any(m == t or m.startswith(t + ".") for t in (
                "jax", "predictionio_tpu", "aiohttp", "click")))
    finally:
        os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=drive, daemon=True).start()
from predictionio_tpu_torch.cli.main import main
result["rc"] = main(argv)
print(json.dumps(result), flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store_env(tmp):
    env = {"PIO_HOME": str(tmp), "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db")}
    for r in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{r}_NAME"] = "pio"
        env[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = "DB"
    return env


@pytest.fixture()
def trained_variant(tmp_path, monkeypatch):
    """An app with rate events and one CPU-trained release of it, in a
    sqlite store the children find through ``PIO_STORAGE_*``."""
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.engines.recommendation import engine
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.workflow.train import run_train

    env = _store_env(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    Storage.reset()
    eventstore.clear_cache()
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Guard"))
        Storage.get_events().init_channel(app_id)
        Storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item",
                  target_entity_id=f"i{(u * 7 + j) % 9}",
                  properties={"rating": float(1 + (u + j) % 5)})
            for u in range(12) for j in range(4)], app_id)
        variant = {"id": "default",
                   "engineFactory":
                       "predictionio_tpu_torch.engines.recommendation:engine",
                   "datasource": {"params": {"appName": "Guard"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 3, "numIterations": 2}}]}
        path = tmp_path / "engine.json"
        path.write_text(json.dumps(variant))
        eng = engine()
        run_train(eng, eng.engine_params_from_json(variant),
                  engine_factory=variant["engineFactory"], device="cpu")
    finally:
        Storage.reset()
        eventstore.clear_cache()
    return path, {**dict(__import__("os").environ), **env}


@pytest.mark.parametrize("mode", ["url", "spawn"])
def test_router_cli_loads_no_jax_and_no_cuda(trained_variant, mode):
    """``router`` over one ``--replica-url`` stub, and over one replica
    it spawns with ``--device cpu``: a query answers through it, and the
    router process imports neither jax, the reference, aiohttp nor click,
    nor torch (so it never initialises CUDA); SIGTERM stops it and the
    replica it spawned."""
    variant, env = trained_variant
    env["PIO_ROUTER_BASE_PORT"] = str(_free_port())
    env["PIO_TELEMETRY_INTERVAL_S"] = "0.2"
    out = subprocess.run(
        [sys.executable, "-c", _ROUTER_CHILD, mode, str(variant),
         str(_free_port())], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    status, body = result["query"]
    assert status == 200 and len(body["itemScores"]) == 2, result
    assert result["bad"] == [] and result["rc"] == 0, result
    assert result["torch_imported"] is False, result
    assert result["cuda_initialized"] is False, result
    if mode == "spawn":
        assert "Spawned replica 0" in out.stdout, out.stdout
        pid = int(out.stdout.split("(pid ")[1].split(")")[0])
        with pytest.raises(OSError):
            __import__("os").kill(pid, 0)      # the replica was stopped


_MULTISERVE_CHILD = r"""
import http.client, json, os, signal, sys, threading, time

variant, port = sys.argv[1], int(sys.argv[2])
result = {}

def call(method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request(method, path, body=None if body is None else json.dumps(body))
    r = c.getresponse()
    return r.status, json.loads(r.read())

def drive():
    try:
        deadline = time.time() + 150
        while time.time() < deadline:
            try:
                call("GET", "/")
                break
            except OSError:
                time.sleep(0.1)
        result["queries"] = [call("POST", f"/t/{t}/queries.json",
                                  {"user": "u1", "num": 2})
                             for t in ("alpha", "beta")]
        result["tenants"] = call("GET", "/tenants.json")
        result["residency"] = call("GET", "/residency.json")
        result["status"] = call("GET", "/t/beta/deploy/status.json")
        result["bad"] = sorted(
            m for m in sys.modules
            if any(m == t or m.startswith(t + ".") for t in (
                "jax", "predictionio_tpu", "aiohttp", "click")))
    finally:
        os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=drive, daemon=True).start()
from predictionio_tpu_torch.cli.main import main
result["rc"] = main(["multiserve", "--tenant", f"alpha={variant}",
                     "--tenant", f"beta={variant}", "--ip", "127.0.0.1",
                     "--port", str(port), "--device", "cpu"])
print(json.dumps(result), flush=True)
"""


def test_multiserve_cli_loads_no_jax(trained_variant):
    """``multiserve`` hosts two tenants of one CPU-trained variant: each
    answers through ``/t/NAME/queries.json``, the host's documents and a
    tenant's own ``deploy/status.json`` answer, and the process imports
    neither jax, the reference, aiohttp nor click; SIGTERM stops it."""
    variant, env = trained_variant
    env["PIO_TELEMETRY"] = "0"
    out = subprocess.run(
        [sys.executable, "-c", _MULTISERVE_CHILD, str(variant),
         str(_free_port())], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert [(s, len(b["itemScores"])) for s, b in result["queries"]] == \
        [(200, 2), (200, 2)], result
    status, doc = result["tenants"]
    assert status == 200 and [t["tenant"] for t in doc["tenants"]] == \
        ["alpha", "beta"] and all(t["resident"] for t in doc["tenants"])
    assert result["residency"][0] == 200, result
    status, doc = result["status"]
    assert status == 200 and doc["resident"] is True, result
    assert result["bad"] == [] and result["rc"] == 0, result
    assert "Tenant 'alpha'" in out.stdout and "Tenant 'beta'" in out.stdout


_ORCH_STATUS_CHILD = r"""
import json, os, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.obs.telemetry import TelemetryRecorder
from predictionio_tpu_torch.utils.server_config import TelemetryConfig

variant, tmp = sys.argv[1], sys.argv[2]
assert main(["orchestrate", "-v", variant, "--once", "--force",
             "--state-dir", os.path.join(tmp, "state"),
             "--device", "cpu"]) == 0
print("CLI-STATUS-BEGIN", flush=True)
assert main(["status"]) == 0
root = os.path.join(tmp, "telemetry-root")
reg = MetricsRegistry()
reg.counter("pio_router_requests_total", "q",
            labelnames=("replica", "status")).inc(replica="0", status="200")
rec = TelemetryRecorder("router-8100", TelemetryConfig(dir=root,
                                                       interval_s=60.0),
                        registries=[reg]).start()
rec.stop()
assert main(["status", "--fleet", root]) == 0
fleet = os.path.join(tmp, "p.jsonl.fleet.json")
with open(fleet, "w") as f:
    json.dump({"processes": ["0/2", "1/2"],
               "counterTotals": {"pio_batchpredict_rows_total": 7.0},
               "metrics": {"pio_batchpredict_rows_total": {"samples": [
                   {"labels": {"process": "0/2"}, "value": 4.0},
                   {"labels": {"process": "1/2"}, "value": 3.0}]}},
               "traces": [{"traceId": "t1", "process": "0/2"},
                          {"traceId": "t1", "process": "1/2"}]}, f)
assert main(["status", "--fleet", os.path.join(tmp, "p.jsonl")]) == 0
bad = sorted(m for m in sys.modules
             if any(m == t or m.startswith(t + ".") for t in (
                 "jax", "predictionio_tpu", "aiohttp", "click")))
print(json.dumps(bad), flush=True)
"""


def test_orchestrate_and_status_cli_load_no_jax(trained_variant, tmp_path):
    """``orchestrate --once --force`` (a promoted cycle), ``status``,
    ``status --fleet`` over a telemetry root and over a sharded run's
    fleet view, through the CLI in one process."""
    variant, env = trained_variant
    env["PIO_ORCH_PHASE_RETRIES"] = "0"
    out = subprocess.run(
        [sys.executable, "-c", _ORCH_STATUS_CHILD, str(variant),
         str(tmp_path)], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert any("promoted" in x and "(manual)" in x for x in lines), lines
    assert "candidate release v2" in out.stdout     # v1 was the seed
    status = lines[lines.index("CLI-STATUS-BEGIN") + 1:-1]
    assert "[INFO] Your system is all ready to go." in status
    assert any("Telemetry root" in x and "1 process store(s)" in x
               for x in status), status
    assert "[INFO] pio_batchpredict_rows_total fleet total: 7" in status
    assert any(x.startswith("[INFO] trace t1: 2 span(s)") for x in status)


_LOADTEST_CHILD = r"""
import datetime, json, os, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import Storage

tmp = sys.argv[1]
os.environ.update({
    "PIO_INGEST_PARTITIONS": "2",
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
old = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
store.insert_batch([Event(event="view", entity_type="user",
                          entity_id=f"u{i}", event_time=old)
                    for i in range(30)], app_id)
assert main(["reshard", "-p", "3"]) == 0
assert main(["compact", "--appname", "Guard", "--ttl-days", "1"]) == 0
Storage.reset()
del os.environ["PIO_INGEST_PARTITIONS"]
scenario = os.path.join(tmp, "storm.json")
with open(scenario, "w") as f:
    json.dump({"name": "guard", "population": 60, "items": 20,
               "durationS": 2.0, "seed": 3, "baseRate": 20.0,
               "replicas": 2, "partitions": 2, "maxOutstanding": 32,
               "incidents": [{"kind": "retrain", "atS": 0.5}]}, f)
assert main(["loadtest", "--scenario", scenario, "--device", "cpu",
             "--dir", os.path.join(tmp, "fleet"),
             "--report", os.path.join(tmp, "report.json")]) == 0
bad = sorted(m for m in sys.modules
             if any(m == t or m.startswith(t + ".") for t in (
                 "jax", "predictionio_tpu", "aiohttp", "click")))
print(json.dumps(bad), flush=True)
"""


def test_loadtest_compact_and_reshard_cli_load_no_jax(tmp_path):
    """``reshard`` and ``compact`` on a partitioned store, then a storm
    through ``loadtest`` (2 replicas, 2 partitions, a retrain) on the
    CPU, through the CLI in one process."""
    out = subprocess.run(
        [sys.executable, "-c", _LOADTEST_CHILD, str(tmp_path)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert lines[0] == ('[INFO] Resharded 1 namespace(s): {"copied": 30, '
                        '"count": 3, "gen": 1, "old_count": 2}')
    assert lines[1] == '[INFO] Compacted app 1: {"removed_rows": 30}'
    assert any(x.startswith("[INFO] storm verdict: OK") for x in lines)
    assert any(x.startswith("[OK] exactly_once_ingest") for x in lines)
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["ok"] and report["audit"]["ok"]


_MESH_TRAIN_CHILD = r"""
import json, os, sys
from predictionio_tpu_torch.cli.main import main

tmp, pid = sys.argv[1], int(sys.argv[2])
os.environ.update({
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "pio.db"),
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"})
if pid == 0:
    # the events land before the rendezvous, so process 1 reads them
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
assert main(["train", "--variant", variant, "--mesh-shape", "2",
             "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_two_process_mesh_train_cli_loads_no_jax(tmp_path):
    """``train --mesh-shape 2`` as two processes of one gloo group (the
    PIO_* contract): both train over the 2-position mesh, process 0
    alone records the instance."""
    import os

    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from test_torch_parallel import free_port
    finally:
        sys.path.pop(0)
    port = free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _MESH_TRAIN_CHILD, str(tmp_path),
             str(pid)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.strip().splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines0, lines1 = outs
    assert lines0[-1] == "[]" and lines1[-1] == "[]", outs
    rec0, rec1 = json.loads(lines0[-2]), json.loads(lines1[-2])
    assert rec0["nnz"] == rec1["nnz"] == 48
    assert rec0["instance"] and rec1["instance"] is None


def test_two_process_child_loads_no_jax(tmp_path):
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from test_torch_parallel import run_children
    finally:
        sys.path.pop(0)
    results = run_children("collectives", tmp_path)
    assert [r["forbidden_modules"] for r in results.values()] == [[], []]


def test_two_process_classify_similar_and_session_trains_on_a_mesh_load_no_jax(
        tmp_path):
    """The classification engine's three algorithms, the similar-product
    cooccurrence algorithm and the session engine's algorithm, each
    trained on ``mesh_of(ctx)`` by two processes of one gloo group
    (``tests/torch_distributed_child.py`` phase ``engines``): neither
    process loads jax or the JAX package, and both train the same
    models."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from test_torch_parallel import run_children
    finally:
        sys.path.pop(0)
    results = run_children("engines", tmp_path)
    assert [r["forbidden_modules"] for r in results.values()] == [[], []]
    r0, r1 = results[0], results[1]
    for key in ("naive", "logreg", "forest", "cooccurrence", "sessionrec"):
        assert r0[key] == r1[key], key
    assert r0["cooccurrence"] and r0["sessionrec"]


_OPS_CHILD = r"""
import http.client, json, os, socket, sys, threading, time
from predictionio_tpu_torch.cli.main import main

tmp = sys.argv[1]
os.environ.update({
    "PIO_HOME": tmp, "PIO_TELEMETRY": "0",
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "o.db"),
    **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
       for r in ("METADATA", "EVENTDATA", "MODELDATA")
       for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
with open(os.path.join(tmp, "opsmod.py"), "w") as f:
    f.write("print('module ran')\n")
sys.path.insert(0, tmp)

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

def get(port, path):
    for _ in range(600):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("GET", path)
            r = c.getresponse()
            return r.status, r.read()
        except ConnectionRefusedError:
            time.sleep(0.05)

assert main(["version"]) == 0
assert main(["app", "new", "Ops", "--access-key", "k"]) == 0
assert main(["app", "channel-new", "Ops", "side"]) == 0
assert main(["app", "show", "Ops"]) == 0
assert main(["accesskey", "new", "Ops", "--key", "k2"]) == 0
assert main(["accesskey", "delete", "k2"]) == 0
assert main(["app", "data-delete", "Ops", "--channel", "side",
             "--force"]) == 0
assert main(["app", "channel-delete", "Ops", "side", "--force"]) == 0
assert main(["export", "--appname", "Ops", "--output",
             os.path.join(tmp, "ops.jsonl")]) == 0
assert main(["analyze", "--json", "--dir", os.path.join(tmp, "tel")]) == 0
assert main(["run", "opsmod"]) == 0
ports = {}
for cmd in ("adminserver", "dashboard"):
    ports[cmd] = free_port()
    threading.Thread(target=main, args=([cmd, "--port", str(ports[cmd]),
                                         "--device", "cpu"],),
                     daemon=True).start()
status, body = get(ports["adminserver"], "/cmd/app")
assert status == 200 and json.loads(body)["apps"][0]["name"] == "Ops"
status, body = get(ports["dashboard"], "/evaluations.json")
assert status == 200 and json.loads(body) == [], body
status, body = get(ports["dashboard"], "/")
assert status == 200 and b"<h2>Releases</h2>" in body
assert main(["app", "delete", "Ops", "--force"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu.")
             or m.split(".")[0] in ("aiohttp", "click"))
print(json.dumps(bad), flush=True)
os._exit(0)
"""


def test_operator_cli_loads_no_jax(tmp_path):
    """``version``, the app, channel and key management commands,
    ``export``, ``analyze``, ``run``, ``adminserver`` and ``dashboard``
    through the CLI in one process."""
    out = subprocess.run([sys.executable, "-c", _OPS_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert lines[0] == "0.1.0"
    assert "module ran" in lines


_EVLOG_CHILD = r"""
import json, os, shutil, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.registry import Storage

tmp = sys.argv[1]
codec = "native" if shutil.which("g++") else "python"
os.environ.update({
    "PIO_HOME": tmp, "PIO_TELEMETRY": "0",
    "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(tmp, "meta.db"),
    "PIO_STORAGE_SOURCES_LOG_TYPE": "evlog",
    "PIO_STORAGE_SOURCES_LOG_CODEC": codec,
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"})
src = os.path.join(tmp, "events.jsonl")
with open(src, "w") as f:
    for u in range(12):
        for j in range(4):
            f.write(Event(event="rate", entity_type="user",
                          entity_id=f"u{u}", target_entity_type="item",
                          target_entity_id=f"i{(u * 7 + j) % 9}",
                          properties={"rating": float(1 + (u + j) % 5)}
                          ).to_json() + "\n")
assert main(["app", "new", "Guard", "--access-key", "k"]) == 0
assert main(["import", "--appname", "Guard", "--input", src]) == 0
variant = os.path.join(tmp, "engine.json")
with open(variant, "w") as f:
    json.dump({"datasource": {"params": {"appName": "Guard"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 3, "numIterations": 2}}]}, f)
assert main(["train", "--variant", variant, "--device", "cpu"]) == 0
store = Storage.get_events()
assert store.client.codec.name == codec, store.client.codec.name
assert os.path.exists(os.path.join(tmp, "evlog", "events_1.evlog"))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_evlog_store_cli_loads_no_jax(tmp_path):
    """``app new``, ``import`` and ``train --device cpu`` on an evlog
    EVENTDATA source (its default path under ``PIO_HOME``)."""
    out = subprocess.run([sys.executable, "-c", _EVLOG_CHILD, str(tmp_path)],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["nnz"] == 48
    assert lines[-1] == "[]", out.stdout


_CHECK_CHILD = r"""
import json, sys
from predictionio_tpu_torch.cli.main import main
assert main(["check", "--json"]) == 0
# the static analysis ran without torch: no device, no CUDA state
assert "torch" not in sys.modules
from predictionio_tpu_torch.entry import main as entry_main
assert entry_main(["2", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "predictionio_tpu"
             or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_check_cli_and_entry_module_load_no_jax():
    """``check`` over the port's whole tree (exit 0, without importing
    torch at all), then the entry module's forward step and its dry run
    over a 2-position CPU mesh."""
    out = subprocess.run([sys.executable, "-c", _CHECK_CHILD],
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-2])
    assert report["als"] == {"U": [64, 8], "V": [48, 8]}
    assert report["seqrec"]["mesh"] == {"data": 1, "model": 2}
    assert lines[-1] == "[]", out.stdout[-3000:]


def test_analysis_imports_no_torch_at_module_level():
    """The static analysis runs where no device is: no module under
    ``analysis/`` imports ``torch`` (``torch.cuda`` with it) at module
    level."""
    found = []
    for path in sorted((PKG / "analysis").rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            found += [(path.name, n) for n in names
                      if n == "torch" or n.startswith("torch.")]
    assert not found, found


def test_scan_covers_the_analysis_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"analysis/__init__.py", "analysis/model.py",
            "analysis/callgraph.py", "analysis/engine.py",
            "analysis/registry.py", "analysis/checkers/__init__.py",
            "analysis/checkers/exceptions.py",
            "analysis/checkers/durable_writes.py",
            "analysis/checkers/threads.py", "analysis/checkers/locks.py",
            "analysis/checkers/knobs.py",
            "analysis/checkers/compile_ledger.py",
            "analysis/checkers/wire.py", "analysis/checkers/telemetry.py",
            "analysis/checkers/legacy.py", "entry.py"} <= scanned


def test_scan_covers_the_storage_and_library_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"native/__init__.py", "native/evlog.py",
            "storage/evlog_backend.py", "storage/postgres_backend.py",
            "storage/registry.py", "storage/base.py", "utils/config.py",
            "utils/cleanup.py", "utils/logging_util.py",
            "data/entity_map.py", "data/bimap.py",
            "core/self_cleaning.py"} <= scanned


def test_scan_covers_the_operator_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"data/webhooks/__init__.py", "data/webhooks/example.py",
            "data/webhooks/segmentio.py", "data/webhooks/mailchimp.py",
            "server/admin.py", "server/dashboard.py", "server/http.py",
            "server/event_server.py", "server/multitenant.py",
            "utils/server_config.py", "deploy/foldin.py",
            "cli/main.py"} <= scanned


def test_scan_covers_the_loadtest_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"storage/partitioned.py", "storage/audit.py",
            "obs/loadtest_stats.py", "loadtest/__init__.py",
            "loadtest/harness.py", "loadtest/population.py",
            "loadtest/scenario.py", "loadtest/invariants.py",
            "loadtest/simulator.py", "loadtest/fleet.py",
            "data/write_buffer.py"} <= scanned


def test_scan_covers_the_observability_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"obs/middleware.py", "obs/anatomy.py", "obs/profiler.py",
            "obs/tsdb.py", "obs/telemetry.py", "obs/slo.py",
            "obs/capacity.py", "obs/device_stats.py",
            "obs/scoring_stats.py", "obs/train_stats.py",
            "obs/eval_stats.py", "obs/foldin_stats.py",
            "storage/logstore.py", "server/stats.py",
            "workflow/instrument.py", "utils/profiling.py"} <= scanned


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


def test_scan_covers_the_fleet_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"server/router.py", "server/http_client.py", "deploy/fleet.py",
            "deploy/orchestrator.py", "obs/orch_stats.py", "utils/retry.py",
            "storage/faults.py"} <= scanned
    assert ROOT / "chip_smoke.py" in _port_sources()


def test_scan_covers_the_classification_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"engines/classification.py", "models/naive_bayes.py",
            "models/logreg.py", "models/forest.py", "models/vectorizer.py",
            "models/markov_chain.py", "ops/device_cache.py",
            "data/ingest.py"} <= scanned


def test_scan_covers_the_sessionrec_modules():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_sources()
               if PKG in p.parents}
    assert {"engines/sessionrec.py", "models/seqrec.py", "ops/attention.py",
            "data/ingest.py", "workflow/serialization.py",
            "cli/main.py"} <= scanned


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "predictionio_tpu", "aiohttp", "click"))


#: string constants that name a jax object without importing it: the
#: dotted paths the static-analysis rules PIO001 and PIO007 match in the
#: code they check (``JIT_PATHS``). Each must still be there.
_MATCH_PATTERNS = {
    "predictionio_tpu_torch/analysis/checkers/compile_ledger.py":
        {"jax.jit", "jax.pmap"}}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    patterns = _MATCH_PATTERNS.get(path.relative_to(ROOT).as_posix(), set())
    found, matched = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib.import_module("jax...") and the like
            if node.value in patterns:
                matched.add(node.value)
            elif _forbidden(node.value):
                found.append(node.value)
    assert not found, f"{path}: {found}"
    assert matched == patterns, f"{path}: stale match patterns"


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


def _entry_forward():
    from predictionio_tpu_torch.entry import entry

    return entry()


def _entry_dryrun():
    from predictionio_tpu_torch.entry import dryrun_multichip

    return dryrun_multichip(2)


def _make_mesh():
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def _build_sharded_scorer():
    from predictionio_tpu_torch.ops.scoring import build_sharded_scorer
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    v = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    return build_sharded_scorer(v, ScorerConfig(mode="twostage", shards=2))


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


def _cli_console(cmd):
    from predictionio_tpu_torch.cli.main import main

    return main([cmd, "--port", "0"])


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


def _cli_orchestrate(tmp_path):
    from predictionio_tpu_torch.cli.main import main

    return main(["orchestrate", "-v", str(tmp_path / "engine.json"),
                 "--once", "--force"])


def _cli_loadtest(tmp_path):
    from predictionio_tpu_torch.cli.main import main

    return main(["loadtest", "--dir", str(tmp_path / "fleet")])


def _local_fleet(tmp_path):
    from predictionio_tpu_torch.loadtest.fleet import LocalFleet

    return LocalFleet(str(tmp_path / "fleet")).start()


def _similarity_model():
    from predictionio_tpu_torch.engines.similarproduct import (
        SimilarityModel,
    )

    return SimilarityModel(item_vocab=np.array(["i"]),
                           V=np.ones((1, 2), np.float32), items={})


def _seqrec(entry):
    from predictionio_tpu_torch.models import seqrec

    sessions = [["a", "b", "c"], ["b", "c", "a"]]
    p = seqrec.SeqRecParams(d_model=8, n_heads=2, n_layers=1, max_len=4,
                            epochs=1, batch_size=2)
    if entry == "train_seqrec":
        return seqrec.train_seqrec(None, sessions, p)
    m = seqrec.train_seqrec(None, sessions, p, device="cpu")
    m.device = None
    m.release_device()
    return m.recommend_next(["a"], 2)


def _classifier(fit):
    from predictionio_tpu_torch.models import forest, logreg, naive_bayes

    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = ["a", "b"] * 3
    if fit == "ForestModel.predict":
        m = forest.train_forest(X, y, forest.ForestParams(num_trees=2),
                                device="cpu")
        m.device = None
        m.release_device()
        return m.predict(X)
    return {"train_multinomial_nb": lambda: naive_bayes.train_multinomial_nb(
                X, y),
            "train_logreg": lambda: logreg.train_logreg(X, y),
            "train_forest": lambda: forest.train_forest(
                X, y, forest.ForestParams(num_trees=2))}[fit]()


@pytest.mark.parametrize("entry", ["ALSModel.from_arrays", "load_model",
                                   "build_scorer", "cli deploy",
                                   "train_als", "cli train", "run_train",
                                   "load_for_deploy", "FoldInSolver",
                                   "train_cooccurrence", "SimilarityModel",
                                   "run_sweep", "run_evaluation",
                                   "cli eval", "run_batch_predict",
                                   "cli batchpredict", "cli orchestrate",
                                   "train_multinomial_nb", "train_logreg",
                                   "train_forest", "ForestModel.predict",
                                   "train_seqrec",
                                   "SeqRecModel.recommend_next",
                                   "cli loadtest", "LocalFleet.start",
                                   "make_mesh", "build_sharded_scorer",
                                   "cli adminserver", "cli dashboard",
                                   "entry", "dryrun_multichip"])
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
            "cli batchpredict": lambda: _cli_batchpredict(tmp_path),
            "cli orchestrate": lambda: _cli_orchestrate(tmp_path),
            "train_seqrec": lambda: _seqrec(entry),
            "SeqRecModel.recommend_next": lambda: _seqrec(entry),
            "cli loadtest": lambda: _cli_loadtest(tmp_path),
            "LocalFleet.start": lambda: _local_fleet(tmp_path),
            "make_mesh": _make_mesh,
            "build_sharded_scorer": _build_sharded_scorer,
            "cli adminserver": lambda: _cli_console("adminserver"),
            "cli dashboard": lambda: _cli_console("dashboard"),
            "entry": _entry_forward,
            "dryrun_multichip": _entry_dryrun}.get(
                entry, lambda: _classifier(entry))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_explicit_cpu_is_honoured(tmp_path):
    assert _als_model(device="cpu").device == torch.device("cpu")
    assert _load_model(tmp_path, device="cpu").device == torch.device("cpu")
    assert _build_scorer(device="cpu").device == torch.device("cpu")
