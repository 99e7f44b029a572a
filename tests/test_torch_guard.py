"""The port stands alone: predictionio_tpu_torch (and chip_smoke.py) never
import jax or the JAX package, and its entry points never fall back to
the CPU on their own.

* a subprocess imports every module of the port and serves one query
  over HTTP on the CPU, then finds neither ``jax`` nor any
  ``predictionio_tpu`` module in ``sys.modules``;
* an AST scan finds no such import in the package or in chip_smoke.py;
* each entry point called without ``device=`` raises when CUDA is
  absent.
"""

import ast
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


def _cli_deploy(tmp_path):
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.workflow.serialization import save_model

    path = tmp_path / "m.npz"
    save_model(path, _als_model(device="cpu"))
    return main(["deploy", "--model", str(path), "--port", "0"])


@pytest.mark.parametrize("entry", ["ALSModel.from_arrays", "load_model",
                                   "build_scorer", "cli deploy"])
def test_entry_point_without_device_raises_without_card(no_card, tmp_path,
                                                        entry):
    call = {"ALSModel.from_arrays": lambda: _als_model(),
            "load_model": lambda: _load_model(tmp_path),
            "build_scorer": lambda: _build_scorer(),
            "cli deploy": lambda: _cli_deploy(tmp_path)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_explicit_cpu_is_honoured(tmp_path):
    assert _als_model(device="cpu").device == torch.device("cpu")
    assert _load_model(tmp_path, device="cpu").device == torch.device("cpu")
    assert _build_scorer(device="cpu").device == torch.device("cpu")
