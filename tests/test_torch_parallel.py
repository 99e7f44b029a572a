"""The port's mesh, collectives and row exchange (``parallel/``), held
against the JAX package's on the CPU.

* ``make_mesh`` / ``mesh_shape_from_conf`` against the reference's (the
  port's explicit device list repeating the CPU, the reference's eight
  virtual CPU devices);
* every collective on an 8-position single-process mesh (4 x 2, both
  axes) against the reference's ``shard_map`` over ``mesh8``'s devices;
* the same collectives across TWO processes (a gloo group; a 2 x 2 mesh
  whose "data" axis crosses the processes), ``exchange_rows`` with the
  contract's ordering (grouped by source process, each source's order
  kept), ``allgather_object``, ``global_vocab`` and
  ``broadcast_one_to_all``.

The children (``tests/torch_distributed_child.py``) get the repo root on
``PYTHONPATH``, a free port and a bounded ``communicate``. Collective
results are compared exactly up to float32 reassociation (atol 1e-5).
"""

import json
import os
import pathlib
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as P

from predictionio_tpu.parallel import collectives as RC
from predictionio_tpu.parallel import mesh as ref_mesh
from predictionio_tpu.parallel.compat import shard_map
from predictionio_tpu_torch.parallel import collectives as C
from predictionio_tpu_torch.parallel import mesh as port_mesh
from predictionio_tpu_torch.parallel.shuffle import (
    allgather_object, exchange_rows, global_vocab,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHILD = ROOT / "tests" / "torch_distributed_child.py"
CPU = torch.device("cpu")
ATOL = 1e-5
OPS = ("psum", "pmean", "all_gather", "all_gather_stacked",
       "reduce_scatter", "all_to_all", "ring_pass", "ring_pass_rev",
       "ring_reduce")


def free_port() -> int:
    """A free loopback port for a group's coordinator, drawn below the
    kernel's ephemeral range: gloo's pair sockets listen on ephemeral
    ports, so under parallel test workers a port picked from that range
    could be taken by another group's pair before the coordinator binds
    it, and the second process would rendezvous with that pair."""
    try:
        low = int(pathlib.Path(
            "/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 12000), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free coordinator port below the ephemeral range")


def run_children(phase: str, work, nproc: int = 2, timeout: float = 300):
    """Run ``nproc`` children of ``phase``; their RESULT dicts by pid.
    A child that hangs (no rendezvous) is killed and fails the test."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    for k in ("PIO_COORDINATOR_ADDRESS", "PIO_NUM_PROCESSES",
              "PIO_PROCESS_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), phase, str(pid), str(nproc),
         str(port), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(work))
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed child hung (no gloo rendezvous?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["pid"]] = r
    assert sorted(results) == list(range(nproc)), outs
    return results


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    (None, None), ((8,), ("data",)), ((4, 2), ("data", "model")),
    ((2, 2), None), ((1,), None)])
def test_make_mesh_matches_reference(shape, axes):
    ref = ref_mesh.make_mesh(shape, axes, devices=jax.devices()[:8])
    got = port_mesh.make_mesh(shape, axes, devices=[CPU] * 8)
    assert dict(got.shape) == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.devices.shape == ref.devices.shape
    assert got.size == ref.devices.size
    assert list(got.local_positions()) == list(range(got.size))
    assert not got.spans_processes


def test_make_mesh_refuses_like_reference():
    with pytest.raises(ValueError) as ref_err:
        ref_mesh.make_mesh((3, 3), None, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got_err:
        port_mesh.make_mesh((3, 3), None, devices=[CPU] * 8)
    assert str(got_err.value) == str(ref_err.value)


def test_default_mesh_is_one_position_per_process():
    m = port_mesh.make_mesh(device="cpu")
    assert dict(m.shape) == {"data": 1} and m.devices[0] == CPU
    assert list(m.process_indices.flat) == [0]


@pytest.mark.parametrize("conf", [
    {}, {"mesh_shape": "4,2", "mesh_axes": "data,model"},
    {"mesh_shape": "8"}, {"mesh_shape": [2, 2], "mesh_axes": ["a", "b"]},
    {"mesh_shape": "2,", "mesh_axes": "data,"}])
def test_mesh_shape_from_conf_matches_reference(conf):
    assert port_mesh.mesh_shape_from_conf(conf) == \
        ref_mesh.mesh_shape_from_conf(conf)


# ---------------------------------------------------------------------------
# collectives against the reference's shard_map
# ---------------------------------------------------------------------------

def _ref_fn(op: str, axis: str, n: int):
    return {
        "psum": lambda x: RC.psum(x, axis),
        "pmean": lambda x: RC.pmean(x, axis),
        "all_gather": lambda x: RC.all_gather(x, axis),
        "all_gather_stacked": lambda x: RC.all_gather(x, axis, tiled=False),
        "reduce_scatter": lambda x: RC.reduce_scatter(x, axis),
        "all_to_all": lambda x: RC.all_to_all(x, axis),
        "ring_pass": lambda x: RC.ring_pass(x, axis, n),
        "ring_pass_rev": lambda x: RC.ring_pass(x, axis, n, reverse=True),
        "ring_reduce": lambda x: RC.ring_reduce(x, axis, n),
    }[op]


def _port_fn(op: str, axis: str, n: int, mesh):
    return {
        "psum": lambda b: C.psum(b, mesh, axis),
        "pmean": lambda b: C.pmean(b, mesh, axis),
        "all_gather": lambda b: C.all_gather(b, mesh, axis),
        "all_gather_stacked": lambda b: C.all_gather(b, mesh, axis,
                                                     tiled=False),
        "reduce_scatter": lambda b: C.reduce_scatter(b, mesh, axis),
        "all_to_all": lambda b: C.all_to_all(b, mesh, axis),
        "ring_pass": lambda b: C.ring_pass(b, mesh, axis, n),
        "ring_pass_rev": lambda b: C.ring_pass(b, mesh, axis, n,
                                               reverse=True),
        "ring_reduce": lambda b: C.ring_reduce(b, mesh, axis, n),
    }[op]


def reference_blocks(op: str, axis: str, shape, g: np.ndarray):
    """The reference collective under shard_map over a mesh of
    ``shape`` (axes data, model) on the virtual CPU devices, each
    position's [4, 3] block of ``g``; returns each position's output
    block, by (i, j)."""
    n_dev = int(np.prod(shape))
    mesh = RefMesh(np.asarray(jax.devices()[:n_dev]).reshape(shape),
                   ("data", "model"))
    n = shape[0] if axis == "data" else shape[1]
    f = shard_map(_ref_fn(op, axis, n), mesh=mesh,
                  in_specs=P("data", "model"), out_specs=P("data", "model"),
                  check_vma=False)
    out = np.asarray(jax.jit(f)(g))
    a, b = out.shape[0] // shape[0], out.shape[1] // shape[1]
    return {(i, j): out[a * i:a * (i + 1), b * j:b * (j + 1)]
            for i in range(shape[0]) for j in range(shape[1])}


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("op", OPS)
def test_collective_on_8_positions_matches_reference(op, axis):
    shape = (4, 2)
    g = (np.arange(16 * 6, dtype=np.float32).reshape(16, 6) * 0.75 - 9.0)
    want = reference_blocks(op, axis, shape, g)
    mesh = port_mesh.make_mesh(shape, ("data", "model"), devices=[CPU] * 8)
    blocks = [torch.from_numpy(g[4 * i:4 * i + 4, 3 * j:3 * j + 3].copy())
              for i in range(4) for j in range(2)]
    n = mesh.shape[axis]
    got = _port_fn(op, axis, n, mesh)(blocks)
    for p, t in enumerate(got):
        np.testing.assert_allclose(t.numpy(), want[divmod(p, 2)],
                                   atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# across two processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    return run_children("collectives", tmp_path_factory.mktemp("coll"))


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("op", OPS)
def test_collective_across_two_processes_matches_reference(
        two_process, op, axis):
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from torch_distributed_child import blocks_input
    finally:
        sys.path.pop(0)
    want = reference_blocks(op, axis, (2, 2), blocks_input())
    for pid, res in two_process.items():
        got = res["collectives"][axis][op]
        for j, block in enumerate(got):
            np.testing.assert_allclose(np.asarray(block, np.float32),
                                       want[(pid, j)], atol=ATOL, rtol=0)


def test_exchange_rows_ordering_across_two_processes(two_process):
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from torch_distributed_child import exchange_input
    finally:
        sys.path.pop(0)
    sent = [exchange_input(pid) for pid in (0, 1)]
    for me, res in two_process.items():
        # rows destined here, grouped by source process, each source's
        # local order kept (the reference's shuffle contract)
        want = np.concatenate([payload[dest == me]
                               for dest, payload in sent])
        assert np.array_equal(np.asarray(res["exchange"], np.int32), want)
    total = sum(len(r["exchange"]) for r in two_process.values())
    assert total == sum(len(d) for d, _ in sent)


def test_object_collectives_across_two_processes(two_process):
    for pid, res in two_process.items():
        assert res["objects"] == [{"pid": 0}, {"pid": 1}]
        assert res["vocab"] == ["shared", "v0", "v1", "w0", "w1"]
        assert res["broadcast"] == [0, 0, 0]
        assert res["forbidden_modules"] == []


def test_single_process_shuffle_is_the_identity():
    dest = np.asarray([1, 0, 1, 0], np.int32)
    payload = np.arange(8, dtype=np.int32).reshape(4, 2)
    assert np.array_equal(exchange_rows(dest, payload),
                          payload[np.argsort(dest, kind="stable")])
    assert allgather_object(5) == [5]
    assert global_vocab(np.asarray(["b", "a", "b"], object)).tolist() \
        == ["a", "b"]
    out = C.broadcast_one_to_all((np.arange(3),))
    assert out[0].tolist() == [0, 1, 2]
