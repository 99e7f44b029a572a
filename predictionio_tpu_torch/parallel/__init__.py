"""Distributed substrate of the port: meshes of positions
(``parallel/mesh``), collectives over them (``parallel/collectives``),
the multi-process runtime, a ``torch.distributed`` process group
(``parallel/distributed``), and the cross-process row exchange
(``parallel/shuffle``).

The names below load on first use: the worker contract of
``parallel/distributed`` serves processes that never import torch (the
router).
"""

_EXPORTS = {
    "DATA_AXIS": "mesh", "MODEL_AXIS": "mesh", "Mesh": "mesh",
    "make_mesh": "mesh", "mesh_shape_from_conf": "mesh",
    "initialize_distributed": "distributed",
    "process_count": "distributed", "process_index": "distributed",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib

    module = importlib.import_module(
        f"predictionio_tpu_torch.parallel.{_EXPORTS[name]}")
    return getattr(module, name)
