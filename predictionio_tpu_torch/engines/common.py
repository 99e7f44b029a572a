"""Helpers shared by the ALS-backed engines (the subset of the
reference's ``engines/common.py`` that training uses)."""

from __future__ import annotations


def resolved_als_solver(algo_params, logger) -> "tuple[str, int]":
    """Resolve and log the ALS training solver for an engine's train():
    the algo params' optional ``solver`` section through
    ``utils/server_config.als_solver_config`` (the server.json ``train``
    section and ``PIO_ALS_*`` env apply)."""
    from predictionio_tpu_torch.utils.server_config import als_solver_config

    solver, block_size = als_solver_config(
        getattr(algo_params, "solver", None))
    logger.info("ALS solver: %s (block_size=%d, rank=%d)",
                solver, block_size, algo_params.rank)
    return solver, block_size
