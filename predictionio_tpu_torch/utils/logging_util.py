"""Logging configuration (port of the reference's
``utils/logging_util.py``, the WorkflowUtils.modifyLogging:271 analog)."""

from __future__ import annotations

import logging


def configure_logging(verbose: bool = False) -> None:
    """Root logging at INFO (DEBUG when ``verbose``) in the reference's
    format. The reference also quiets its compiler's and its HTTP
    library's access loggers; the port loads neither, and its own HTTP
    server (``server/http``) writes no access log."""
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(levelname)s] [%(name)s] %(message)s")
