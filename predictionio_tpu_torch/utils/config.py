"""Environment configuration helpers (port of the reference's
``utils/config.py``; WorkflowUtils.pioEnvVars parity,
core/.../workflow/WorkflowUtils.scala:193, and the conf/pio-env.sh
contract): ``PIO_*`` variables configure the storage topology
(``storage/registry``) and the runtime homes.

The reference's ``honor_jax_platforms`` has no counterpart: the port
never imports jax.
"""

from __future__ import annotations

import os
from typing import Dict


def pio_home() -> str:
    """``$PIO_HOME``, else ``~/.pio_tpu``."""
    return os.environ.get(
        "PIO_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu"))


def pio_env_vars() -> Dict[str, str]:
    """All PIO_* env vars (passed between processes like
    Runner.scala:216)."""
    return {k: v for k, v in os.environ.items() if k.startswith("PIO_")}
