"""Same-card A/B of the load test's storm against another checkout.

    python3 -m predictionio_tpu_torch.tools.storm_ab --base DIR \\
        [--pairs N] [--out FILE]

``DIR`` is a checkout of another commit of this repository (unpack one
with ``git archive``). Each run is ``chip_smoke.py``'s storm leg
(``loadtest_storm_leg``: ``cfg_loadtest``'s sustained storm, its
``LocalFleet``, trains and fold-in on the card) in a process of its own,
from that side's checkout, in the order base, this, this, base, base,
this, ... (``--pairs`` pairs). A run prints the leg's ``loadtest:``
lines (the storm's timeline, its lanes' p99s and launch counts), or the
invariant it violated.

The script prints the card's name and power limit, each run's lines
prefixed with its side and order, and a summary: each side's query and
event-ack p99s run by run, and how many runs passed. ``--out`` writes
the same lines to a file.
"""

# pio: ignore-file[PIO100]: a command-line tool; its report is its stdout

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: one storm leg in the side's checkout; a violated invariant is a line
LEG = (
    "import pathlib, sys\n"
    "import chip_smoke\n"
    "try:\n"
    "    chip_smoke.loadtest_storm_leg(pathlib.Path(sys.argv[1]))\n"
    "except chip_smoke.SmokeFailure as e:\n"
    "    print(f'loadtest: FAILED: {e}', flush=True)\n")

P99 = re.compile(r"ack p99 events ([0-9.]+) ms, feedback ([0-9.]+) ms, "
                 r"queries ([0-9.]+) ms")


def run_leg(root: pathlib.Path, work: pathlib.Path) -> list:
    """The ``loadtest:`` lines of one storm leg run from ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run(
        [sys.executable, "-c", LEG, str(work)], cwd=str(root), env=env,
        capture_output=True, text=True, timeout=900)
    lines = [x for x in out.stdout.splitlines()
             if x.startswith("loadtest:")]
    if out.returncode != 0:
        lines.append(f"loadtest: FAILED: exit {out.returncode}: "
                     + out.stderr[-2000:].replace("\n", " | "))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="checkout of the commit to compare with")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    base = pathlib.Path(args.base).resolve()
    order = []
    for i in range(args.pairs):
        order += [("base", "this"), ("this", "base")][i % 2]
    report = []

    def emit(line: str) -> None:
        report.append(line)
        print(line, flush=True)

    emit(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    runs = {"base": [], "this": []}
    for n, side in enumerate(order):
        root = base if side == "base" else ROOT
        (root / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="storm-ab-",
                                         dir=str(root / "build")) as work:
            lines = run_leg(root, pathlib.Path(work))
        for line in lines:
            emit(f"{side} {n}: {line}")
        got = next((P99.search(x) for x in lines if P99.search(x)), None)
        failed = any(x.startswith("loadtest: FAILED") for x in lines)
        runs[side].append((got.groups() if got else None, failed))
    for side, got in runs.items():
        emit(f"summary {side}: query p99 ms "
             f"{[g[2] if g else None for g, _ in got]}, event ack p99 ms "
             f"{[g[0] if g else None for g, _ in got]}, passed "
             f"{sum(not f for _, f in got)} of {len(got)}")
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
