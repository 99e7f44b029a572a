"""Mid-training checkpoint/resume (port of the reference's
``workflow/checkpoint.py``; the file format is the reference's, so
either package resumes the other's snapshots).

Algorithms that accept a ``Checkpointer`` save their training state (a
dict of numpy arrays; tensors are copied to the host) every N
iterations and resume from the latest snapshot after a crash or
preemption. One pickle per snapshot, ``step_<N>[.<fp8>].pkl``, written
atomically (temporary file, fsync, rename), so a crash mid-save never
corrupts the latest good snapshot; ``latest()`` picks the highest step.

* **Fingerprinted resume.** A snapshot carries the run's fingerprint
  (hyperparams + dataset identity, computed by the algorithm); an
  8-hex-char hash of it tags the file name. ``latest(fingerprint=...)`` only
  resumes snapshots of that exact fingerprint, so a restarted run with
  other params or data retrains from scratch.
* **Restricted deserialization.** Snapshots load through an unpickler
  that resolves only the ndarray machinery and builtin containers: a
  writable checkpoint directory does not grant code execution.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
from typing import Any, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: step_<N>.pkl (no lineage tag) or step_<N>.<fp8>.pkl — the tag is an
#: 8-hex-char hash of the run fingerprint (``_tag``), letting GC and resume treat
#: each run lineage independently without opening the files
_SNAP_RE = re.compile(r"^step_(\d+)(?:\.([0-9a-f]{8}))?\.pkl$")

#: exact (module, name) pairs the snapshot unpickler may resolve — the
#: ndarray reconstruction machinery only. Deliberately NOT whole modules:
#: e.g. `numpy.load` with allow_pickle would reopen the door to arbitrary
#: code execution via a second attacker-written file.
_SAFE_SYMBOLS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE_SYMBOLS or \
                (module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"snapshot references forbidden symbol {module}.{name}; "
            "checkpoints may only contain numpy arrays in builtin containers")


def _to_host(obj: Any) -> Any:
    """Copy tensors (and anything else with a shape) in a dict/list/tuple
    tree to host numpy arrays."""
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if hasattr(obj, "detach"):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "shape"):
        return np.asarray(obj)
    return obj


def _safe_load(f) -> Any:
    return _RestrictedUnpickler(f).load()


def _tag(fingerprint: Optional[str]) -> Optional[str]:
    """8-hex-char filename tag for a run fingerprint (hashed, so any
    string works, not just hexdigests)."""
    if fingerprint is None:
        return None
    import hashlib

    return hashlib.blake2b(fingerprint.encode(),
                           digest_size=4).hexdigest()


class Checkpointer:
    """Directory of step-numbered snapshots with atomic writes."""

    def __init__(self, directory: str, interval: int = 10,
                 keep: int = 2):
        self.directory = directory
        self.interval = max(int(interval), 1)
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, fingerprint: Optional[str] = None) -> str:
        t = _tag(fingerprint)
        return os.path.join(self.directory,
                            f"step_{step}{'.' + t if t else ''}.pkl")

    def _scan(self):
        """[(step, tag_or_None, filename)] for every snapshot present."""
        out = []
        for name in os.listdir(self.directory):
            m = _SNAP_RE.match(name)
            if m:
                out.append((int(m.group(1)), m.group(2), name))
        return out

    def due(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def scoped(self, name: str) -> "Checkpointer":
        """A sub-checkpointer under `<dir>/<name>` — one namespace per
        algorithm, so a multi-algorithm engine never resumes one
        algorithm's training from another's snapshots."""
        return Checkpointer(os.path.join(self.directory, name),
                            interval=self.interval, keep=self.keep)

    def save(self, step: int, state: Any,
             fingerprint: Optional[str] = None) -> None:
        """state: a tree of dict/list/tuple/ndarray/tensor/scalars;
        tensors are copied to the host. `fingerprint` ties the snapshot to the
        (hyperparams, dataset) that produced it — see `latest`."""
        host = _to_host(state)
        path = self._path(step, fingerprint)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"step": step, "state": host,
                         "fingerprint": fingerprint}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._gc(fingerprint)

    def latest(self, fingerprint: Optional[str] = None
               ) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest readable, compatible snapshot.

        Scans steps newest-first. Unreadable, malformed, or forbidden
        snapshots are skipped with a warning; so are snapshots of a
        DIFFERENT lineage: with a fingerprint given, only snapshots
        carrying that exact fingerprint match; with fingerprint=None only
        untagged snapshots match — a fingerprint-less caller never
        resumes from some other run's tagged state (and vice versa).
        A restarted run whose params or data changed retrains from
        scratch rather than resuming from incompatible state. Reads
        never delete: stale lineages are left for their own run (or
        `clear`) — per-lineage `_gc` means they cannot starve this run's
        snapshots either."""
        entries = sorted(self._scan(), reverse=True,
                         key=lambda e: (e[0], e[1] or "", e[2]))
        want_tag = _tag(fingerprint)
        for step, tag, name in entries:
            path = os.path.join(self.directory, name)
            if tag != want_tag:
                continue          # other lineage, by filename alone
            try:
                with open(path, "rb") as f:
                    snap = _safe_load(f)
                if not isinstance(snap, dict):
                    raise ValueError(f"snapshot is {type(snap).__name__}, "
                                     "expected dict")
                step_v, state = snap["step"], snap["state"]
                # algorithms index into the state dict; a loadable file
                # with a non-dict state must also degrade to skip, not
                # crash the caller
                if not isinstance(state, dict):
                    raise ValueError(
                        f"snapshot state is {type(state).__name__}, "
                        "expected dict")
            except Exception as e:
                # the writable-dir threat model again: ANY malformed file
                # must degrade to "skip + warn", never crash the training
                # process at resume
                logger.warning("checkpoint %s unreadable (%s) — skipping",
                               path, e)
                continue
            if snap.get("fingerprint") != fingerprint:
                logger.warning(
                    "checkpoint %s fingerprint mismatch (snapshot %s, "
                    "run %s) — ignoring, training from scratch",
                    path, snap.get("fingerprint"), fingerprint)
                continue
            return step_v, state
        return None

    def clear(self) -> None:
        """Remove all snapshots, including per-algorithm scoped subdirs."""
        for root, _dirs, files in os.walk(self.directory):
            for name in files:
                if _SNAP_RE.match(name) or name.endswith(".tmp"):
                    os.unlink(os.path.join(root, name))

    def _gc(self, fingerprint: Optional[str] = None) -> None:
        """Keep the newest `keep` snapshots OF THIS LINEAGE (same filename
        tag); other lineages' files are never touched, so a concurrent or
        restarted run with different params cannot destroy this run's
        resume state (nor vice versa)."""
        tag = _tag(fingerprint)
        mine = sorted((step, name) for step, t, name in self._scan()
                      if t == tag)
        for _step, name in mine[:-self.keep]:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass


def checkpointer_of(ctx) -> Optional[Checkpointer]:
    """The workflow-configured checkpointer of a WorkflowContext (None
    when checkpointing is off or ctx is a bare object)."""
    return getattr(ctx, "checkpointer", None)
