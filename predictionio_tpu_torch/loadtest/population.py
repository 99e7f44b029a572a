"""Synthetic user population (port of the reference's
``loadtest/population.py``, equal to it draw for draw under one seed):
who sends traffic, and when.

Three deterministic-under-seed building blocks:

* :class:`ZipfSampler` — power-law popularity over a fixed catalog
  (items) or population (users): rank r drawn with probability
  proportional to ``r ** -alpha`` via one precomputed CDF +
  ``searchsorted`` (O(log n) per draw, O(n) memory once).
* :func:`diurnal_rate` / :func:`arrival_offsets` — an inhomogeneous
  Poisson arrival schedule whose intensity follows a sinusoidal
  day-curve, generated by thinning against the peak rate. The
  schedule is fixed up front (open-loop: arrivals never slow down
  because the system lags — that is the point of the discipline).
* :class:`Population` — per-user session state, created LAZILY on a
  user's first appearance so a million-user population costs memory
  only for the users the storm actually wakes: a ``view`` history
  ring, the last slate of recommendations served to them (feedback
  events reference it, closing the fold-in loop), and a monotone
  per-user event-time cursor.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import math
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from predictionio_tpu_torch.data.event import UTC, Event

__all__ = [
    "ZipfSampler",
    "diurnal_rate",
    "arrival_offsets",
    "SessionState",
    "Population",
]


class ZipfSampler:
    """Draw ranks in ``[0, n)`` with P(r) ∝ (r+1) ** -alpha.

    The CDF is precomputed once; each draw is a uniform + binary
    search, so a 10M-item catalog samples as fast as a 100-item one.
    Identical (n, alpha, seed) always reproduces the identical
    sequence — the distribution tests assert this exactly.
    """

    def __init__(self, n: int, alpha: float = 1.1, seed: int = 0):
        if n <= 0:
            raise ValueError(f"ZipfSampler needs n >= 1, got {n}")
        self.n = int(n)
        self.alpha = float(alpha)
        weights = np.arange(1, self.n + 1, dtype=np.float64) ** -self.alpha
        self._pmf = weights / weights.sum()
        self._cdf = np.cumsum(self._pmf)
        self._cdf[-1] = 1.0  # guard fp drift off the top bucket
        self._rng = np.random.default_rng(seed)

    def probability(self, rank: int) -> float:
        """Exact P(rank) — the distribution tests compare against it."""
        return float(self._pmf[rank])

    def sample(self, size: Optional[int] = None):
        """One rank (``size=None``) or an ndarray of ``size`` ranks."""
        u = self._rng.random(size)
        out = np.searchsorted(self._cdf, u, side="right")
        if size is None:
            return int(out)
        return out.astype(np.int64)


def diurnal_rate(t_s: float, base_rate: float, amplitude: float = 0.5,
                 period_s: float = 86400.0, phase_s: float = 0.0) -> float:
    """Instantaneous arrival intensity (events/s) at offset ``t_s``:
    a sinusoidal day-curve around ``base_rate``. ``amplitude`` in
    [0, 1] is the peak-to-mean swing; the floor is clamped at 0."""
    w = 2.0 * math.pi * (t_s + phase_s) / max(1e-9, period_s)
    return max(0.0, base_rate * (1.0 + amplitude * math.sin(w)))


def arrival_offsets(duration_s: float, base_rate: float,
                    amplitude: float = 0.5, period_s: float = 86400.0,
                    phase_s: float = 0.0, seed: int = 0) -> np.ndarray:
    """The open-loop arrival schedule: offsets (seconds from storm
    start) of an inhomogeneous Poisson process with the diurnal
    intensity, via Lewis-Shedler thinning against the peak rate.
    Deterministic under ``seed``; sorted ascending."""
    lam_max = base_rate * (1.0 + abs(amplitude))
    if lam_max <= 0 or duration_s <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    # draw candidate inter-arrivals in blocks to avoid a per-event
    # Python loop at million-event schedules
    out: List[np.ndarray] = []
    t = 0.0
    block = max(256, int(lam_max * duration_s * 1.2) + 16)
    while t < duration_s:
        gaps = rng.exponential(1.0 / lam_max, size=block)
        cand = t + np.cumsum(gaps)
        keep_u = rng.random(block)
        within = cand < duration_s
        if not within.any():
            # all candidates past the horizon: thin what's in range (none)
            break
        cand = cand[within]
        keep_u = keep_u[within]
        rates = np.array([
            diurnal_rate(c, base_rate, amplitude, period_s, phase_s)
            for c in cand]) if len(cand) < 4096 else _vector_rate(
                cand, base_rate, amplitude, period_s, phase_s)
        out.append(cand[keep_u * lam_max < rates])
        t = float(cand[-1]) if len(cand) else duration_s
        if len(cand) < block * 0.5 and t >= duration_s:
            break
    if not out:
        return np.empty(0, dtype=np.float64)
    offsets = np.concatenate(out)
    offsets.sort()
    return offsets


def _vector_rate(t: np.ndarray, base: float, amplitude: float,
                 period_s: float, phase_s: float) -> np.ndarray:
    w = 2.0 * np.pi * (t + phase_s) / max(1e-9, period_s)
    return np.maximum(0.0, base * (1.0 + amplitude * np.sin(w)))


@dataclasses.dataclass
class SessionState:
    """Per-user state, materialised on first appearance only."""

    user_id: str
    views: Deque[str] = dataclasses.field(
        default_factory=lambda: deque(maxlen=16))
    last_recs: List[str] = dataclasses.field(default_factory=list)
    events_sent: int = 0
    queries_sent: int = 0
    feedback_sent: int = 0
    #: per-user event-time cursor (seconds past the storm epoch) — event
    #: times stay monotone per user so training scans see a valid order
    clock_s: float = 0.0


class Population:
    """The synthetic user base. User activity AND item popularity are
    both Zipfian (heavy users exist, head items dominate) — the skew
    the fold-in and scoring layers must survive, not a uniform spray.

    Only users that actually emit traffic get a :class:`SessionState`
    (lazy dict), so ``size`` can be millions on a laptop: memory is
    O(active users), not O(population).
    """

    #: the storm's event-time epoch: a FIXED instant so two runs with
    #: one seed emit byte-identical event payloads
    EPOCH = dt.datetime(2026, 8, 1, tzinfo=UTC)

    def __init__(self, size: int, items: int, seed: int = 0,
                 item_alpha: float = 1.1, user_alpha: float = 0.9):
        self.size = int(size)
        self.items = int(items)
        self.seed = int(seed)
        self._users = ZipfSampler(size, alpha=user_alpha, seed=seed)
        self._items = ZipfSampler(items, alpha=item_alpha, seed=seed + 1)
        self._rng = np.random.default_rng(seed + 2)
        self._sessions: Dict[int, SessionState] = {}

    # -- accounting ----------------------------------------------------------
    @property
    def active_users(self) -> int:
        """Users that materialised state (appeared at least once)."""
        return len(self._sessions)

    def session(self, uid: int) -> SessionState:
        state = self._sessions.get(uid)
        if state is None:
            state = SessionState(user_id=f"u{uid}")
            self._sessions[uid] = state
        return state

    # -- traffic -------------------------------------------------------------
    def next_user(self) -> int:
        return self._users.sample()

    def event_for(self, uid: int, at_s: float) -> Event:
        """One behavioural event: a ``rate`` on a Zipf-sampled item
        (what training + fold-in consume), with a per-user monotone
        event time anchored at the storm epoch."""
        state = self.session(uid)
        item = int(self._items.sample())
        state.clock_s = max(state.clock_s + 1e-3, at_s)
        state.views.append(f"i{item}")
        state.events_sent += 1
        rating = float(self._rng.integers(1, 6))
        return Event(
            event="rate", entity_type="user", entity_id=state.user_id,
            target_entity_type="item", target_entity_id=f"i{item}",
            properties={"rating": rating},
            event_time=self.EPOCH + dt.timedelta(seconds=state.clock_s))

    def query_for(self, uid: int, num: int = 5) -> dict:
        state = self.session(uid)
        state.queries_sent += 1
        return {"user": state.user_id, "num": num}

    def record_recommendations(self, uid: int, item_ids: List[str]) -> None:
        """Remember the slate served to this user — the next feedback
        event references it, closing the serve -> feedback -> fold-in
        loop with REAL served items rather than random ones."""
        if item_ids:
            self.session(uid).last_recs = list(item_ids)[:16]

    def feedback_for(self, uid: int, at_s: float) -> Optional[Event]:
        """A positive signal on a previously-served item, or None when
        this user was never served a slate (nothing to react to)."""
        state = self.session(uid)
        if not state.last_recs:
            return None
        pick = state.last_recs[
            int(self._rng.integers(0, len(state.last_recs)))]
        state.clock_s = max(state.clock_s + 1e-3, at_s)
        state.feedback_sent += 1
        return Event(
            event="rate", entity_type="user", entity_id=state.user_id,
            target_entity_type="item", target_entity_id=str(pick),
            properties={"rating": 5.0, "feedback": True},
            event_time=self.EPOCH + dt.timedelta(seconds=state.clock_s))
