"""Post-run exactly-once audit (port of the reference's
``storage/audit.py``): event-id multiset parity between what an emitter
believes was acknowledged and what the store actually holds, partition
by partition.

The write path promises exactly-once: every acked submit is durably
present exactly once, across retries, commit-lane splits, compaction
crashes and recovery. The bench configs assert this with row COUNTS;
counts cannot see a compensating pair (one lost + one duplicated
event). This audit compares *identities*: the emitter's ledger of
acked event ids (WriteBuffer futures resolve to the ids assigned at
submit) against a full scan of the store — per partition when the
store is partitioned, so a duplicate that leaked ACROSS partitions
(a routing bug no single-partition check can see) is caught too.

Used by the loadtest simulator's chaos verdict and importable anywhere
a test wants identity-level parity instead of row counts.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["AuditReport", "audit_exactly_once"]

_SAMPLE = 20  # ids quoted in the human summary; full lists stay in the report


@dataclasses.dataclass
class AuditReport:
    """Multiset parity verdict. ``ok`` is strict: every ledger id found
    exactly as many times as acked (normally once), and nothing in the
    scanned scope the ledger never acked."""

    expected: int                     #: ledger ids (multiset size)
    found: int                        #: scanned events in scope
    missing: List[str]                #: acked but absent (one entry per lost copy)
    duplicates: List[str]             #: present MORE times than acked
    extras: List[str]                 #: present but never acked by the emitter
    partitions: Dict[int, int]        #: partition -> events scanned (-1 = unpartitioned)

    @property
    def ok(self) -> bool:
        return not self.missing and not self.duplicates and not self.extras

    def summary(self) -> str:
        if self.ok:
            parts = ", ".join(
                f"p{k}={v}" for k, v in sorted(self.partitions.items()))
            return (f"exactly-once OK: {self.found}/{self.expected} acked "
                    f"events present once each ({parts})")
        bits = []
        for label, ids in (("missing", self.missing),
                           ("duplicated", self.duplicates),
                           ("extra", self.extras)):
            if ids:
                shown = ", ".join(ids[:_SAMPLE])
                more = f" (+{len(ids) - _SAMPLE} more)" \
                    if len(ids) > _SAMPLE else ""
                bits.append(f"{len(ids)} {label}: {shown}{more}")
        return (f"exactly-once VIOLATED ({self.found} found vs "
                f"{self.expected} acked): " + "; ".join(bits))

    def as_dict(self) -> dict:
        return {
            "ok": self.ok, "expected": self.expected, "found": self.found,
            "missing": len(self.missing), "duplicates": len(self.duplicates),
            "extras": len(self.extras),
            "partitions": {str(k): v for k, v in self.partitions.items()},
            "summary": self.summary(),
        }


def _scan_counts(store, app_id: int,
                 channel_id: Optional[int]) -> Tuple[Counter, Dict[int, int]]:
    """Per-event-id occurrence counts across the WHOLE store. For a
    PartitionedEvents store every partition is scanned separately (its
    own backend store), so cross-partition duplicates are visible;
    plain stores scan as pseudo-partition -1."""
    from predictionio_tpu_torch.storage.partitioned import PartitionedEvents

    counts: Counter = Counter()
    per_partition: Dict[int, int] = {}
    if isinstance(store, PartitionedEvents):
        for k in range(store.partition_count):
            n = 0
            for ev in store.partition_store(k).find(
                    app_id, channel_id=channel_id):
                counts[ev.event_id] += 1
                n += 1
            per_partition[k] = n
    else:
        n = 0
        for ev in store.find(app_id, channel_id=channel_id):
            counts[ev.event_id] += 1
            n += 1
        per_partition[-1] = n
    return counts, per_partition


def audit_exactly_once(store, app_id: int, ledger_ids: Iterable[str],
                       channel_id: Optional[int] = None) -> AuditReport:
    """Compare the emitter's acked-id ledger against a full store scan.

    ``ledger_ids`` is a multiset (an emitter that acked the same id
    twice EXPECTS two copies — WriteBuffer never does, so a repeat in
    the ledger usually surfaces as a duplicate here, which is the
    point). Ids in the store that the ledger never acked are
    ``extras`` — scope the audit's app/channel to the emitter's own
    traffic so unrelated writers don't false-positive."""
    expected = Counter(str(i) for i in ledger_ids)
    counts, per_partition = _scan_counts(store, app_id, channel_id)
    missing: List[str] = []
    duplicates: List[str] = []
    extras: List[str] = []
    for event_id, want in expected.items():
        have = counts.get(event_id, 0)
        if have < want:
            missing.extend([event_id] * (want - have))
        elif have > want:
            duplicates.append(event_id)
    for event_id in counts:
        if event_id not in expected:
            extras.append(event_id)
    missing.sort()
    duplicates.sort()
    extras.sort()
    return AuditReport(
        expected=sum(expected.values()), found=sum(counts.values()),
        missing=missing, duplicates=duplicates, extras=extras,
        partitions=per_partition)
