"""Shared log-structured-store substrate (the reference's
``storage/logstore.py``; the port's telemetry store rides it, and its
fsspec helpers take the filesystem as an argument).

Two crash-safe segment disciplines share these primitives:

1. **Checksummed record logs** (obs/tsdb.py's telemetry segments): every
   record is length-prefixed and crc32-checksummed, appends are
   torn-tail-safe (a reader only ever consumes whole records; recovery
   truncates at the first bad byte), and every multi-record rewrite is
   temp-write + ``os.replace`` (:func:`commit_file`).

2. **Manifest-committed fragment swaps** (storage/parquet_events.py's
   compaction, and the partitioned store's reshard): staging files are
   written under names no listing matches (:func:`fs_commit_stream`,
   :func:`fs_commit_bytes` keep the tmp in the same directory so the
   final ``fs.mv`` is a same-filesystem rename), a small JSON control
   file committed atomically is THE commit point, and listings retry
   through :func:`ls_retry` because fsspec's glob/find swallow the
   unlink race a concurrent finisher creates.

The chaos kill points stay with their owners (``tsdb:*`` in obs/tsdb.py)
: callers thread them through the ``kill_*`` hooks here so a kill lands
at the exact byte boundary the tests assert. Every durable write in this
module goes through the helpers below, and each writer performs its own
temp-write + rename commit.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import uuid
import zlib
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.storage.faults import maybe_kill

#: record header: payload byte length + crc32(payload)
HEADER = struct.Struct(">II")
#: reject absurd lengths when scanning a (possibly garbage) tail
MAX_RECORD_BYTES = 1 << 24

#: default attempts for ls_retry — unlink windows are microseconds, so
#: this is effectively "retry until the maintenance step finishes"
DEFAULT_LIST_RETRIES = 50


# ---------------------------------------------------------------------------
# checksummed record framing (the tsdb discipline)
# ---------------------------------------------------------------------------

def pack_record(payload: bytes) -> bytes:
    return HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def iter_record_payloads(raw: bytes) -> Iterator[bytes]:
    """Whole, checksum-clean record payloads from a segment's bytes.
    Stops silently at the first torn/garbage record — the crash-safety
    contract: a reader can never surface a partial record."""
    off, n = 0, len(raw)
    while off + HEADER.size <= n:
        length, crc = HEADER.unpack_from(raw, off)
        if length > MAX_RECORD_BYTES:
            return
        start = off + HEADER.size
        end = start + length
        if end > n:
            return
        payload = raw[start:end]
        if zlib.crc32(payload) != crc:
            return
        yield payload
        off = end


def scan_records(path: str, missing_ok: bool = True
                 ) -> Tuple[List[dict], int]:
    """All whole records of a segment plus the byte offset of the first
    torn/garbage byte (== file size when the tail is clean). Missing
    files read as empty (or raise with ``missing_ok=False`` — the
    reader's stale-listing retry needs the distinction)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        if not missing_ok:
            raise
        return [], 0
    records, clean = [], 0
    for payload in iter_record_payloads(raw):
        try:
            records.append(json.loads(payload))
        except ValueError:
            break
        clean += HEADER.size + len(payload)
    return records, clean


def encode_record(doc: dict) -> bytes:
    """One dict as a packed record (compact, key-sorted JSON — the
    canonical on-disk form both segment owners use)."""
    return pack_record(json.dumps(doc, separators=(",", ":"),
                                  sort_keys=True).encode())


# ---------------------------------------------------------------------------
# local-fs committed writes (os.replace flavor)
# ---------------------------------------------------------------------------

def commit_file(dirpath: str, final_name: str,
                records: Optional[Iterable[dict]] = None,
                raw: Optional[bytes] = None,
                kill_mid: Optional[str] = None,
                kill_pre_commit: Sequence[str] = ()) -> str:
    """THE local rewrite path: encode ``records`` (or write ``raw``
    bytes) into a temp file and ``os.replace`` it over ``final_name`` —
    a reader (or a crash) sees the whole new file or none of it.

    ``kill_mid`` fires after the FIRST record (a half-written rewrite),
    ``kill_pre_commit`` fire after the temp is complete but before the
    rename — the two crash windows the chaos suites pin."""
    final = os.path.join(dirpath, final_name)
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            if raw is not None:
                f.write(raw)
            else:
                for i, doc in enumerate(records):
                    f.write(encode_record(doc))
                    if i == 0 and kill_mid:
                        maybe_kill(kill_mid)
        if raw is None:
            for point in kill_pre_commit:
                maybe_kill(point)
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return final


def commit_json(dirpath: str, final_name: str, doc: dict,
                kill_pre_commit: Sequence[str] = ()) -> str:
    """Commit a small JSON control file (partition maps, claims) via
    temp-write + rename."""
    for point in kill_pre_commit:
        maybe_kill(point)
    return commit_file(dirpath, final_name,
                       raw=json.dumps(doc, sort_keys=True).encode())


def read_json(path: str) -> Optional[dict]:
    """A committed JSON control file, or None when missing/torn (a torn
    read is impossible for committed files, but a never-committed path
    reads as absent, which recovery treats the same way)."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# fsspec committed writes + safe listings (the parquet discipline)
# ---------------------------------------------------------------------------

def ls_retry(fs, path: str, retries: int = DEFAULT_LIST_RETRIES,
             error_cls: type = OSError) -> List[str]:
    """Raw directory listing, safe against concurrent maintenance.

    NOT fs.glob/fs.find: their directory walk swallows the listing race
    (an entry unlinked between scandir and its stat makes ls raise, and
    walk 'omits' the whole directory) and silently returns [] —
    indistinguishable from an empty store, so a reader concurrent with
    a finisher's unlinks would see zero rows with no error to retry on.
    fs.ls raises instead of swallowing; retry until a clean pass."""
    last: Optional[Exception] = None
    for _ in range(retries):
        try:
            return list(fs.ls(path, detail=False))
        except FileNotFoundError as ex:
            last = ex
    raise error_cls(
        f"listing {path} kept failing under concurrent maintenance: {last}")


@contextlib.contextmanager
def fs_commit_stream(fs, final_path: str):
    """Stream a staged file and commit it by rename: yields a writable
    handle on a ``tmp-*`` name in the SAME directory (no listing matches
    it; same-dir keeps the mv a same-filesystem rename), then ``fs.mv``s
    it over ``final_path`` on clean exit — a crash or error leaves only
    unreferenced tmp garbage, never a torn visible file."""
    d, _, _ = final_path.rpartition("/")
    tmp = f"{d}/tmp-{uuid.uuid4().hex}"
    try:
        with fs.open(tmp, "wb") as f:
            yield f
        fs.mv(tmp, final_path)
    except BaseException:
        try:
            if fs.exists(tmp):
                fs.rm(tmp)
        except OSError:
            pass
        raise


def fs_commit_bytes(fs, final_path: str, data: bytes) -> str:
    """Commit a small control file (manifest, generation marker,
    partition map) on an fsspec filesystem via staged-write + mv."""
    with fs_commit_stream(fs, final_path) as f:
        f.write(data)
    return final_path


def fs_read_json(fs, path: str) -> Optional[dict]:
    """A committed JSON control file on an fsspec filesystem, or None
    when missing (finished and removed) or unreadable (never
    committed — tmp names are invisible, so this only happens when the
    caller raced the finisher's removal)."""
    try:
        with fs.open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None
