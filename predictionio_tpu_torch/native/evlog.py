"""evlog codec: ctypes bindings for ``csrc/evlog.cc`` with a pure-Python
twin (port of the reference's ``native/evlog.py``).

File format (``csrc/evlog.cc`` has the authoritative description; the
reference's files, byte for byte):

  header : magic ``PIOEVLG1`` | u32 version=1 | u32 reserved   (16 bytes)
  record : u32 payload_len | u32 crc32 | i64 time_ms | u64 entity_hash
         | u8 flags (bit0 = tombstone) | 16-byte event id | payload
  crc32 (zlib polynomial) covers time_ms..payload, little-endian throughout.

The library is built from ``csrc/evlog.cc`` alone on first use (``g++ -O2
-fPIC -shared -std=c++17``) into ``build/torch_kernels/`` at the root of
the checkout, named by a digest of the source and the flags as the CUDA
kernels' libraries are, compiled to a temporary name and moved into place
with ``os.replace``: processes that start at once never load a
half-written library. ``PIO_EVLOG_CODEC`` (or a source's ``CODEC``) picks
``native``, ``python`` or ``auto``; ``auto`` falls back to
:class:`PyCodec` where the build fails (the compiler's output logged as
a warning), ``native`` raises. The two codecs write identical files and
read each other's.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pathlib
import struct
import subprocess
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("pio.torch.evlog")

MAGIC = b"PIOEVLG1"
VERSION = 1
HEADER = MAGIC + struct.pack("<II", VERSION, 0)
_REC_HEAD = struct.Struct("<IIqQB16s")   # len, crc, time_ms, hash, flags, id
REC_HEAD_SIZE = _REC_HEAD.size           # 41
TOMBSTONE = 1

T_MIN = -(2 ** 63)
T_MAX = 2 ** 63 - 1

#: record tuple: (time_ms, entity_hash, flags, id bytes[16], payload bytes)
Record = Tuple[int, int, int, bytes, bytes]

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "evlog.cc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "torch_kernels")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def entity_hash(entity_type: str, entity_id: str) -> int:
    """FNV-1a 64 of 'entityType\\0entityId': ``evlog_entity_hash``'s
    value (the evlog analog of HBase's rowkey entity prefix,
    HBEventsUtil.scala:76-131)."""
    h = 1469598103934665603
    for b in entity_type.encode() + b"\x00" + entity_id.encode():
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h or 1   # 0 is the "no filter" sentinel


class EvlogError(Exception):
    pass


def unpack_records(buf: bytes) -> List[Record]:
    """Records in the on-disk format (no file header) as tuples; a
    truncated last record is dropped."""
    out: List[Record] = []
    off = 0
    n = len(buf)
    while off + REC_HEAD_SIZE <= n:
        plen, _crc, t, h, flags, rid = _REC_HEAD.unpack_from(buf, off)
        start = off + REC_HEAD_SIZE
        if start + plen > n:
            break
        out.append((t, h, flags, rid, buf[start:start + plen]))
        off = start + plen
    return out


def _read_log(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(HEADER) or data[:8] != MAGIC:
        raise EvlogError(f"{path}: bad evlog header")
    return data


class PyCodec:
    """Pure-Python implementation of the evlog format (the plain version
    of the native codec)."""

    name = "python"

    @staticmethod
    def pack_record(time_ms: int, ehash: int, flags: int, rid: bytes,
                    payload: bytes) -> bytes:
        body = struct.pack("<qQB16s", time_ms, ehash, flags, rid) + payload
        return struct.pack("<II", len(payload), zlib.crc32(body)) + body

    def create(self, path: str) -> None:
        try:
            with open(path, "xb") as f:
                f.write(HEADER)
        except FileExistsError:
            pass   # idempotent, like the native codec's EEXIST -> ok

    def append(self, path: str, records: List[Record]) -> None:
        buf = b"".join(self.pack_record(*r) for r in records)
        # O_APPEND without O_CREAT: an append never creates a header-less
        # file. flock serializes writer processes, so the torn-write
        # cleanup below can truncate: no other record lands meanwhile.
        try:
            fd = os.open(path, os.O_WRONLY | os.O_APPEND)
        except FileNotFoundError as ex:
            raise EvlogError(f"{path}: no such evlog") from ex
        written = 0
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            while written < len(buf):
                written += os.write(fd, buf[written:])
        except OSError:
            # torn write (e.g. ENOSPC): drop the half-frame so later
            # appends do not land after it and desync the framing
            try:
                if written:
                    os.ftruncate(fd, os.lseek(fd, 0, os.SEEK_CUR) - written)
            except OSError:
                pass
            raise
        finally:
            os.close(fd)     # releases the flock

    def scan(self, path: str, t_lo: int = T_MIN, t_hi: int = T_MAX,
             ehash: int = 0, rid: Optional[bytes] = None) -> List[Record]:
        data = _read_log(path)
        out: List[Record] = []
        off = len(HEADER)
        n = len(data)
        while off + REC_HEAD_SIZE <= n:
            plen, crc, t, h, flags, r = _REC_HEAD.unpack_from(data, off)
            start = off + REC_HEAD_SIZE
            if start + plen > n:
                break   # truncated tail write: stop cleanly
            if (t_lo <= t < t_hi and (ehash == 0 or h == ehash)
                    and (rid is None or r == rid)):
                if zlib.crc32(data[off + 8:start + plen]) != crc:
                    raise EvlogError(f"{path}: CRC mismatch at offset {off}")
                out.append((t, h, flags, r, data[start:start + plen]))
            off = start + plen
        return out

    def verify(self, path: str) -> int:
        data = _read_log(path)
        count = 0
        off = len(HEADER)
        n = len(data)
        while off + REC_HEAD_SIZE <= n:
            plen, crc, *_ = _REC_HEAD.unpack_from(data, off)
            start = off + REC_HEAD_SIZE
            if start + plen > n:
                raise EvlogError(f"{path}: truncated record at {off}")
            if zlib.crc32(data[off + 8:start + plen]) != crc:
                raise EvlogError(f"{path}: CRC mismatch at offset {off}")
            count += 1
            off = start + plen
        return count


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class EvlogCodec:
    """ctypes bindings over the library built from ``csrc/evlog.cc``."""

    name = "native"

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.evlog_create.restype = ctypes.c_int64
        lib.evlog_create.argtypes = [ctypes.c_char_p]
        lib.evlog_append.restype = ctypes.c_int64
        lib.evlog_append.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64), u8p, ctypes.c_char_p,
            ctypes.c_uint32]
        lib.evlog_scan.restype = ctypes.c_int64
        lib.evlog_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.evlog_verify.restype = ctypes.c_int64
        lib.evlog_verify.argtypes = [ctypes.c_char_p]
        lib.evlog_free.restype = None
        lib.evlog_free.argtypes = [u8p]
        lib.evlog_entity_hash.restype = ctypes.c_uint64
        lib.evlog_entity_hash.argtypes = [ctypes.c_char_p, ctypes.c_uint64]

    def create(self, path: str) -> None:
        rc = self._lib.evlog_create(path.encode())
        if rc < 0:
            raise EvlogError(f"evlog_create({path}) failed: errno {-rc}")

    def append(self, path: str, records: List[Record]) -> None:
        n = len(records)
        if n >= 1 << 32:
            raise EvlogError(f"evlog_append: {n} records in one call")
        rids = [r[3] for r in records]
        if any(len(r) != 16 for r in rids):
            raise EvlogError("evlog_append: every record id is 16 bytes")
        payloads = b"".join(r[4] for r in records)
        # the arrays outlive the call: the library reads them in place
        lens = np.fromiter((len(r[4]) for r in records), np.uint32, n)
        times = np.fromiter((r[0] for r in records), np.int64, n)
        hashes = np.fromiter((r[1] for r in records), np.uint64, n)
        flags = np.fromiter((r[2] for r in records), np.uint8, n)
        rc = self._lib.evlog_append(
            path.encode(), payloads, _ptr(lens, ctypes.c_uint32),
            _ptr(times, ctypes.c_int64), _ptr(hashes, ctypes.c_uint64),
            _ptr(flags, ctypes.c_uint8), b"".join(rids), n)
        if rc < 0:
            raise EvlogError(f"evlog_append({path}) failed: errno {-rc}")

    def scan(self, path: str, t_lo: int = T_MIN, t_hi: int = T_MAX,
             ehash: int = 0, rid: Optional[bytes] = None) -> List[Record]:
        if rid is not None and len(rid) != 16:
            raise EvlogError("evlog_scan: a record id is 16 bytes")
        out_buf = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.evlog_scan(path.encode(), t_lo, t_hi, ehash, rid,
                                  ctypes.byref(out_buf),
                                  ctypes.byref(out_len))
        if rc < 0:
            raise EvlogError(f"evlog_scan({path}) failed: errno {-rc}")
        try:
            data = ctypes.string_at(out_buf, out_len.value) if rc else b""
        finally:
            if out_buf:
                self._lib.evlog_free(out_buf)
        return unpack_records(data)

    def verify(self, path: str) -> int:
        rc = self._lib.evlog_verify(path.encode())
        if rc < 0:
            raise EvlogError(f"evlog_verify({path}) failed: errno {-rc}")
        return int(rc)


_lock = threading.Lock()
#: the loaded native codec of this process (one dlopen)
_native: Optional[EvlogCodec] = None


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libevlog-{digest}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/evlog.cc`` unless its library is there; returns the
    library's path. Raises :class:`EvlogError` with the compiler's output
    when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as ex:
        raise EvlogError(f"g++ could not build {SOURCE}: {ex}") from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise EvlogError(f"g++ failed for {SOURCE} (rc {proc.returncode}):"
                         f"\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a reader never sees half a file
    return out


def _load_native() -> EvlogCodec:
    global _native
    with _lock:
        if _native is None:
            path = build()
            try:
                _native = EvlogCodec(ctypes.CDLL(str(path)))
            except OSError as ex:
                raise EvlogError(f"cannot load {path}: {ex}") from ex
        return _native


def get_codec(force: Optional[str] = None):
    """The codec: ``force`` (a source's ``CODEC``), else
    ``PIO_EVLOG_CODEC``, else ``auto`` — ``native`` builds and loads the
    library or raises, ``python`` is :class:`PyCodec`, ``auto`` is the
    native codec where it builds and :class:`PyCodec` otherwise (with a
    warning that carries the compiler's output)."""
    mode = force or os.environ.get("PIO_EVLOG_CODEC", "auto")
    if mode == "python":
        return PyCodec()
    try:
        return _load_native()
    except EvlogError as ex:
        if mode == "native":
            raise
        log.warning("native evlog codec unavailable, using the Python "
                    "codec: %s", ex)
        return PyCodec()
