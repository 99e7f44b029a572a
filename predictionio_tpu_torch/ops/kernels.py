"""Build, binding and launch counts of the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library under ``build/torch_kernels/`` at the
root of the checkout, named by a hash of its source so an edited kernel
rebuilds, and bound through ``ctypes`` to its plain C entry point. All
sources build at once, one ``nvcc`` each, started together.

Nothing here runs at import: the CPU tests import this module on a
machine with no ``nvcc`` and no card.

Launch counts are plain integers that a wrapper raises by one where it
launches its kernel, and nowhere else: a run can show that its main path
went through the kernel (``chip_smoke.py`` zeroes them, drives the path
and reads them back).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

#: shortlist kernel launches in this process (csrc/shortlist.cu)
SHORTLIST_LAUNCHES = 0
#: batched SPD solve kernel launches in this process (csrc/spd_solve.cu)
SPD_SOLVE_LAUNCHES = 0

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: largest tile the shortlist kernel takes: a candidate's id within its
#: tile is kept in 15 bits of the kernel's 47-bit select key
SHORTLIST_MAX_TILE = 32768
#: the shortlist kernel's CTA size (csrc/shortlist.cu kThreads)
SHORTLIST_THREADS = 256
#: items of a tile staged into shared memory at a time: two a thread, or
#: one a thread when two would not fit beside the rest, then fewer (large
#: R); past 16, stages of 256 items hold a chunk of each row's bytes
SHORTLIST_STAGE_ITEMS = (512, 256, 128, 64, 32, 16)
#: the finishes for c <= 16: per-thread register top-C lists (C = 2, 4,
#: 8; C * rows <= 32), and a queue a row in shared memory (C = 16, for
#: 8 < c <= 16); above 16 every score of a CTA's slice is kept as a key
#: (C = 0)
SHORTLIST_LIST_SIZES = (2, 4, 8, 16)
#: the list size that runs as a queue, and its slack past a stage's items
SHORTLIST_QUEUE = 16
_QUEUE_SLACK = 64
#: rows of a query group (one tile read feeds all of them)
SHORTLIST_MAX_ROWS = 8
#: the scan rank whose product runs on the tensor cores (TF32 mma, u in
#: hi and lo halves) for groups of 8 rows and c <= 4
SHORTLIST_TC_RANK = 32
#: CTAs a tile may be spread over: the portable thread block cluster size
SHORTLIST_MAX_CLUSTER = 8
#: a CTA's slice is at least this many items before a tile is split more
SHORTLIST_MIN_SLICE = 256
#: split tiles over a cluster until the grid holds this many CTA-rows
#: (CTAs times the rows each scores; eight per SM of the H100's 132)
SHORTLIST_MIN_CTAS = 8 * 132
#: shared memory one CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
_SHORTLIST_BINS = 256
#: cudaErrorInvalidValue: the shortlist entry point's answer to a plan it
#: does not take
_CUDA_ERROR_INVALID_VALUE = 1
_ROWSEL_BYTES = 24
#: largest system the SPD solve kernel takes (a lane of its warp keeps
#: two columns of L in registers; the reference's ``_PALLAS_MAX_K``)
SPD_SOLVE_MAX_K = 64

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: guards the launch counts (never held across a build)
_COUNT_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel could not be built or launched, or refused
    the plan it was given."""


def reset_counts() -> None:
    """Zero every launch count."""
    global SHORTLIST_LAUNCHES, SPD_SOLVE_LAUNCHES
    with _COUNT_LOCK:
        SHORTLIST_LAUNCHES = 0
        SPD_SOLVE_LAUNCHES = 0


def counts() -> Dict[str, int]:
    """Every launch count, read together (a fold-in apply launches from
    the deploy thread while queries launch from the predict pool)."""
    with _COUNT_LOCK:
        return {"shortlist": SHORTLIST_LAUNCHES,
                "spd_solve": SPD_SOLVE_LAUNCHES}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: nvcc output}``
    for the sources built now (ptxas register/shared-memory report
    included). Raises ``KernelError`` if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((src, out, tmp, proc))
    logs, failed = {}, []
    for src, out, tmp, proc in pending:
        log, _ = proc.communicate()
        logs[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(CSRC / f"{name}.cu")
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _LIBS[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pio_cuda_error_string.argtypes = [i]
    lib.pio_cuda_error_string.restype = ctypes.c_char_p
    if name == "shortlist":
        lib.pio_shortlist_topc.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, i,
                                           i, i, i, i, i, i, i,
                                           ctypes.c_longlong, p]
        lib.pio_shortlist_topc.restype = i
        lib.pio_shortlist_smem_bytes.argtypes = [i, i, i, i, i, i, i, i, i,
                                                 i]
        lib.pio_shortlist_smem_bytes.restype = ctypes.c_longlong
    elif name == "spd_solve":
        lib.pio_spd_solve.argtypes = [p, p, p, p, i, i, ctypes.c_float, p]
        lib.pio_spd_solve.restype = i
        lib.pio_spd_solve_thread_max_k.argtypes = []
        lib.pio_spd_solve_thread_max_k.restype = i


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pio_cuda_error_string(err).decode()
        raise KernelError(f"{what} launch failed: CUDA error {err} ({msg})")


#: words of torch's messages for a fault of the card or its libraries
_DEVICE_WORDS = ("CUDA", "cuBLAS", "CUBLAS", "cuDNN", "CUDNN", "NCCL")


def is_device_error(exc: Optional[BaseException]) -> bool:
    """True when ``exc``, or an exception it was raised from or during,
    is a fault of the card or of a kernel wrapper: a ``KernelError``,
    anything raised inside this module (a wrapper refusing its inputs),
    torch's out-of-memory and accelerator errors, or a ``RuntimeError``
    naming CUDA or one of its libraries. Callers that isolate one
    query's faults (``workflow/batch_predict``) let these propagate."""
    accel = getattr(torch, "AcceleratorError", None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError)):
            return True
        if accel is not None and isinstance(exc, accel):
            return True
        if isinstance(exc, RuntimeError) and any(
                w in str(exc) for w in _DEVICE_WORDS):
            return True
        tb = exc.__traceback__
        while tb is not None:
            if tb.tb_frame.f_code.co_filename == __file__:
                return True
            tb = tb.tb_next
        exc = exc.__cause__ or exc.__context__
    return False


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
             device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def shortlist_smem_bytes(list_size: int, rows: int, cluster: int, tile: int,
                         rank: int, cand: int, stage_items: int,
                         sort_smem: bool, masked: bool = False,
                         chunk: Optional[int] = None) -> int:
    """Dynamic shared memory of one shortlist CTA, laid out as
    ``make_layout`` in csrc/shortlist.cu lays it out (the kernel's entry
    point recomputes it and refuses a plan that disagrees): the group's
    query rows; the slice's keys when every score is kept (``list_size``
    0), else rank 0's lists of every CTA's top C (written by the other
    CTAs while this one may still be scoring); for the queue (C = 16) each
    row's queue, floor and three rounds of append counts; then, over the same bytes, either the
    ring of three stages (``stage_items`` items' bytes, ``chunk`` of each
    row, default all ``rank``; their scales; when ``masked``, each row's
    mask bytes; and with rows in chunks, u's chunk of each query row in
    place of the resident u) or what the finish needs once scoring is done: with
    per-thread lists, the warps' top-C lists of each row; with every key
    kept, two histograms of 256 bins a row, the row states, three
    counters a row and, when ``sort_smem``, the owner's sort buffers."""
    chunk = rank if chunk is None else chunk
    r4 = (rank + 3) // 4 * 4
    slice_ = ((-(-tile // cluster)) + 15) // 16 * 16
    owned = -(-rows // cluster)
    cpad = _pow2_at_least(cand)
    chunked = chunk < rank
    off = 0 if chunked else _align16(4 * r4 * rows)   # u, unless staged
    if list_size == 0:
        off += _align16(4 * rows * slice_)
    else:   # rank 0's lists of every CTA's top C, outside the stages
        off += _align16(8 * rows * cluster * list_size)
    if list_size == SHORTLIST_QUEUE:   # the queues, floors and counts
        off += (_align16(8 * rows * (stage_items + _QUEUE_SLACK))
                + _align16(8 * rows) + _align16(12 * rows))
    stage = (_align16(stage_items * chunk + 16) + 4 * stage_items
             + (rows * stage_items if masked else 0)
             + (4 * chunk * rows if chunked else 0))
    stage_end = off + 3 * stage
    if list_size == SHORTLIST_QUEUE:
        return stage_end
    p = off
    if list_size > 0:   # the warps' top-C lists
        p += _align16(8 * rows * (SHORTLIST_THREADS // 32) * list_size)
        return max(stage_end, p)
    p += 2 * rows * _SHORTLIST_BINS * 4
    p += _align16(_ROWSEL_BYTES * rows)
    p += _align16(12 * rows)
    if sort_smem:
        p += 8 * owned * cpad
    return max(stage_end, p)


@dataclass(frozen=True)
class ShortlistPlan:
    """How one shortlist call (with or without a mask: ``masked``) is cut
    up: a cluster of ``cluster`` CTAs per (tile, group of ``rows`` query
    rows), each CTA scoring a slice of ``slice_items`` items,
    ``stage_items`` at a time and ``chunk`` bytes of each item's row a
    stage (all of it unless the rows are too long); ``list_size`` the
    finish (0: every score kept; 16: a queue a row; else per-thread
    top-C lists); the winners sorted in shared memory or, when
    ``sort_smem`` is False, in a global scratch buffer."""

    masked: bool
    list_size: int
    rows: int
    cluster: int
    stage_items: int
    chunk: int
    sort_smem: bool
    smem_bytes: int
    groups: int
    ctas: int
    slice_items: int
    tensor_cores: bool

    def as_dict(self) -> Dict[str, int]:
        return {"masked": self.masked, "C": self.list_size, "rows": self.rows,
                "cluster": self.cluster, "stage_items": self.stage_items,
                "chunk": self.chunk, "sort_smem": self.sort_smem,
                "smem_bytes": self.smem_bytes, "groups": self.groups,
                "ctas": self.ctas, "slice_items": self.slice_items,
                "tensor_cores": self.tensor_cores}


def shortlist_max_rows(list_size: int) -> int:
    """Rows a query group may have under a finish: 8, or 32 / C (at most
    8) for the per-thread lists."""
    if list_size in (0, SHORTLIST_QUEUE):
        return SHORTLIST_MAX_ROWS
    return min(SHORTLIST_MAX_ROWS, 32 // list_size)


def make_shortlist_plan(b: int, nt: int, tile: int, rank: int, cand: int,
                        masked: bool, list_size: int, rows: int,
                        cluster: int, stage_items: int, chunk: int,
                        sort_smem: bool) -> ShortlistPlan:
    """The plan of those parts, its shared memory and grid filled in."""
    groups = -(-b // rows)
    return ShortlistPlan(
        masked, list_size, rows, cluster, stage_items, chunk, sort_smem,
        shortlist_smem_bytes(list_size, rows, cluster, tile, rank, cand,
                             stage_items, sort_smem, masked, chunk),
        groups, cluster * nt * groups, ((-(-tile // cluster)) + 15) // 16 * 16,
        list_size in (2, 4) and rows == 8 and rank == SHORTLIST_TC_RANK
        and chunk == rank)


@functools.lru_cache(maxsize=4096)
def shortlist_plan(b: int, nt: int, tile: int, rank: int, cand: int,
                   masked: bool = False) -> ShortlistPlan:
    """The launch plan of a shortlist call. List size: the smallest of
    ``SHORTLIST_LIST_SIZES`` at or above c, else 0 (every score kept).
    Rows per group: B rounded up to a power of two, at most
    :func:`shortlist_max_rows`. Cluster: doubled while CTAs times rows is
    under ``SHORTLIST_MIN_CTAS`` (a row of a group is about one CTA's
    worth of work) and a slice keeps at least ``SHORTLIST_MIN_SLICE``
    items, up to 8. The sort runs in shared memory where it fits, else in
    scratch; rows are cut, then the stage to one item a thread, until the
    CTA fits in ``SMEM_LIMIT``. Where that finds nothing (a long row, or
    a large slice of kept keys), rows, then clusters up to 8, then stages
    down to 16 items, then stages of 256 items holding a chunk of each
    row (a multiple of 16 bytes) and u's chunk, so every R fits."""
    c = next((x for x in SHORTLIST_LIST_SIZES if cand <= x), 0)
    first = min(_pow2_at_least(b), shortlist_max_rows(c))

    def fits(br, g, stage, chunk, sort_smem):
        plan = make_shortlist_plan(b, nt, tile, rank, cand, masked, c, br, g,
                                   stage, chunk, sort_smem)
        return plan if plan.smem_bytes <= SMEM_LIMIT else None

    def spread(br):
        groups, g = -(-b // br), 1
        while (g < SHORTLIST_MAX_CLUSTER
               and groups * nt * g * br < SHORTLIST_MIN_CTAS
               and -(-tile // (2 * g)) >= SHORTLIST_MIN_SLICE):
            g *= 2
        return g

    def row_counts():
        br = first
        while br >= 1:
            yield br
            br //= 2

    for sort_smem in (True, False):   # the plans of the common shapes
        for br in row_counts():
            for stage in SHORTLIST_STAGE_ITEMS[:2]:
                plan = fits(br, spread(br), stage, rank, sort_smem)
                if plan:
                    return plan
    chunks = [x for x in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16)
              if x < rank]
    for sort_smem in (True, False):
        for br in row_counts():
            g = spread(br)
            while g <= SHORTLIST_MAX_CLUSTER:
                for stage in SHORTLIST_STAGE_ITEMS:
                    plan = fits(br, g, stage, rank, sort_smem)
                    if plan:
                        return plan
                for chunk in chunks:
                    plan = fits(br, g, SHORTLIST_THREADS, chunk, sort_smem)
                    if plan:
                        return plan
                g *= 2
    raise ValueError(f"no shortlist plan fits {SMEM_LIMIT} bytes of shared "
                     f"memory: B={b} T={tile} R={rank} c={cand}")


def shortlist_topc_cuda(u: torch.Tensor, tiles: torch.Tensor,
                        scales: torch.Tensor, n_items: int,
                        mask: Optional[torch.Tensor], cand: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/shortlist.cu on CUDA tensors: ``u [B,R] f32``,
    ``tiles [nt,T,R] int8``, ``scales [nt,T] f32``, ``mask [B,nt*T]
    bool`` or None -> ``(vals [B,nt*cand] f32, ids [B,nt*cand] i32)``,
    under :func:`shortlist_plan`. One CUDA launch. Runs on the current
    stream and does not synchronise."""
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"shortlist kernel needs CUDA tensors, got {dev}")
    _require(u, "u", torch.float32, 2, dev)
    _require(tiles, "tiles", torch.int8, 3, dev)
    _require(scales, "scales", torch.float32, 2, dev)
    b, r = u.shape
    nt, t, r2 = tiles.shape
    if r2 != r or tuple(scales.shape) != (nt, t):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, tiles "
                         f"{tuple(tiles.shape)}, scales {tuple(scales.shape)}")
    if not 1 <= t <= SHORTLIST_MAX_TILE:
        raise ValueError(f"tile {t} outside [1, {SHORTLIST_MAX_TILE}]")
    if not 1 <= cand <= t:
        raise ValueError(f"cand {cand} outside [1, tile={t}]")
    if b < 1 or nt < 1 or r < 1:
        raise ValueError(f"empty input: B={b} nt={nt} R={r}")
    if nt * t >= 2 ** 31 or b * nt * cand >= 2 ** 31:
        raise ValueError("catalog too large for 32-bit item ids")
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned")
    if mask is not None:
        _require(mask, "mask", torch.bool, 2, dev)
        if tuple(mask.shape) != (b, nt * t):
            raise ValueError(f"mask shape {tuple(mask.shape)} != "
                             f"{(b, nt * t)}")
    plan = shortlist_plan(b, nt, t, r, cand, mask is not None)
    return _shortlist_launch(plan, u, tiles, scales, n_items, mask, cand)


def _shortlist_launch(plan: ShortlistPlan, u: torch.Tensor,
                      tiles: torch.Tensor, scales: torch.Tensor,
                      n_items: int, mask: Optional[torch.Tensor], cand: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel under ``plan`` on inputs already checked
    (the card tests call it with plans of their own)."""
    global SHORTLIST_LAUNCHES
    dev = u.device
    b, r = u.shape
    nt, t, _ = tiles.shape
    lib = _lib("shortlist")
    vals = torch.empty((b, nt * cand), dtype=torch.float32, device=dev)
    ids = torch.empty((b, nt * cand), dtype=torch.int32, device=dev)
    scratch = None
    if not plan.sort_smem:
        scratch = torch.empty((b, nt, _pow2_at_least(cand)),
                              dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pio_shortlist_topc(
            u.data_ptr(), tiles.data_ptr(), scales.data_ptr(),
            None if mask is None else mask.data_ptr(),
            vals.data_ptr(), ids.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, nt, t, r, int(n_items), int(cand), plan.list_size,
            plan.rows, plan.cluster, plan.stage_items, plan.chunk,
            int(plan.sort_smem), int(plan.tensor_cores), plan.smem_bytes,
            stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise KernelError(
            f"shortlist kernel refused plan {plan} for B={b} nt={nt} T={t} "
            f"R={r} c={cand} (a plan it does not take, or shared memory "
            f"laid out otherwise than the host's formula)")
    _check(lib, err, "shortlist")
    with _COUNT_LOCK:
        SHORTLIST_LAUNCHES += 1
    return vals, ids


def spd_solve_thread_max_k() -> int:
    """The largest K the SPD solve kernel solves one system per thread;
    above it, one warp per system. Read from the built library, which
    owns the choice (builds it if needed)."""
    return int(_lib("spd_solve").pio_spd_solve_thread_max_k())


def spd_solve_cuda(A: torch.Tensor, b: torch.Tensor,
                   diag: Optional[torch.Tensor] = None,
                   jitter: float = 0.0) -> torch.Tensor:
    """Launch csrc/spd_solve.cu on CUDA tensors: ``A [S,K,K] f32``,
    ``b [S,K] f32``, ``diag [S] f32`` or None -> ``x [S,K] f32`` with
    ``(A[s] + diag[s] I + jitter I) x[s] = b[s]``, for 1 <= K <= 64. The
    kernel adds both terms to the diagonal as it loads A, in that order,
    and reads only A's lower triangle; A is not written. Runs on the
    current stream and does not synchronise."""
    global SPD_SOLVE_LAUNCHES
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"spd_solve kernel needs CUDA tensors, got {dev}")
    _require(A, "A", torch.float32, 3, dev)
    _require(b, "b", torch.float32, 2, dev)
    s, k, k2 = A.shape
    if k2 != k or tuple(b.shape) != (s, k):
        raise ValueError(f"shape mismatch: A {tuple(A.shape)}, b "
                         f"{tuple(b.shape)}")
    if not 1 <= k <= SPD_SOLVE_MAX_K:
        raise ValueError(f"K={k} outside [1, {SPD_SOLVE_MAX_K}]")
    if s < 1:
        raise ValueError("empty input: S=0")
    if s >= 2 ** 31:
        raise ValueError(f"S={s} too large for the kernel's 32-bit count")
    diag_ptr = None
    if diag is not None:
        _require(diag, "diag", torch.float32, 1, dev)
        if diag.shape[0] != s:
            raise ValueError(f"diag shape {tuple(diag.shape)} != {(s,)}")
        diag_ptr = diag.data_ptr()
    lib = _lib("spd_solve")
    x = torch.empty((s, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pio_spd_solve(A.data_ptr(), b.data_ptr(), diag_ptr,
                                x.data_ptr(), s, k, float(jitter), stream)
    _check(lib, err, "spd_solve")
    with _COUNT_LOCK:
        SPD_SOLVE_LAUNCHES += 1
    return x
