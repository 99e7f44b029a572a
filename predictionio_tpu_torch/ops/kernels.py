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
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
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

#: largest tile the shortlist kernel takes: its [T] f32 score row lives
#: in shared memory (227 KB per block on Hopper)
SHORTLIST_MAX_TILE = 32768
#: largest system the SPD solve kernel takes (its warp stages K x (K+1)
#: floats in shared memory; the reference's ``_PALLAS_MAX_K``)
SPD_SOLVE_MAX_K = 64

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    """Zero every launch count."""
    global SHORTLIST_LAUNCHES, SPD_SOLVE_LAUNCHES
    with _LOCK:
        SHORTLIST_LAUNCHES = 0
        SPD_SOLVE_LAUNCHES = 0


def counts() -> Dict[str, int]:
    return {"shortlist": SHORTLIST_LAUNCHES,
            "spd_solve": SPD_SOLVE_LAUNCHES}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: nvcc output}``
    for the sources built now (ptxas register/shared-memory report
    included). Raises ``RuntimeError`` if any build fails."""
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
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
        lib.pio_shortlist_topc.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
        lib.pio_shortlist_topc.restype = i
    elif name == "spd_solve":
        lib.pio_spd_solve.argtypes = [p, p, p, i, i, p]
        lib.pio_spd_solve.restype = i


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pio_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
             device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def shortlist_topc_cuda(u: torch.Tensor, tiles: torch.Tensor,
                        scales: torch.Tensor, n_items: int,
                        mask: Optional[torch.Tensor], cand: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/shortlist.cu on CUDA tensors: ``u [B,R] f32``,
    ``tiles [nt,T,R] int8``, ``scales [nt,T] f32``, ``mask [B,nt*T]
    bool`` or None -> ``(vals [B,nt*cand] f32, ids [B,nt*cand] i32)``.
    Runs on the current stream and does not synchronise."""
    global SHORTLIST_LAUNCHES
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
    mask_ptr = None
    if mask is not None:
        _require(mask, "mask", torch.bool, 2, dev)
        if tuple(mask.shape) != (b, nt * t):
            raise ValueError(f"mask shape {tuple(mask.shape)} != "
                             f"{(b, nt * t)}")
        mask_ptr = mask.data_ptr()
    lib = _lib("shortlist")
    vals = torch.empty((b, nt * cand), dtype=torch.float32, device=dev)
    ids = torch.empty((b, nt * cand), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pio_shortlist_topc(
            u.data_ptr(), tiles.data_ptr(), scales.data_ptr(), mask_ptr,
            vals.data_ptr(), ids.data_ptr(), b, nt, t, r, int(n_items),
            int(cand), stream)
    _check(lib, err, "shortlist")
    with _LOCK:
        SHORTLIST_LAUNCHES += 1
    return vals, ids


def spd_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/spd_solve.cu on CUDA tensors: ``A [S,K,K] f32``,
    ``b [S,K] f32`` -> ``x [S,K] f32`` with ``A[s] x[s] = b[s]``, for
    1 <= K <= 64. Runs on the current stream and does not synchronise."""
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
    lib = _lib("spd_solve")
    x = torch.empty((s, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pio_spd_solve(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                s, k, stream)
    _check(lib, err, "spd_solve")
    with _LOCK:
        SPD_SOLVE_LAUNCHES += 1
    return x
