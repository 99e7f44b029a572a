"""Device-resident input cache (port of the reference's
``ops/device_cache.py``).

The steady-state rule of the port is "put host data on the device once,
then let every step use the resident tensors" (``models/als.py``
``ALSData.put``). This module extends it to ad-hoc inputs (a classifier's
document matrix): ``resident()`` keys a device tensor on the IDENTITY of
the host arrays it was built from, so back-to-back train and predict
calls over the same host data upload it once.

Why identity and not content: hashing inputs of hundreds of MB would
cost as much as the upload it avoids. Identity keying assumes callers do
not mutate training arrays in place between calls. Entries evict when
any source array is garbage-collected (weakref callbacks), so the cache
cannot outlive the host data and cannot grow past the number of live
distinct inputs.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_cache: Dict[Tuple, Any] = {}


def _key_of(arrays: Sequence[np.ndarray], extra: Tuple) -> Tuple:
    return tuple((id(a), a.shape, str(a.dtype)) for a in arrays) + (extra,)


def is_resident(arrays: Sequence[np.ndarray], extra: Tuple) -> bool:
    """True when ``resident(arrays, extra, ...)`` would hit the cache:
    the residency probe for routing by where the data already is."""
    with _lock:
        return _key_of(arrays, extra) in _cache


def resident(arrays: Sequence[np.ndarray], extra: Tuple,
             build: Callable[[], Any]) -> Any:
    """Return ``build()``'s result (a tensor on some device), cached
    until any of ``arrays`` is garbage-collected.

    ``arrays`` are the host ndarrays the device value derives from (the
    key and the lifetime anchors). ``extra`` tells apart different
    device layouts of the same data (device, dtype, padding)."""
    key = _key_of(arrays, extra)
    with _lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit[0]
    val = build()
    # weakref.ref with a callback: eviction must not keep the source
    # arrays alive
    refs = []
    for a in arrays:
        try:
            refs.append(weakref.ref(a, lambda _r, k=key: _evict(k)))
        except TypeError:        # not weakref-able (a scalar): no anchor
            pass
    with _lock:
        _cache[key] = (val, refs)
    return val


def _evict(key: Tuple) -> None:
    with _lock:
        _cache.pop(key, None)


def clear() -> None:
    """Drop every cached device tensor (tests; after a train)."""
    with _lock:
        _cache.clear()


def size() -> int:
    with _lock:
        return len(_cache)
