"""Native (C++) pieces of the runtime around the port's compute path
(copy of the reference's ``native/__init__.py``): the evlog append-only
event-log codec, ``csrc/evlog.cc``, compiled with g++ on first use and
bound with ctypes, beside its pure-Python twin."""

from predictionio_tpu_torch.native.evlog import (  # noqa: F401
    EvlogCodec,
    PyCodec,
    entity_hash,
    get_codec,
)
