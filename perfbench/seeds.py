"""Independent streams from one run seed."""
from __future__ import annotations

import hashlib


def substream(seed: int, *names) -> int:
    """A 63-bit generator seed for the stream ``names`` of run ``seed``:
    any whole number gives streams that do not overlap."""
    key = ":".join(str(x) for x in (seed,) + names).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
