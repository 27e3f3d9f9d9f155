"""Seeds derived from the run's ``--seed``: every random draw of a run comes
from a generator seeded with ``derive(seed, *tags)``, so one seed gives the
same inputs on every run, and each draw its own stream."""
from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` (any ints and strings)
    under the run's ``seed`` (any whole number, however large)."""
    text = repr((int(seed),) + tuple(tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
