"""Seeds of everything a run makes, derived from `--seed` and a purpose.

`derive(seed, "weights", 3)` is a 32-bit seed for numpy's RandomState and
torch.Generator; one `--seed` gives the same numbers on every machine, and
any whole number (also past 32 bits, or negative) is taken."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *purpose) -> int:
    words = [int(seed) & (2 ** 64 - 1)]
    words += [zlib.crc32(str(p).encode()) for p in purpose]
    return int(np.random.SeedSequence(words).generate_state(1)[0])
