"""The one traffic generator: it reads a mix's parameters from its data
file (``bench/traffic/<name>.json``) and the run's seed, and gives

* the prompt lengths, as a fixed stratified cycle that is the same for
  every seed (only the token ids change with the seed);
* each request's session, round robin;
* the seeds of each request's token ids, which the entry draws on the card;
* the sample of finished requests whose answers are compared, drawn from
  the seed, the longest and the shortest always among them.

Lengths: ``{"law": "log_uniform", "min": a, "max": b, "cycle": n}`` takes
the midpoint of each of n equal strata of ``log(length)`` over [a, b] (n a
power of two) and serves them in bit-reversed order, so that every stretch
of the cycle spans the range.
"""
from __future__ import annotations

import hashlib
import math
import random
from typing import List, Sequence


def sub_seed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for one purpose of a run (weights, one request's tokens,
    the compared sample), from the run's seed, which may be any integer."""
    h = hashlib.blake2b(f"{int(seed)}:{purpose}:{int(index)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _bit_reversed(n: int) -> List[int]:
    bits = n.bit_length() - 1
    if n != 1 << bits:
        raise ValueError(f"a cycle of lengths is a power of two, got {n}")
    return sorted(range(n), key=lambda j: int(f"{j:0{bits}b}"[::-1] or "0",
                                              2))


def length_cycle(mix: dict) -> List[int]:
    """The prompt lengths of one cycle, in serving order."""
    law = mix["lengths"]
    if law["law"] != "log_uniform":
        raise ValueError(f"unknown length law {law['law']!r}")
    lo, hi, n = math.log(law["min"]), math.log(law["max"]), law["cycle"]
    strata = [round(math.exp(lo + (j + 0.5) / n * (hi - lo)))
              for j in range(n)]
    return [strata[j] for j in _bit_reversed(n)]


def length_of(mix: dict, i: int) -> int:
    cycle = length_cycle(mix)
    return cycle[i % len(cycle)]


def session_of(mix: dict, i: int) -> str:
    return f"s{i % mix['sessions']}"


def warmup_lengths(mix: dict) -> List[int]:
    """The shapes set-up warms: the cycle's longest first (it sizes the
    allocator's pool), then its shortest."""
    cycle = length_cycle(mix)
    return [max(cycle), min(cycle)]


def compared(lengths: Sequence[int], k: int, seed: int) -> List[int]:
    """Indices of the finished requests whose answers are compared: the
    first of the longest, then (for ``k`` of 2 or more) the first of the
    shortest, where the first half of a prompt weighs most in the last
    position, and more drawn from the seed up to ``k``."""
    n = range(len(lengths))
    fixed = list(dict.fromkeys(
        [max(n, key=lambda i: (lengths[i], -i)),
         min(n, key=lambda i: (lengths[i], i))][:k])) if lengths else []
    rest = [i for i in n if i not in fixed]
    rng = random.Random(sub_seed(seed, "compared"))
    return sorted(fixed + rng.sample(rest, min(k - len(fixed), len(rest))))
