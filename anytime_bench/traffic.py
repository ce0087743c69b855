"""The one traffic generator: a cell's traffic file in, a seeded stream out.

A traffic file (``traffic/<cell>.json``) names the server and its shape, the
budget (``sla_ms``; null is unbounded), the query pool and the arrival process:

  * ``{"process": "poisson", "rate_qps": r}``: open-loop arrivals at mean rate
    r for the whole window;
  * ``{"process": "backlog", "depth": d}``: no arrival times; the server's
    queue is kept at d queries, so the engine never waits for work.

A seed does not change how much work a run gets, only its order within short
blocks, so that runs on different seeds differ no more than two runs of one
seed. A window of length s at rate r always holds round(r * s) arrivals whose
gaps are the exponential distribution's quantiles at (i + 1/2) / n, in one
fixed random order (a Poisson process's sample, the same for every seed) that
the seed shuffles within consecutive blocks of ``BLOCK`` gaps, scaled to fill
the window; so every block of arrivals spans the same time under every seed.
The n queries of a run are the pool's first n rows (cycled), shuffled by the
seed within blocks of ``BLOCK``, so any prefix of whole blocks asks for the
same work under every seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BLOCK", "Stream", "make_stream", "pool_order"]

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Stream:
    due: np.ndarray | None  # [n] seconds from the window's start (None: backlog)
    qidx: np.ndarray  # [n] pool rows, in submission order


def _block_shuffle(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    x = x.copy()
    for lo in range(0, x.shape[0], BLOCK):
        x[lo:lo + BLOCK] = rng.permutation(x[lo:lo + BLOCK])
    return x


def pool_order(rng: np.random.Generator, pool_size: int, n: int) -> np.ndarray:
    """n pool rows: rows 0..n-1 (mod the pool's size), each block of
    ``BLOCK`` shuffled by the seed."""
    return _block_shuffle(rng, np.arange(n, dtype=np.int64) % pool_size)


def _arrivals(rng: np.random.Generator, seconds: float, rate: float,
              stream: int) -> np.ndarray:
    n = int(round(rate * seconds))
    if n == 0:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(stream).permutation(gaps)  # the same for every seed
    gaps = _block_shuffle(rng, gaps)
    gaps *= seconds / gaps.sum()
    return np.r_[0.0, np.cumsum(gaps)[:-1]]


def make_stream(arrivals: dict, seed: int, seconds: float, pool_size: int,
                stream: int = 0) -> Stream:
    """The arrivals of ``seconds`` of traffic from ``seed``; ``stream`` tells
    independent streams of one seed apart (0: the window, 1: the warm-up)."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), stream])
    proc = arrivals["process"]
    if proc == "poisson":
        due = _arrivals(rng, seconds, float(arrivals["rate_qps"]), stream)
    elif proc == "backlog":
        # Enough rows for any window: the harness cycles past the end.
        return Stream(due=None, qidx=pool_order(rng, pool_size, 4 * pool_size))
    else:
        raise ValueError(f"arrival process {proc!r} not in ('poisson', 'backlog')")
    return Stream(due=due, qidx=pool_order(rng, pool_size, due.shape[0]))
