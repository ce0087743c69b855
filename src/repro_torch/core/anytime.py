"""Anytime termination policies and the SLA-governed executor (paper §6).

Policies make a go/no-go decision *before each range* from monitored elapsed
time only — no feature-based latency prediction (§6.1 "Online Latency
Monitoring"). The Reactive policy adds the paper's Eq. (7) multiplicative
feedback on alpha after every query, turning the SLA percentile into a
target as well as a limit (§6.4).

The executor is host-driven: one device step per range, wall-clock
measured between steps (std::chrono::steady_clock -> time.perf_counter),
with the engine's device synchronised after each step so a range's time is
the time its work took on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.range_daat import Engine, QueryPlan, TopKState, theta

__all__ = [
    "Fixed",
    "Overshoot",
    "Undershoot",
    "Predictive",
    "Reactive",
    "AnytimeResult",
    "run_query_anytime",
]


class Policy:
    """Decide whether to Continue (True) given monitoring state."""

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        raise NotImplementedError

    def on_query_end(self, t_ms: float, budget_ms: float) -> None:  # Reactive hook
        pass

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Fixed(Policy):
    """Process at most n ranges (Fixed-n)."""

    n: int

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        return i < self.n

    @property
    def name(self) -> str:
        return f"Fixed-{self.n}"


class Overshoot(Policy):
    """Continue while t_i < B — risks one range's overshoot (Eq. 3)."""

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        return t_ms < budget_ms


@dataclasses.dataclass
class Undershoot(Policy):
    """Continue while t_i + t_max < B (Eq. 4) — never violates, may waste."""

    t_max_ms: float = 5.0

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        return t_ms + self.t_max_ms < budget_ms


@dataclasses.dataclass
class Predictive(Policy):
    """Continue while t_i + alpha * (t_i / i) < B (Eq. 5)."""

    alpha: float = 1.0

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        if i == 0:
            return True
        return t_ms + self.alpha * (t_ms / i) < budget_ms

    @property
    def name(self) -> str:
        return f"Predictive-a{self.alpha:g}"


@dataclasses.dataclass
class Reactive(Policy):
    """Predictive plus Eq. (7) feedback: alpha *= beta on an SLA miss,
    alpha *= (1/beta)^Q on a within-limit query (Q = SLA tolerance)."""

    alpha: float = 1.0
    beta: float = 1.2
    q: float = 0.01
    alpha_min: float = 0.1
    alpha_max: float = 64.0
    trace: list = dataclasses.field(default_factory=list)

    def decide(self, t_ms: float, i: int, budget_ms: float) -> bool:
        if i == 0:
            return True
        return t_ms + self.alpha * (t_ms / i) < budget_ms

    def on_query_end(self, t_ms: float, budget_ms: float) -> None:
        if t_ms > budget_ms:
            self.alpha *= self.beta
        else:
            self.alpha *= (1.0 / self.beta) ** self.q
        self.alpha = min(max(self.alpha, self.alpha_min), self.alpha_max)
        self.trace.append(self.alpha)

    @property
    def name(self) -> str:
        return f"Reactive-b{self.beta:g}"


@dataclasses.dataclass
class AnytimeResult:
    doc_ids: np.ndarray
    scores: np.ndarray
    elapsed_ms: float
    ranges_processed: int
    exit_reason: str  # "exhausted" | "safe" | "policy"
    range_times_ms: list
    postings: int
    blocks: int


def run_query_anytime(
    engine: Engine,
    plan: QueryPlan,
    policy: Optional[Policy] = None,
    budget_ms: float = float("inf"),
    safe_stop: bool = True,
    clock=time.perf_counter,
) -> AnytimeResult:
    """Host-driven anytime traversal of one query under an SLA budget."""
    state: TopKState = engine.init_state()
    n_ranges = plan.order_host.shape[0]
    plan.upload()  # the steps read the device tables: upload before the clock
    t0 = clock()
    times: list[float] = []
    exit_reason = "exhausted"
    processed = 0

    for i in range(n_ranges):
        th = int(theta(state))
        if safe_stop and th > 0 and plan.bounds_host[i] <= th:
            exit_reason = "safe"
            break
        elapsed = (clock() - t0) * 1e3
        if policy is not None and not policy.decide(elapsed, i, budget_ms):
            exit_reason = "policy"
            break
        state = engine.step(plan, state, i)
        # Per-range latency is the point of the anytime loop (paper Alg. 2
        # timing), so each step waits for the device.
        # analysis: allow[HOSTSYNC]
        engine.synchronize()
        times.append((clock() - t0) * 1e3 - sum(times))
        processed += 1

    total = (clock() - t0) * 1e3
    if policy is not None:
        policy.on_query_end(total, budget_ms)

    ids, scores = engine.topk_docs(state)
    order = np.lexsort((ids, -scores))
    return AnytimeResult(
        doc_ids=ids[order],
        scores=scores[order],
        elapsed_ms=total,
        ranges_processed=processed,
        exit_reason=exit_reason,
        range_times_ms=times,
        postings=int(state.postings),
        blocks=int(state.blocks),
    )
