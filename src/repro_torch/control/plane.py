"""The anytime serving control plane (DESIGN.md §9).

``ControlPlane`` sits above the §3/§4 serving stack and owns the pieces
that have to outlive any single engine: the request queue, the health
ledger, the reshard planner, and the live engine pointer. One object, four
cooperating behaviours:

  * **serving** — a ``MicroBatchServer`` loop (submit / drain) over the
    live engine: a ``ReplicaGroupEngine`` when replicas are configured and
    healthy, the plain ``ShardedEngine`` path otherwise;
  * **budgeting** — a ``ShardedSlaBudgeter`` in BoundSum mode by default:
    each query's postings budget concentrates on the shards whose ranges
    can actually score for its terms;
  * **failover** — ``mark_down``/``mark_up`` drive the ledger; dead shards
    get zero-budget dispatch slots so every query still returns, with
    ``exact=False`` and a ``fidelity_bound`` widened by the dead shard's
    unprocessed BoundSum mass; recovery is automatic on ``mark_up``;
  * **reshard** — the planner watches per-shard load EWMAs fed by the
    serving loop; ``maybe_reshard`` (or an explicit ``start_reshard``)
    opens a staged ``ReshardTask`` whose ``step()`` runs between
    micro-batches, and the engine pointer swaps only when the successor is
    built and warm — serving never pauses, and post-cutover results are
    bitwise-equal to a fresh build at the new layout. A reshard never
    starts during an outage: outage-skewed counters would re-seed the
    budgeter wrong and the cutover would restack from a possibly-dead
    device's arrays (``start_reshard`` refuses, or defers until the fleet
    recovers);
  * **durability** — with a ``TopologyJournal`` attached
    (``ControlPlane.from_artifact``), reshard commits and health
    transitions append to ``journal.jsonl`` inside the serving artifact,
    and ``from_artifact(..., replay=True)`` reconstructs the journaled
    cuts + ledger in a fresh process (DESIGN.md §10).

The port's plane is the reference's over the port's engines, on one card:
every dispatch is one ``traverse`` launch over the stacked (query, shard)
lanes of the live ``ShardedEngine``; a replica group serves through that
engine (its mesh waits for ROADMAP A7), so ``stats()["replica_mesh"]`` is
False. The journal is the reference's JSON, with the same fingerprint
stamp, so either package's plane replays the other's.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.control.health import HealthLedger
from repro_torch.control.journal import JOURNAL_NAME, TopologyJournal
from repro_torch.control.replica import ReplicaGroupEngine
from repro_torch.control.reshard import ReshardPlanner, ReshardTask
from repro_torch.core.clustered_index import range_postings_mass, shard_device_index
from repro_torch.core.range_daat import Engine
from repro_torch.obs import NOOP
from repro_torch.serving.bucketing import BucketSpec
from repro_torch.serving.microbatch import MicroBatchServer, ShardedSlaBudgeter
from repro_torch.serving.sharded import ShardedBatchEngine, ShardedEngine

__all__ = ["ControlPlane"]


class _PlaneServer(MicroBatchServer):
    """MicroBatchServer whose dispatch and feedback route via the plane."""

    def __init__(self, plane: "ControlPlane", **kwargs):
        super().__init__(plane.bengine, plane.budgeter, **kwargs)
        self.plane = plane

    def _run_batch(self, plans, budgets):
        return self.plane._dispatch(plans, budgets)

    def _observe(self, batch_ms, results, latencies_ms=None):
        self.plane._observe(batch_ms, results, latencies_ms=latencies_ms)


class ControlPlane:
    """Replicated, reshardable, failure-tolerant anytime serving.

    ``n_replicas > 1`` builds a ``ReplicaGroupEngine``, which serves
    through the sharded engine on one card (``use_mesh`` as in
    ``ShardedEngine``: None or False; True raises until the mesh is
    ported). The engine's device (the card unless it was built with
    ``device="cpu"``) is the plane's. ``budget_mode`` picks the
    ``ShardedSlaBudgeter`` allocation ("boundsum" default, "rate" for the
    §4 behaviour). ``sla_ms=inf`` serves unbudgeted (every query runs to
    safe/exhausted completion) — the mode the bitwise tests pin.
    """

    def __init__(
        self,
        engine: Engine,
        n_shards: int,
        n_replicas: int = 1,
        sla_ms: float = float("inf"),
        spec: BucketSpec | None = None,
        use_mesh: bool | None = None,
        budget_mode: str = "boundsum",
        reshard_trigger: float = 1.25,
        budgeter: ShardedSlaBudgeter | None = None,
        max_batch: int | None = None,
        clock=None,
        journal: TopologyJournal | None = None,
        obs=NOOP,
    ):
        self.engine = engine
        self.n_replicas = n_replicas
        self.spec = spec or BucketSpec()
        self._use_mesh = use_mesh
        self.obs = obs
        self.clock = clock if clock is not None else obs.clock
        self.health = HealthLedger(n_shards, n_replicas)
        self._install(ShardedEngine(engine, n_shards, use_mesh=use_mesh, obs=obs))
        self.budgeter = budgeter or ShardedSlaBudgeter(
            sla_ms=sla_ms,
            n_shards=n_shards,
            mode=budget_mode,
            shard_mass=self._shard_mass,
            obs=obs,
        )
        if getattr(self.budgeter, "down_mask", False) is None:
            # Base-API `observe` feedback must not credit postings to
            # health-ledger-down shards (their EWMAs stay frozen through an
            # outage) — wire the ledger in unless the caller already did.
            self.budgeter.down_mask = self.health.shard_down_mask
        self.planner = ReshardPlanner(
            range_mass=range_postings_mass(engine.index),
            cuts=self.sengine.cuts,
            trigger=reshard_trigger,
        )
        self.reshard_task: ReshardTask | None = None
        self.deferred_reshard: dict | None = None
        self.reshards_completed = 0
        self.batches_served = 0
        self.queries_served = 0
        self.queries_served_during_reshard = 0
        self._reshard_t0: float | None = None
        self.server = _PlaneServer(
            self, max_batch=max_batch, clock=self.clock, obs=obs
        )
        # Topology journal (DESIGN.md §10): records are stamped with the
        # served index's fingerprint so replay can refuse a foreign journal.
        # The fingerprint (a sha1 pass over the postings arrays) is computed
        # lazily — journal-less planes never pay for it.
        self.journal = journal
        self._journal_muted = False
        self._fp_cache: str | None = None
        # Operations layer (DESIGN.md §14): attached via enable_operations.
        self.monitor = None
        self.slo_tracker = None
        self.degraded_slo = False
        self._skew_alert = False
        self._ops_every = 1
        self._drains = 0
        if self.obs.enabled:
            self.obs.gauge("plane_available", 1.0)

    @property
    def _fingerprint(self) -> str:
        if self._fp_cache is None:
            self._fp_cache = self.engine.index.fingerprint()
        return self._fp_cache

    @classmethod
    def from_artifact(
        cls,
        path: str,
        n_shards: int,
        replay: bool = False,
        journal: bool = True,
        engine_kwargs: dict | None = None,
        **plane_kwargs,
    ) -> "ControlPlane":
        """Open a plane over a saved index artifact (or delta-chain head).

        ``journal=True`` attaches ``<path>/journal.jsonl`` so topology
        changes persist; ``replay=True`` additionally reconstructs the
        journaled cuts and health-ledger state before serving — a broker
        that died mid-reshard resumes at the last *committed* layout
        (uncommitted cutover work is simply re-planned). ``engine_kwargs``
        go to ``Engine.from_artifact`` (k, impact_dtype, device, ...);
        everything else to the plane constructor.
        """
        engine = Engine.from_artifact(path, **(engine_kwargs or {}))
        plane = cls(
            engine,
            n_shards,
            journal=(
                TopologyJournal(os.path.join(path, JOURNAL_NAME))
                if journal
                else None
            ),
            **plane_kwargs,
        )
        if replay:
            plane.replay_journal()
        return plane

    # ----------------------------------------------------------- installing
    def _install(self, sengine: ShardedEngine) -> None:
        """Point the plane at a (new) sharded engine + its replica group."""
        self.sengine = sengine
        self.replicas = (
            ReplicaGroupEngine(sengine, self.n_replicas, use_mesh=self._use_mesh)
            if self.n_replicas > 1
            else None
        )
        self.bengine = ShardedBatchEngine(self.replicas or sengine, self.spec)
        self.bengine_single = (
            ShardedBatchEngine(sengine, self.spec) if self.replicas else self.bengine
        )

    def _shard_mass(self, plan) -> np.ndarray:
        # Late-bound so a reshard swap retargets budget shaping too.
        return self.sengine.query_shard_mass(plan)

    @property
    def n_shards(self) -> int:
        return self.sengine.n_shards

    @property
    def cuts(self) -> np.ndarray:
        return self.sengine.cuts

    # -------------------------------------------------------------- serving
    def submit(self, q_terms: np.ndarray) -> int:
        return self.server.submit(q_terms)

    @property
    def pending(self) -> int:
        return self.server.pending

    def drain_once(self):
        """Serve one micro-batch, then advance any in-flight reshard.

        The reshard step runs strictly *between* dispatches, so the queue
        is never blocked behind cutover work; the swap happens here too,
        once the successor engine reports ready. When the operations layer
        is attached (``enable_operations``), the SLO tracker samples and
        the drift monitor polls here as well — and a sustained shard-skew
        alert arms ``maybe_reshard`` without waiting for an external
        caller.
        """
        served = self.server.drain_once()
        self.batches_served += 1 if served else 0
        self.queries_served += len(served)
        self._drains += 1
        if (
            (self.slo_tracker is not None or self.monitor is not None)
            and self._drains % self._ops_every == 0
        ):
            if self.slo_tracker is not None:
                self.slo_tracker.sample()
                self.slo_tracker.evaluate()
            if self.monitor is not None:
                self.monitor.poll()
        if self._skew_alert and self.reshard_task is None:
            self.maybe_reshard()
        if self.reshard_task is not None:
            if served:
                self.queries_served_during_reshard += len(served)
            self.reshard_task.step()
            if self.reshard_task.ready:
                self._cutover()
        return served

    def replay(self, queries, batch_size: int | None = None):
        """Offline replay through the plane's drain loop."""
        bs = max(1, min(batch_size or self.server.max_batch, self.server.max_batch))
        out = []
        for lo in range(0, len(queries), bs):
            for q in queries[lo : lo + bs]:
                self.submit(q)
            out.extend(self.drain_once())
        while self.pending:
            out.extend(self.drain_once())
        return out

    def _dispatch(self, plans, budgets):
        down = self.health.shard_down_mask()
        if (
            self.replicas is not None
            and self.health.n_healthy_replicas() < self.n_replicas
        ):
            # A degraded replica row cannot carry its slice of the batch;
            # reroute through the single-replica path (same math, fewer
            # devices) until the ledger clears — throughput, not fidelity.
            beng = self.bengine_single
        else:
            beng = self.bengine
        return beng.run_batch(
            plans,
            budget_postings=budgets,
            down_mask=down if down.any() else None,
        )

    def _observe(self, batch_ms, results, latencies_ms=None) -> None:
        per_shard = np.sum([r.shard_postings for r in results], axis=0)
        up = ~self.health.shard_down_mask()
        if self.obs.enabled:
            # Per-shard postings counters: the ShardSkewProbe's signal
            # (DESIGN.md §14) — same numbers the reshard planner EWMAs.
            for s in range(per_shard.shape[0]):
                self.obs.count(
                    "shard_postings", float(per_shard[s]), shard=s
                )
        self.budgeter.observe_sharded(
            batch_ms, per_shard, len(results), active_mask=up,
            latencies_ms=latencies_ms,
        )
        # The reshard planner only learns from a healthy fleet: a down
        # shard's zero counters say nothing about where load lives, and
        # would otherwise decay its EWMA until an outage armed a spurious
        # (and wrong-direction) reshard.
        if up.all():
            self.planner.observe(per_shard, len(results))

    # ----------------------------------------------------------- operations
    def enable_operations(
        self, slos=None, monitor=None, poll_every: int = 1
    ) -> None:
        """Attach the §14 operations layer to the drain loop.

        ``slos`` is an ``SloTracker`` (sampled + evaluated every
        ``poll_every`` drains, writing ``slo_*`` gauges into the plane's
        registry); ``monitor`` a ``DriftMonitor`` — the plane subscribes
        to its alerts: a ``shard_skew`` fire arms ``maybe_reshard`` on
        subsequent drains, an SLO-burn fire flips the plane into a
        degraded-SLO state (``stats()['degraded_slo']``), both clearing
        with the alert.
        """
        self.slo_tracker = slos
        self.monitor = monitor
        self._ops_every = max(1, int(poll_every))
        if monitor is not None:
            monitor.subscribe(self._on_alert)

    def _on_alert(self, event) -> None:
        firing = event.state == "fire"
        if event.detector == "shard_skew":
            self._skew_alert = firing
        elif "burn" in event.detector:
            self.degraded_slo = firing
            if self.obs.enabled:
                self.obs.gauge("plane_degraded_slo", 1.0 if firing else 0.0)

    # -------------------------------------------------------------- journal
    def _journal_append(self, record: dict) -> None:
        if self.journal is None or self._journal_muted:
            return
        self.journal.append({"fingerprint": self._fingerprint, **record})

    def replay_journal(self) -> int:
        """Reconstruct journaled topology state; returns records applied.

        The last committed reshard's cuts become the live layout (rebuilt
        via ``shard_device_index(cuts=...)`` — bitwise what the original
        cutover served), then health transitions re-drive the ledger in
        order. Records stamped with a different index fingerprint are
        refused: a journal describes exactly one materialized index.
        """
        if self.journal is None:
            raise RuntimeError("no topology journal attached")
        records = self.journal.records()
        foreign = [
            r for r in records if r.get("fingerprint") != self._fingerprint
        ]
        if foreign:
            from repro_torch.index_io import ArtifactError  # local: above control

            raise ArtifactError(
                f"journal {self.journal.path} has {len(foreign)} record(s) "
                f"for index {foreign[0].get('fingerprint')}, but the live "
                f"index is {self._fingerprint} — refusing to replay a "
                f"foreign topology"
            )
        cuts, last_reshard = None, -1
        for i, r in enumerate(records):
            if r.get("kind") == "reshard":
                cuts, last_reshard = np.asarray(r["cuts"], np.int64), i
        if cuts is not None and not np.array_equal(cuts, self.sengine.cuts):
            self._adopt_layout(
                ShardedEngine(
                    self.engine,
                    int(cuts.shape[0] - 1),
                    use_mesh=self._use_mesh,
                    shards=shard_device_index(self.engine.index, cuts=cuts),
                    obs=self.obs,
                ),
                cuts,
            )
        self.reshards_completed = sum(
            1 for r in records if r.get("kind") == "reshard"
        )
        self._journal_muted = True
        try:
            # Only health records AFTER the last committed reshard apply:
            # the live _cutover reset the ledger at that point (shard
            # indices name different range bands across layouts), and
            # older records may reference shard ids the new layout no
            # longer has.
            for r in records[last_reshard + 1:]:
                if r.get("kind") != "health":
                    continue
                replica = r.get("replica")
                if r.get("event") == "down":
                    self.mark_down(int(r["shard"]), replica)
                else:
                    self.mark_up(int(r["shard"]), replica)
        finally:
            self._journal_muted = False
        return len(records)

    # ------------------------------------------------------------- failover
    def mark_down(self, shard: int, replica: int | None = None) -> None:
        self.health.mark_down(shard, replica)
        if self.obs.enabled:
            self.obs.count("health_transitions", event="down", shard=shard)
            self.obs.gauge(
                "plane_available", 1.0 if self.health.all_up else 0.0
            )
        self._journal_append(
            {"kind": "health", "event": "down", "shard": int(shard),
             "replica": None if replica is None else int(replica)}
        )

    def mark_up(self, shard: int, replica: int | None = None) -> None:
        self.health.mark_up(shard, replica)
        if self.obs.enabled:
            self.obs.count("health_transitions", event="up", shard=shard)
            self.obs.gauge(
                "plane_available", 1.0 if self.health.all_up else 0.0
            )
        self._journal_append(
            {"kind": "health", "event": "up", "shard": int(shard),
             "replica": None if replica is None else int(replica)}
        )
        if self.deferred_reshard is not None and self.health.all_up:
            pending, self.deferred_reshard = self.deferred_reshard, None
            self.start_reshard(**pending)

    # -------------------------------------------------------------- reshard
    def maybe_reshard(self) -> bool:
        """Open a staged reshard if the planner is armed; returns True then."""
        if (
            self.reshard_task is not None
            or not self.health.all_up  # outage-skewed EWMAs arm spuriously
            or not self.planner.should_reshard()
        ):
            return False
        self.start_reshard(self.planner.propose())
        return True

    def start_reshard(
        self,
        cuts,
        shards_path: str | None = None,
        warm_widths=None,
        defer_if_degraded: bool = False,
    ) -> ReshardTask | None:
        """Begin a live cutover to ``cuts``.

        Source arrays are the live engine's shards, or — with
        ``shards_path`` — a persisted ``index_io`` shard artifact, so a
        reshard can be driven entirely from disk without the full index.
        ``warm_widths`` runs those width buckets once on the successor
        before the swap (defaults to every width the live engine has seen).

        Refused while any shard is health-ledger down: a cutover mid-outage
        would re-seed budgeter EWMAs from outage-skewed counters and
        restack from a possibly-dead device's arrays. Pass
        ``defer_if_degraded=True`` to queue the request instead — it
        starts automatically at the ``mark_up`` that restores full health
        (returns None in the deferred case).
        """
        if self.reshard_task is not None:
            raise RuntimeError("a reshard is already in flight")
        # Validate the request up front — also on the deferred path, so a
        # bad request fails at request time, never out of a later mark_up.
        cuts = np.asarray(cuts, np.int64)
        R = int(self.sengine.cuts[-1])
        if (
            cuts.ndim != 1
            or cuts.shape[0] < 2
            or cuts[0] != 0
            or cuts[-1] != R
            or np.any(np.diff(cuts) < 1)
        ):
            raise ValueError(
                f"cuts {cuts.tolist()} must rise strictly from 0 to "
                f"n_ranges={R} (every shard keeps >= 1 range)"
            )
        if np.array_equal(cuts, self.sengine.cuts):
            raise ValueError(f"cuts {cuts.tolist()} are already the live layout")
        if not self.health.all_up:
            if defer_if_degraded:
                self.deferred_reshard = dict(
                    cuts=cuts,
                    shards_path=shards_path,
                    warm_widths=warm_widths,
                )
                return None
            down = np.nonzero(self.health.shard_down_mask())[0].tolist()
            raise RuntimeError(
                f"refusing to start a reshard during an outage (ledger has "
                f"down shards {down}, degraded replicas "
                f"{(~self.health.replica_healthy_mask()).sum()}): cutover "
                f"would restack from possibly-dead arrays and re-seed "
                f"budgets from outage-skewed counters — mark_up first, or "
                f"pass defer_if_degraded=True"
            )
        if shards_path is not None:
            from repro_torch import index_io  # local: index_io sits above control

            src = index_io.read_manifest(shards_path).get("source_fingerprint")
            if src is None:
                # Same stance as ShardedEngine.from_artifact: an
                # unverifiable shard set is as dangerous as a stale one —
                # foreign arrays under the live planner serve garbage with
                # no error. Re-save with source_fingerprint= to opt in.
                raise index_io.ArtifactError(
                    f"shard artifact {shards_path} records no "
                    f"source_fingerprint; re-save with "
                    f"source_fingerprint=index.fingerprint()"
                )
            if src != self.engine.index.fingerprint():
                raise index_io.ArtifactError(
                    f"shard artifact {shards_path} was carved from index "
                    f"{src}, but the live index has fingerprint "
                    f"{self.engine.index.fingerprint()} — refusing to "
                    f"reshard from a stale layout"
                )
            source = index_io.load_shards(shards_path)
        else:
            source = self.sengine.shards
        if warm_widths is None:
            warm_widths = sorted({w for (_, w) in self.bengine.compiled_shapes})

        def build(new_shards):
            seng = ShardedEngine(
                self.engine,
                len(new_shards),
                use_mesh=self._use_mesh,
                shards=new_shards,
                obs=self.obs,
            )
            beng = ShardedBatchEngine(
                ReplicaGroupEngine(seng, self.n_replicas, use_mesh=self._use_mesh)
                if self.n_replicas > 1
                else seng,
                self.spec,
            )
            return seng, beng

        self.reshard_task = ReshardTask(source, cuts, build, warm_widths)
        if self.obs.enabled:
            self._reshard_t0 = self.clock()
            self.obs.count("reshard_started")
        return self.reshard_task

    def _cutover(self) -> None:
        """Atomic engine swap: the next micro-batch serves the new layout.

        The task's engines were built and warmed off the serving path, so
        the swap is pointer rebinding only. The health ledger resets —
        shard indices now name different range bands — and the planner
        adopts the new cuts with a fresh load EWMA.
        """
        task = self.reshard_task
        assert task is not None and task.ready
        self.sengine = task.sengine
        self.bengine = task.bengine
        self.replicas = task.bengine.sengine if self.n_replicas > 1 else None
        self.bengine_single = (
            ShardedBatchEngine(task.sengine, self.spec)
            if self.n_replicas > 1
            else task.bengine
        )
        self.server.bengine = self.bengine
        self.health.reset(task.n_shards)
        self._reseed_budgeter(task.n_shards)
        self.planner.committed(task.cuts)
        self.reshard_task = None
        self.reshards_completed += 1
        if self.obs.enabled:
            self.obs.count("reshard_cutovers")
            if self._reshard_t0 is not None:
                # Arm -> cutover wall time: how long serving carried the
                # staged successor before the pointer swap.
                self.obs.observe(
                    "reshard_ms", (self.clock() - self._reshard_t0) * 1e3
                )
                self._reshard_t0 = None
        self._journal_append(
            {"kind": "reshard", "cuts": [int(c) for c in task.cuts]}
        )

    def _reseed_budgeter(self, n_shards: int) -> None:
        if self.budgeter.n_shards != n_shards:
            # A layout change may change the shard count; re-seed the
            # per-shard throughput EWMAs at the old mean so budgets stay sane.
            self.budgeter.n_shards = n_shards
            self.budgeter.rates = np.full(
                n_shards, float(np.mean(self.budgeter.rates)), np.float64
            )

    def _adopt_layout(self, sengine: ShardedEngine, cuts: np.ndarray) -> None:
        """Swap to a layout built outside a live cutover (journal replay)."""
        self._install(sengine)
        self.server.bengine = self.bengine
        self.health.reset(sengine.n_shards)
        self._reseed_budgeter(sengine.n_shards)
        self.planner.committed(cuts)

    def save_shards(self, path: str, overwrite: bool = False) -> str:
        """Persist the live shard layout as an ``index_io`` artifact.

        Records the range cuts and the source index fingerprint, so a later
        ``start_reshard(shards_path=...)`` — possibly in a fresh process —
        can re-stack from disk and refuse a stale artifact.
        """
        from repro_torch import index_io  # local: index_io sits above control

        return index_io.save_shards(
            self.sengine.shards,
            path,
            quantizer=self.engine.index.quantizer,
            source_fingerprint=self.engine.index.fingerprint(),
            overwrite=overwrite,
        )

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """JSON-able operating snapshot for dashboards and benchmarks."""
        return {
            "n_shards": self.n_shards,
            "n_replicas": self.n_replicas,
            "cuts": self.sengine.cuts.tolist(),
            "replica_mesh": bool(
                self.replicas is not None and self.replicas.group_mesh is not None
            ),
            "health": self.health.snapshot(),
            "load_ewma": self.planner.load.tolist(),
            "imbalance": round(self.planner.imbalance(), 4),
            "reshard_in_flight": (
                self.reshard_task.stage if self.reshard_task else None
            ),
            "reshard_deferred": self.deferred_reshard is not None,
            "journal": self.journal.path if self.journal else None,
            "reshards_completed": self.reshards_completed,
            "batches_served": self.batches_served,
            "queries_served": self.queries_served,
            "queries_served_during_reshard": self.queries_served_during_reshard,
            "alpha": round(float(self.budgeter.policy.alpha), 4),
            "degraded_slo": self.degraded_slo,
            "skew_alert": self._skew_alert,
            "alerts_firing": (
                self.monitor.firing() if self.monitor is not None else []
            ),
        }
