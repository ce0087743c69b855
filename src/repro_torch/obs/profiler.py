"""Device-dispatch profiler: compile tracking, time split, HBM gauges.

The port's copy of the reference's profiler. The serving layers dispatch
padded batches whose shapes follow the pow2 bucket ladder (DESIGN.md
§3/§11). The profiler turns that discipline into three observable facts
per dispatch site:

  * **compiles** — the launcher's program count grew while dispatching a
    shape the site had not seen before;
  * **recompiles** — the count grew on an *already-seen* shape. That is an
    anomaly by construction and is counted separately so a perf gate can
    fail on ``recompiles > 0``;
  * the **host-plan / dispatch / device-step / transfer** split, so a q/s
    regression can be attributed to the layer it lives in.

**What a compile is in the port.** The reference's launchers are jitted
callables whose XLA program cache grows once per ``(batch, width)``
bucket. The port's launchers (``kernels.range_scorer.kernel.traverse`` and
``range_step``) run one CUDA library for every shape: ``nvcc`` builds it
once per source (``kernels/_nvcc.py``), and ``_cache_size()`` on each
launcher counts the libraries this process has loaded for it, 0 or 1. So
the first dispatch on the card counts one compile, later buckets none,
and on the CPU (the plain versions, nothing built) the count stays 0. A
count that grows on a shape already seen is a recompile and stays 0 over
the whole ladder in both packages; the compile counts differ from the
reference's by design.

The count is read from the launcher's ``_cache_size()`` hook via
:func:`jit_cache_size`, duck-typed, so this module imports neither torch
nor any other ``repro_torch`` package (the ``repro_torch.obs`` isolation
rule). When the hook is unavailable the profiler falls back to shape
novelty: a new shape counts as a compile and recompiles become
undetectable (counted 0).

HBM residency is reported from *live* device buffers: callers hand
:meth:`Profiler.record_hbm_once` any mapping of name -> tensor and the
profiler duck-types ``.nbytes`` (plain ints also accepted, so the
``device_bytes_report`` expected-bytes dicts can be recorded the same way
for cross-checks).

Everything funnels through the owning ``Instrumentation`` handle, so the
metrics land in the shared registry (with catalog help strings) and are
exported by the Prometheus/JSON surfaces. Timing-only: the port's sites
take the device time from CUDA events read at the drain boundary, where
the path already waits, and add no synchronisation; results never change
(the bitwise-neutrality contract of DESIGN.md §13).
"""

from __future__ import annotations

__all__ = ["Profiler", "jit_cache_size"]


def jit_cache_size(fn) -> int | None:
    """Program count of a launcher (the port's: CUDA libraries loaded), or None.

    Duck-typed on the ``_cache_size`` hook so the obs package needs no
    torch import; any callable without the hook (or whose hook raises)
    simply opts out of compile detection.
    """
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


class _SiteStats:
    __slots__ = (
        "dispatches",
        "compiles",
        "recompiles",
        "shapes",
        "plan_ms",
        "dispatch_ms",
        "device_ms",
        "transfer_ms",
        "hbm_bytes",
    )

    def __init__(self):
        self.dispatches = 0
        self.compiles = 0
        self.recompiles = 0
        self.shapes: set[tuple] = set()
        self.plan_ms = 0.0
        self.dispatch_ms = 0.0
        self.device_ms = 0.0
        self.transfer_ms = 0.0
        self.hbm_bytes: dict[str, int] | None = None


def _nbytes(value) -> int | None:
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, (int, float)):
        return int(value)
    return None


class Profiler:
    """Per-site dispatch profiler attached to an ``Instrumentation``.

    Sites call :meth:`record_dispatch` with the cache size read before and
    after the device call (via :func:`jit_cache_size`) plus the wall-clock
    split they measured; the profiler does the compile/recompile
    classification, keeps plain-python tallies for :meth:`snapshot` (the
    BENCH ``OBS_SNAPSHOT`` attachment), and mirrors everything into the
    metrics registry through the obs handle.
    """

    def __init__(self, obs):
        self.obs = obs
        self._sites: dict[str, _SiteStats] = {}

    def _site(self, site: str) -> _SiteStats:
        st = self._sites.get(site)
        if st is None:
            st = self._sites[site] = _SiteStats()
        return st

    def record_dispatch(
        self,
        site: str,
        shape: tuple,
        *,
        cache_before: int | None = None,
        cache_after: int | None = None,
        plan_ms: float | None = None,
        dispatch_ms: float | None = None,
        device_ms: float | None = None,
        transfer_ms: float | None = None,
    ) -> None:
        st = self._site(site)
        st.dispatches += 1
        new_shape = shape not in st.shapes
        st.shapes.add(shape)
        if cache_before is not None and cache_after is not None:
            compiled = cache_after > cache_before
        else:
            compiled = new_shape  # novelty fallback: no cache introspection
        obs = self.obs
        obs.count("profiler_dispatches", site=site)
        if compiled and new_shape:
            st.compiles += 1
            obs.count("profiler_compiles", site=site)
        elif compiled:
            st.recompiles += 1
            obs.count("profiler_recompiles", site=site)
        for name, val in (
            ("profiler_plan_ms", plan_ms),
            ("profiler_dispatch_ms", dispatch_ms),
            ("profiler_device_ms", device_ms),
            ("profiler_transfer_ms", transfer_ms),
        ):
            if val is None:
                continue
            obs.observe(name, val, site=site)
            short = name[len("profiler_") : -len("_ms")]
            setattr(st, f"{short}_ms", getattr(st, f"{short}_ms") + val)

    def record_hbm_once(self, site: str, arrays) -> None:
        """Gauge live HBM residency for a site's device index, once.

        ``arrays`` is any name -> array-or-int mapping (``DeviceIndex.
        _asdict()``, ``device_bytes_report`` output, ...); entries without a
        byte size (None leaves, nested dicts) are skipped. Idempotent per
        site so the per-dispatch path stays O(1) after the first call.
        """
        st = self._site(site)
        if st.hbm_bytes is not None:
            return
        report: dict[str, int] = {}
        total = 0
        for name, value in dict(arrays).items():
            nb = _nbytes(value)
            if nb is None:
                continue
            report[name] = nb
            total += nb
            self.obs.gauge("hbm_bytes", nb, site=site, array=name)
        st.hbm_bytes = report
        self.obs.gauge("hbm_total_bytes", total, site=site)

    # -------------------------------------------------------------- report
    def recompiles(self) -> int:
        return sum(st.recompiles for st in self._sites.values())

    def snapshot(self) -> dict:
        """JSON-able per-site tallies (attached to BENCH ``OBS_SNAPSHOT``)."""
        out = {}
        for site, st in sorted(self._sites.items()):
            out[site] = {
                "dispatches": st.dispatches,
                "compiles": st.compiles,
                "recompiles": st.recompiles,
                "shapes": sorted(list(s) for s in st.shapes),
                "plan_ms": round(st.plan_ms, 3),
                "dispatch_ms": round(st.dispatch_ms, 3),
                "device_ms": round(st.device_ms, 3),
                "transfer_ms": round(st.transfer_ms, 3),
                "hbm_total_bytes": (
                    sum(st.hbm_bytes.values()) if st.hbm_bytes else None
                ),
            }
        return out
