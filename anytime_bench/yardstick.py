"""The benchmark's yardstick: the card's peaks, the byte model of a range step,
and the reduction of a device trace to busy time, kernel time and idle gaps.

Nothing here imports the program. The byte model is a frozen copy of
``chip_smoke.StepBytes`` (the bytes a range step must move); the reference
feeds it its own block columns and the block ids a served query lists, so a
roofline share rests on counts that the comparison has checked.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "DeviceTimeline", "overlap_s", "step_bytes"]

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s. The roofline divides by the
# published rate, as ``launch/roofline.py`` does.
HBM_BYTES_PER_S = 3.35e12


def step_bytes(blk, rest, theta: int, lens, maximp, widths, imp_size: int,
               packed: bool) -> int:
    """Bytes one range step must move (frozen copy of ``chip_smoke.StepBytes``).

    Per listed block: a padding id (-1) costs its 4-byte id alone; a valid
    block its id, rest bound and largest impact (12 B), which decide whether
    it is kept (largest impact plus rest beats theta); a kept block also its
    row (start and length, plus the directory entry and first docid when
    packed) and its postings (impacts, and docids or packed words). The
    accumulator never leaves the chip. ``lens``, ``maximp`` and ``widths``
    (bits per packed delta) are per-block host columns.
    """
    blk = np.asarray(blk, np.int64)
    safe = np.clip(blk, 0, None)
    valid = blk >= 0
    keep = valid & (np.asarray(maximp)[safe] + np.asarray(rest) > theta)
    kl = np.asarray(lens)[safe][keep].astype(np.int64)
    row = 4 * 2 + (4 * 2 if packed else 0)
    docs = (int(((kl * np.asarray(widths)[safe][keep] + 31) // 32).sum()) * 4
            if packed else int(kl.sum()) * 4)
    return (blk.shape[0] * 4 + int(valid.sum()) * 8 + int(keep.sum()) * row
            + int(kl.sum()) * imp_size + docs)


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Union of intervals as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], np.maximum.accumulate(ends[o])
    head = np.ones(s.shape[0], bool)
    head[1:] = s[1:] > e[:-1]
    idx = np.nonzero(head)[0]
    return s[idx], np.r_[e[idx[1:] - 1], e[-1]]


def _coverage(bs: np.ndarray, be: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Length of the disjoint sorted intervals (bs, be) that lies below x."""
    cum = np.r_[0.0, np.cumsum(be - bs)]
    j = np.searchsorted(bs, x, side="right") - 1
    inside = np.where(j >= 0, np.clip(x - bs[np.maximum(j, 0)], 0,
                                      (be - bs)[np.maximum(j, 0)]), 0.0)
    return cum[np.maximum(j, 0)] * (j >= 0) + inside


def overlap_s(a_starts, a_ends, b_starts, b_ends) -> float:
    """Total overlap of two sets of intervals, each disjoint within itself."""
    a_starts, a_ends = np.asarray(a_starts, np.float64), np.asarray(a_ends, np.float64)
    bs, be = _merge(np.asarray(b_starts, np.float64), np.asarray(b_ends, np.float64))
    if a_starts.size == 0 or bs.size == 0:
        return 0.0
    return float((_coverage(bs, be, a_ends) - _coverage(bs, be, a_starts)).sum())


class DeviceTimeline:
    """The device operations of a traced window, on the host's clock.

    ``ops`` are (name, start_s, end_s) on the profiler's clock; ``marker_s``
    is where the window's first device operation, the marker, starts on that
    clock, and ``marker_host_s`` the host clock (``time.perf_counter``) just
    before it was launched, so host spans map onto the device's timeline.
    The window runs from the marker to ``end_host_s``.
    """

    def __init__(self, ops, marker_s: float, marker_host_s: float, end_host_s: float):
        self.names = [o[0] for o in ops]
        self.starts = np.asarray([o[1] for o in ops], np.float64) - marker_s + marker_host_s
        self.ends = np.asarray([o[2] for o in ops], np.float64) - marker_s + marker_host_s
        self.t0, self.t1 = marker_host_s, end_host_s
        self.busy_starts, self.busy_ends = _merge(self.starts, self.ends)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return float((np.minimum(self.busy_ends, self.t1)
                      - np.maximum(self.busy_starts, self.t0)).clip(0).sum())

    def kernel_s(self, substring: str) -> float:
        """Summed device time of the operations whose name holds ``substring``."""
        sel = np.asarray([substring in n for n in self.names], bool)
        return float((self.ends[sel] - self.starts[sel]).sum()) if sel.any() else 0.0

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the ``n`` operation names that took most time."""
        total: dict[str, float] = {}
        for name, s, e in zip(self.names, self.starts, self.ends):
            total[name[:96]] = total.get(name[:96], 0.0) + float(e - s)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self):
        """(starts, ends) of the spans of the window in which the device idled."""
        s = np.r_[self.t0, self.busy_ends]
        e = np.r_[self.busy_starts, self.t1]
        s, e = np.maximum(s, self.t0), np.minimum(e, self.t1)
        keep = e > s
        return s[keep], e[keep]

    def idle_by(self, spans: dict, inner: dict) -> list:
        """[name, seconds] of idle device time by what the host was doing.

        ``spans`` maps a name to the host's (starts, ends) of that activity,
        each disjoint within itself; ``inner`` maps a name to the names whose
        spans lie inside its own, whose time is taken out of it. Idle time
        under no span is ``other``.
        """
        gs, ge = self.gaps()
        cover = {n: overlap_s(gs, ge, st, en) for n, (st, en) in spans.items()}
        nested = {m for ms in inner.values() for m in ms}
        out = [[n, c - sum(cover[m] for m in inner.get(n, ()))] for n, c in cover.items()]
        top = sum(c for n, c in cover.items() if n not in nested)
        out.append(["other", float((ge - gs).sum()) - top])
        return sorted(out, key=lambda kv: -kv[1])
