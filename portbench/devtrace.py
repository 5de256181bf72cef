"""Device activity of a traced sub-window, from ``torch.profiler``.

A traced run (``--trace 1``) starts the profiler once the untraced part of
its window has closed and the card has gone idle, lets the tracer start up
in the profiler's warm-up step, and records ``trace_seconds`` (the traffic
file's parameter).  From the recorded events :func:`summarize` reads what
``--trace 1`` reports:

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, averaged over the chips used;
- ``window_s``: the recorded sub-window (the profiler's step span);
- ``device_ops``: device time by operation name;
- ``idle_by_host``: device-idle time by what the host was doing in the
  gap: the outermost and the innermost host operation running at the
  gap's middle, on the thread of the innermost.

On a card only the device's activity and the CUDA runtime calls are
recorded, so the host labels are those calls: recording every host
operation costs the host some microseconds an operation, which would
make a card-paced cell host-paced while it is traced.  Without a card the
host operations are recorded.

The reading of device events by ``device_type`` follows
``chip_smoke.py:device_activity`` at commit
0b0ab71f059163ae9965ca32cf2dcd973d378fb7.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: dict          # name -> seconds
    device_counts: dict       # name -> events
    idle_by_host: dict        # host label -> idle seconds


class TracedWindow:
    """The profiler over the last part of a measured window; inert when
    ``enabled`` is false."""

    def __init__(self, enabled: bool, *, chips: int = 1):
        self.enabled, self.chips = enabled, chips
        self.summary: TraceSummary | None = None
        self.prof = None
        self._ready = None

    def _keep(self, prof) -> None:
        self._ready = prof

    def begin(self) -> None:
        """Start the profiler and record from here on."""
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        activities, kw = [ProfilerActivity.CUDA], {}
        if not torch.cuda.is_available():
            activities.append(ProfilerActivity.CPU)
            try:    # host operations on every thread, not only this one
                from torch._C._profiler import _ExperimentalConfig
                kw["experimental_config"] = _ExperimentalConfig(
                    profile_all_threads=True)
            except (ImportError, TypeError):
                pass
        self.prof = profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=self._keep, **kw)
        self.prof.start()           # warm-up: the tracer initialises now
        self.prof.step()            # recording

    def finish(self) -> None:
        """Stop recording, once the window has closed, and summarise."""
        if self.prof is None or self.summary is not None:
            return
        self.prof.step()
        self.prof.stop()
        if self._ready is not None:
            self.summary = summarize(self._ready.events(), self.chips)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events, chips: int = 1) -> TraceSummary:
    """Busy time, device time by operation and idle time by host label of
    one recorded sub-window; times in the events are microseconds."""
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, host, steps = [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # the profiler's step mirrored onto the device is no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("ProfilerStep")):
                dev.append((tr.start, tr.end, e.name, e.device_index))
        elif e.device_type == cpu:
            if e.name.startswith(("ProfilerStep#", "ProfilerStep*")):
                steps.append((tr.start, tr.end))
            else:
                host.append((tr.start, tr.end, e.name, e.thread))
    spans = steps or [(a, b) for a, b, *_ in dev + host]
    if not spans:
        return TraceSummary(0.0, 0.0, {}, {}, {})
    w0, w1 = min(a for a, _ in spans), max(b for _, b in spans)
    ops, counts = collections.Counter(), collections.Counter()
    per_device = collections.defaultdict(list)
    for a, b, name, index in dev:
        if w0 <= a < w1:            # an operation counts whole where it starts
            ops[name] += (b - a) * 1e-6
            counts[name] += 1
        a, b = max(a, w0), min(b, w1)
        if b > a:
            per_device[index].append((a, b))
    merged = {i: _merge(iv) for i, iv in per_device.items()}
    busy = sum(b - a for iv in merged.values() for a, b in iv)
    idle = _label_gaps(_gaps(merged, w0, w1), host)
    return TraceSummary(busy_s=busy * 1e-6 / max(1, chips),
                        window_s=(w1 - w0) * 1e-6, device_ops=dict(ops),
                        device_counts=dict(counts), idle_by_host=idle)


def _gaps(merged: dict, w0: float, w1: float) -> list:
    """Idle intervals of the first device in the window (every chip of a
    one-chip cell)."""
    if not merged:
        return [(w0, w1)]
    iv = merged[min(merged)]
    out, t = [], w0
    for a, b in iv:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def _label_gaps(gaps: list, host: list) -> dict:
    """Sum the idle gaps by the host operations running at their middle:
    one sweep over gaps and host events, both in time order."""
    order = sorted(host)
    by_label = collections.Counter()
    active: list = []            # heap of (end, start, name, thread)
    k = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while k < len(order) and order[k][0] <= mid:
            s, e, name, th = order[k]
            heapq.heappush(active, (e, s, name, th))
            k += 1
        while active and active[0][0] <= mid:
            heapq.heappop(active)
        live = [x for x in active if x[0] > mid]
        if not live:
            label = "no host operation"
        else:
            inner = max(live, key=lambda x: x[1])
            outer = min((x for x in live if x[3] == inner[3]),
                        key=lambda x: x[1])
            label = inner[2] if outer is inner else \
                f"{outer[2]} > {inner[2]}"
        by_label[label] += (b - a) * 1e-6
    return dict(by_label)
