"""Shared traffic generators + SLO primitives for the TM serving layer
(port of ``repro.serve.loadgen``).

One implementation of the two canonical load shapes, used by the
``repro_torch.launch.tm_serve`` launcher and ``chip_smoke.py``:

- :func:`open_loop` — Poisson arrivals at a fixed offered rate,
  independent of service latency (overload shows up as queueing).
- :func:`closed_loop` — ``clients`` lockstep callers, each firing its
  next request the moment the previous one resolves (batch-heavy load).

Both send single-sample requests drawn round-robin from a literal pool
and return the number of requests served; ``on_result(row, result)``
lets callers verify each response (a bit-exact parity check).

Deadline traffic: both generators take ``deadline_us`` (per-request slack
budget forwarded to ``TMServer.submit``) and ``deadline_fraction`` (the
priority mix — that fraction of requests carries the deadline at
priority 0, the rest is best-effort at ``bg_priority``).  A request the
server *rejects at admission* (:class:`DeadlineExceeded` — it provably
could not have met its deadline) is counted via ``on_reject`` and
excluded from the returned served count; any other submit error still
propagates.

:class:`DeadlineExceeded` lives here rather than in ``tm_server``
because the traffic generators must catch it and ``tm_server`` already
imports this module — it is the serving layer's shared SLO vocabulary.
"""

from __future__ import annotations

import asyncio
import time

from repro_torch.engine.base import nearest_rank

__all__ = ["DeadlineExceeded", "open_loop", "closed_loop", "percentiles_ms"]


class DeadlineExceeded(RuntimeError):
    """A request was rejected at admission: given the measured per-bucket
    service times, it provably could not meet its deadline — failing fast
    beats burning compute on a response that arrives too late."""


def percentiles_ms(latencies, ps: tuple[float, ...] = (0.50, 0.99)) -> tuple:
    """Percentiles (default p50, p99) in milliseconds from per-request
    latencies in seconds — the one percentile definition (nearest-rank,
    see :func:`repro_torch.engine.base.nearest_rank`) shared by
    ``TMServer.stats`` and the per-bucket service rings."""
    lat = sorted(latencies)
    if not lat:
        return tuple(0.0 for _ in ps)
    return tuple(round(nearest_rank(lat, p) * 1e3, 3) for p in ps)


def _submit_kwargs(rng, *, deadline_us, deadline_fraction, bg_priority):
    """Per-request deadline/priority kwargs for one arrival: a
    ``deadline_fraction`` coin-flip carries the deadline at priority 0,
    the rest is best-effort at ``bg_priority`` (the priority mix)."""
    if deadline_us is None:
        return {}
    if deadline_fraction >= 1.0 or rng.random() < deadline_fraction:
        return {"deadline_us": deadline_us, "priority": 0}
    return {"priority": bg_priority}


async def _timed_submit(server, lits, client, kwargs, t_arrival,
                        latencies: list):
    """Await one submit, recording client-perceived latency (arrival →
    response, backpressure wait included) for served requests."""
    res = await server.submit(lits, client=client, **kwargs)
    latencies.append(time.monotonic() - t_arrival)
    return res


async def open_loop(server, pool, *, rate: float, duration: float,
                    rng, client: int = 0, on_result=None,
                    deadline_us: int | None = None,
                    deadline_fraction: float = 1.0, bg_priority: int = 1,
                    on_reject=None, latencies: list | None = None) -> int:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds.

    Absolute-time pacing: when the loop falls behind (sleep granularity,
    GIL), arrivals burst to catch up instead of silently lowering the
    offered rate.  Returns the number of requests *served* — admission
    rejections (``DeadlineExceeded``) are reported through ``on_reject``
    and excluded; any other error propagates.  Pass a ``latencies``
    list to additionally collect each served request's client-perceived
    latency in seconds (arrival to response, so queue backpressure
    counts — the client-side view an SLO is scored against, available
    whether or not the traffic carries server-side deadlines).
    """
    tasks: list[asyncio.Task] = []
    rows: list[int] = []
    start = time.monotonic()
    next_t = start
    i = 0
    while time.monotonic() < start + duration:
        next_t += rng.exponential(1.0 / rate)
        delay = next_t - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        row = i % len(pool)
        rows.append(row)
        kwargs = _submit_kwargs(rng, deadline_us=deadline_us,
                                deadline_fraction=deadline_fraction,
                                bg_priority=bg_priority)
        lits = pool[row:row + 1]
        if latencies is None:
            coro = server.submit(lits, client=client, **kwargs)
        else:
            coro = _timed_submit(server, lits, client, kwargs,
                                 time.monotonic(), latencies)
        tasks.append(asyncio.ensure_future(coro))
        i += 1
    results = await asyncio.gather(*tasks, return_exceptions=True)
    served = 0
    for row, res in zip(rows, results):
        if isinstance(res, DeadlineExceeded):
            if on_reject is not None:
                on_reject(row, res)
            continue
        if isinstance(res, BaseException):
            raise res
        served += 1
        if on_result is not None:
            on_result(row, res)
    return served


async def closed_loop(server, pool, *, clients: int, duration: float,
                      on_result=None, deadline_us: int | None = None,
                      deadline_fraction: float = 1.0, bg_priority: int = 1,
                      rng=None, on_reject=None) -> int:
    """``clients`` lockstep callers for ``duration`` seconds; each caller
    fires its next request the moment the previous one resolves (an
    admission rejection resolves it too — the caller moves on)."""
    import numpy as np
    end = time.monotonic() + duration
    counts = [0] * clients
    rngs = [np.random.default_rng(0x5EED + c) if rng is None else rng
            for c in range(clients)]

    async def caller(cid: int) -> None:
        i = cid
        while time.monotonic() < end:
            row = i % len(pool)
            kwargs = _submit_kwargs(rngs[cid], deadline_us=deadline_us,
                                    deadline_fraction=deadline_fraction,
                                    bg_priority=bg_priority)
            try:
                res = await server.submit(pool[row:row + 1], client=cid,
                                          **kwargs)
            except DeadlineExceeded as exc:
                if on_reject is not None:
                    on_reject(row, exc)
            else:
                if on_result is not None:
                    on_result(row, res)
                counts[cid] += 1
            i += clients

    await asyncio.gather(*[caller(c) for c in range(clients)])
    return sum(counts)
