"""TM serving launcher: micro-batching scheduler under synthetic traffic
(port of ``repro.launch.tm_serve``, predict-only flags).

Builds a TM at trained-machine include density on ``--device`` (default
cuda), warms up every bucket's engine (building the CUDA kernels at first
use), then drives :class:`repro_torch.serve.TMServer` with an open-loop
(Poisson arrivals) or closed-loop (``--clients`` lockstep callers)
traffic source, printing periodic stats: queue depth, batch fill and
p50/p99 latency.

    PYTHONPATH=src python -m repro_torch.launch.tm_serve \\
        --backend mxu_fused --features 784 --clauses 50 --rate 2000
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \\
        --backend swar_packed --clients 8 --duration 2

``--backend`` pins one backend.  Without it, buckets route by include
density, which picks ``sparse_csr`` at the default 5% density — a
backend the port does not have yet, so every batch then fails.
``--deadline-us N`` attaches an N-microsecond completion deadline to a
``--priority-mix`` fraction of the predicts (the rest are best-effort);
the live line then gains ``miss=``/``adm=`` fields.
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np


def build_tm(c: int, m: int, f: int, *, density: float, seed: int,
             device=None):
    """A TM at ``density`` include density from a seeded numpy generator —
    the same draw as the JAX launcher's ``build_tm`` for the same seed."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.tm import TMConfig
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, cfg.n_literals)) < density,
                  cfg.n_states + 1, cfg.n_states)
    return cfg, state_from_numpy(ta, device=device)


async def _stats_printer(server, every: float) -> None:
    """Print one live stats line per ``every`` seconds until cancelled."""
    t0 = time.monotonic()
    prev = 0
    while True:
        await asyncio.sleep(every)
        s = server.stats()
        rps = (s["requests"] - prev) / every
        prev = s["requests"]
        extra = ""
        dl = s["deadline"]
        if dl["requests"] or dl["admission_rejects"]:
            extra = (f"  miss={dl['miss_rate']:.3f}"
                     f"  adm={dl['admission_rejects']}")
        print(f"[t+{time.monotonic() - t0:5.1f}s] {rps:8.0f} req/s  "
              f"qdepth={s['qdepth']:4d}  "
              f"fill={s['batch_fill']:.2f}  "
              f"mean_batch={s['mean_batch_rows']:.1f}  "
              f"p50={s['p50_ms']:.2f}ms  p99={s['p99_ms']:.2f}ms{extra}",
              flush=True)


async def _run(args) -> None:
    from repro_torch.serve import ServePolicy, TMServer, closed_loop, \
        open_loop
    cfg, state = build_tm(args.classes, args.clauses, args.features,
                          density=args.density, seed=args.seed,
                          device=args.device)
    policy = ServePolicy(max_batch=args.max_batch,
                         max_wait_us=args.max_wait_us,
                         queue_depth=args.queue_depth,
                         backend=args.backend,
                         pipeline_depth=args.pipeline_depth)
    rng = np.random.default_rng(args.seed + 1)
    pool = rng.integers(0, 2, (4096, cfg.n_literals), dtype=np.int8)
    server = TMServer(cfg, state, policy, device=args.device)
    async with server:
        print(f"TM C={cfg.n_classes} M={cfg.n_clauses} F={cfg.n_features} "
              f"density={args.density}  device={server.device}  "
              f"buckets={server.buckets}")
        print(f"routing: {server.stats()['routing']}")
        t0 = time.monotonic()
        await server.warmup()
        print(f"warmup: {len(server.buckets)} buckets in "
              f"{time.monotonic() - t0:.2f}s")
        printer = asyncio.ensure_future(
            _stats_printer(server, args.stats_every))
        rejects = []
        slo = dict(deadline_us=args.deadline_us or None,
                   deadline_fraction=args.priority_mix,
                   on_reject=lambda row, exc: rejects.append(row))
        t0 = time.monotonic()
        try:
            if args.clients:
                served = await closed_loop(server, pool,
                                           clients=args.clients,
                                           duration=args.duration, **slo)
            else:
                served = await open_loop(server, pool, rate=args.rate,
                                         duration=args.duration, rng=rng,
                                         **slo)
        finally:
            printer.cancel()
        wall = time.monotonic() - t0
        s = server.stats()
        mode = (f"closed-loop x{args.clients}" if args.clients
                else f"open-loop {args.rate:.0f}/s")
        print(f"\n{mode}: {served} requests in {wall:.2f}s "
              f"({served / wall:,.0f} req/s)  "
              f"batches={s['batches']}  fill={s['batch_fill']:.2f}  "
              f"p50={s['p50_ms']:.2f}ms  p99={s['p99_ms']:.2f}ms")
        if args.deadline_us:
            dl = s["deadline"]
            print(f"deadline {args.deadline_us}us (mix "
                  f"{args.priority_mix:.2f}, pipeline depth "
                  f"{args.pipeline_depth}): {dl['requests']} deadline "
                  f"requests, {dl['misses']} missed "
                  f"(rate {dl['miss_rate']:.3f}); "
                  f"{len(rejects)} rejected at admission")
        cache = s["engine_cache"]
        print(f"engine cache: {cache['hits']} hits  {cache['misses']} "
              f"misses  {cache['evictions']} evictions  "
              f"(size {cache['size']}/{cache['maxsize']})")


def main(argv: list[str] | None = None) -> None:
    """CLI entry point: parse flags, stand up the server, drive traffic
    (``argv`` overrides ``sys.argv``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--clauses", type=int, default=100)
    ap.add_argument("--features", type=int, default=196)
    ap.add_argument("--density", type=float, default=0.05,
                    help="include density (trained machines ≈ 0.05)")
    ap.add_argument("--backend", default=None,
                    help="pin one backend (default: route per bucket)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-us", type=int, default=2000)
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="dispatched batches in flight at once "
                         "(1 = serial scheduler)")
    ap.add_argument("--deadline-us", type=int, default=0,
                    help="per-request completion deadline in us "
                         "(0 = no deadlines)")
    ap.add_argument("--priority-mix", type=float, default=1.0,
                    help="fraction of requests carrying the deadline at "
                         "priority 0; the rest go best-effort at "
                         "priority 1")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="open-loop Poisson arrival rate (req/s)")
    ap.add_argument("--clients", type=int, default=0,
                    help="closed-loop concurrent callers (0 → open loop)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--stats-every", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    asyncio.run(_run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
