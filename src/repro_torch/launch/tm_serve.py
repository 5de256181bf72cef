"""TM serving launcher: micro-batching scheduler under synthetic traffic
(port of ``repro.launch.tm_serve``: predict and learning flags).

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
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \\
        --backend mxu_fused --train-backend fused --label-rate 10 \\
        --probe-every 2 --clients 8 --duration 4
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \\
        --train-backend sparse --label-rate 10 --clients 8 --duration 4
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \\
        --backend time_domain --features 784 --clauses 50 --clients 8

``--backend`` pins one backend.  Without it, buckets route by include
density, which picks ``sparse_csr`` at the default 5% density, as the
JAX launcher does.
``--deadline-us N`` attaches an N-microsecond completion deadline to a
``--priority-mix`` fraction of the predicts (the rest are best-effort);
the live line then gains ``miss=``/``adm=`` fields.

``--train-backend`` serves and learns at once: a label feeder offers
``--label-rate`` batches/s of ``--label-batch`` rows (Poisson), labeled by
a fixed random teacher machine built from ``--seed``, and the live line
gains ``ver=``.  ``--probe-every N`` scores ``--probe-size`` held-out
teacher-labeled rows every N applied updates (``acc=``/``drift=``);
``--history-size`` bounds the ring of rollback targets.  The checkpoint,
fleet and mesh flags are not ported yet (see ROADMAP.md).
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
        extra = (f"  ver={s['state_version']}" if s["updates"] or
                 s["state_version"] else "")
        probe = s["probe"]
        if probe is not None and probe["accuracy"] is not None:
            extra += (f"  acc={probe['accuracy']:.3f}"
                      f"  drift={probe['drift']:+.3f}")
        dl = s["deadline"]
        if dl["requests"] or dl["admission_rejects"]:
            extra += (f"  miss={dl['miss_rate']:.3f}"
                     f"  adm={dl['admission_rejects']}")
        print(f"[t+{time.monotonic() - t0:5.1f}s] {rps:8.0f} req/s  "
              f"qdepth={s['qdepth']:4d}  "
              f"fill={s['batch_fill']:.2f}  "
              f"mean_batch={s['mean_batch_rows']:.1f}  "
              f"p50={s['p50_ms']:.2f}ms  p99={s['p99_ms']:.2f}ms{extra}",
              flush=True)


async def _label_feeder(server, pool, labels, *, rate: float, batch: int,
                        rng) -> None:
    """Offer ``rate`` labeled batches/s (Poisson) until cancelled.

    Fire-and-forget: pending updates queue against the server's bounded
    update gate (backpressure), like open-loop predicts."""
    pending: set[asyncio.Task] = set()
    next_t = time.monotonic()
    while True:
        next_t += rng.exponential(1.0 / rate)
        delay = next_t - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        rows = rng.integers(0, len(pool), batch)
        task = asyncio.ensure_future(
            server.submit_labeled(pool[rows], labels[rows]))
        pending.add(task)

        def _done(t: asyncio.Task) -> None:
            pending.discard(t)
            if not t.cancelled():
                t.exception()       # retrieve: no 'never retrieved' noise

        task.add_done_callback(_done)


def _teacher_labels(cfg, args, lits: np.ndarray) -> np.ndarray:
    """Labels from a fixed random teacher machine (``--seed`` + 2): the
    served TM has something consistent to adapt toward."""
    from repro_torch.engine import get_engine
    _, teacher = build_tm(args.classes, args.clauses, args.features,
                          density=args.density, seed=args.seed + 2,
                          device=args.device)
    return get_engine("oracle", cfg, teacher).infer(lits) \
        .prediction.cpu().numpy()


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
    labels = probe = None
    if args.train_backend:
        labels = _teacher_labels(cfg, args, pool)
        if args.probe_every:
            # held-out rows the feeder never submits, teacher-labeled
            probe_lits = np.random.default_rng(args.seed + 4).integers(
                0, 2, (args.probe_size, cfg.n_literals), dtype=np.int8)
            probe = (probe_lits, _teacher_labels(cfg, args, probe_lits))
    server = TMServer(cfg, state, policy, device=args.device,
                      train_backend=args.train_backend or None,
                      train_seed=args.seed, history_size=args.history_size,
                      probe=probe, probe_every_updates=args.probe_every)
    async with server:
        print(f"TM C={cfg.n_classes} M={cfg.n_clauses} F={cfg.n_features} "
              f"density={args.density}  device={server.device}  "
              f"buckets={server.buckets}")
        print(f"routing: {server.stats()['routing']}")
        t0 = time.monotonic()
        await server.warmup(train_batches=(args.label_batch,)
                            if args.train_backend else ())
        print(f"warmup: {len(server.buckets)} buckets in "
              f"{time.monotonic() - t0:.2f}s")
        printer = asyncio.ensure_future(
            _stats_printer(server, args.stats_every))
        feeder = None
        if args.train_backend:
            feeder = asyncio.ensure_future(
                _label_feeder(server, pool, labels, rate=args.label_rate,
                              batch=args.label_batch,
                              rng=np.random.default_rng(args.seed + 3)))
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
            if feeder is not None:
                feeder.cancel()
        wall = time.monotonic() - t0
        s = server.stats()
        mode = (f"closed-loop x{args.clients}" if args.clients
                else f"open-loop {args.rate:.0f}/s")
        learn = (f"  state_version={s['state_version']} "
                 f"({s['update_rows']} labeled rows)"
                 if args.train_backend else "")
        print(f"\n{mode}: {served} requests in {wall:.2f}s "
              f"({served / wall:,.0f} req/s)  "
              f"batches={s['batches']}  fill={s['batch_fill']:.2f}  "
              f"p50={s['p50_ms']:.2f}ms  p99={s['p99_ms']:.2f}ms{learn}")
        if args.deadline_us:
            dl = s["deadline"]
            print(f"deadline {args.deadline_us}us (mix "
                  f"{args.priority_mix:.2f}, pipeline depth "
                  f"{args.pipeline_depth}): {dl['requests']} deadline "
                  f"requests, {dl['misses']} missed "
                  f"(rate {dl['miss_rate']:.3f}); "
                  f"{len(rejects)} rejected at admission")
        if s["probe"] is not None and s["probe"]["accuracy"] is not None:
            p = s["probe"]
            print(f"drift probe: acc={p['accuracy']:.3f}  "
                  f"best={p['best']:.3f}  drift={p['drift']:+.3f}  "
                  f"({p['evals']} evals, last at v{p['at_version']})")
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
    ap.add_argument("--train-backend", default=None,
                    help="TrainEngine name (reference/packed/fused/"
                         "sparse): serve "
                         "and learn concurrently from a label feeder")
    ap.add_argument("--label-rate", type=float, default=10.0,
                    help="labeled feedback batches per second")
    ap.add_argument("--label-batch", type=int, default=32,
                    help="rows per labeled feedback batch")
    ap.add_argument("--history-size", type=int, default=8,
                    help="bounded in-memory ring of recent (version, "
                         "state) rollback targets")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="score the held-out probe stream every N "
                         "applied updates (0 = off; needs "
                         "--train-backend)")
    ap.add_argument("--probe-size", type=int, default=256,
                    help="rows in the held-out drift probe stream")
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
