"""TM serving launcher: micro-batching scheduler under synthetic traffic
(port of ``repro.launch.tm_serve``: predict, learning, lifecycle,
shed-tier and fleet flags).

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
``--history-size`` bounds the ring of rollback targets.

``--shed-backend cascade`` arms the overload tier: batches dispatched
while the queue holds at least ``--shed-qdepth`` waiting items (0: every
batch) route to the exact early-exit cascade (``exact_sums=False``); the
live line gains ``shed=`` and ``esc=`` (the escalation rate):

    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \
        --backend mxu_fused --shed-backend cascade --clients 8

State lifecycle, in the JAX package's on-disk format (a snapshot either
launcher writes, the other resumes):

    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \
        --train-backend fused --checkpoint-dir /tmp/tm-ckpt \
        --checkpoint-every 20 --label-rate 10 --clients 8
    # kill it, then resume the update chain from the newest snapshot:
    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \
        --train-backend fused --checkpoint-dir /tmp/tm-ckpt --restore

``--checkpoint-every N`` snapshots every N applied updates on a writer
thread (``--checkpoint-keep`` newest kept; the live line shows
``ckpt@``); ``--restore`` resumes from the newest valid step;
``--ckpt-role follower`` waits up to ``--ckpt-wait`` seconds for a
leader's valid snapshot in a shared ``--checkpoint-dir``, restores it
and never writes.

Multi-tenant fleet: ``--models MANIFEST.json`` serves many named models
behind one scheduler through :class:`repro_torch.serve.TMFleet`.  The
manifest is the JAX launcher's: a JSON list of model entries, where every
field but ``name`` is optional and defaults to the matching flag, so
same-shape tenants (which the fleet packs into one fused serving plane)
need only names and seeds:

    [{"name": "mnist", "seed": 0},
     {"name": "kws", "seed": 1, "weight": 4.0},
     {"name": "big", "clauses": 512, "train_backend": "fused",
      "checkpoint_dir": "/tmp/tm-ckpt-big"}]

Per-model keys: ``name``, ``classes``/``clauses``/``features``/
``density``/``seed`` (shape), ``weight`` (a static engine-cache eviction
weight; omitted → the measured request share) and any ``TMServer``
lifecycle keyword (``train_backend``, ``train_seed``, ``checkpoint_dir``,
``checkpoint_every_updates``, ``checkpoint_keep``, ``history_size``).
``--cache-entries`` / ``--cache-bytes`` set the shared engine-cache
budget, ``--no-pack`` turns cross-model packing off (the control arm),
and traffic is split across tenants: closed-loop ``--clients``
round-robin, open-loop ``--rate`` evenly:

    PYTHONPATH=src python -m repro_torch.launch.tm_serve --device cpu \
        --models fleet.json --clauses 8 --features 16 --clients 8 \
        --duration 2

The mesh flags are not ported yet (see ROADMAP.md).
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
        ckpt = s["checkpoint"]
        if ckpt is not None and ckpt["last_step"] is not None:
            extra += f"  ckpt@{ckpt['last_step']}"
        tiers = s["tiers"]
        if tiers["shed_backend"] is not None or tiers["cascade_rows"]:
            extra += f"  shed={tiers['shed_batches']}"
            if tiers["cascade_rows"]:
                extra += f"  esc={tiers['escalation_rate']:.2f}"
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


class _ModelClient:
    """Adapter giving one fleet member the ``server.submit`` surface the
    load generators drive, so the same loops hammer a named model."""

    def __init__(self, fleet, name: str):
        self._fleet = fleet
        self._name = name

    async def submit(self, literals, *, client=None, **kwargs):
        return await self._fleet.submit(self._name, literals,
                                        client=client, **kwargs)


def _load_manifest(path: str, args) -> dict:
    """Parse a ``--models`` JSON manifest → TMFleet spec dict.

    Unspecified shape fields fall back to the flags, so a manifest of
    bare ``{"name": ..., "seed": ...}`` entries yields same-shape tenants
    that pack into one fused serving plane."""
    import json
    with open(path) as fh:
        manifest = json.load(fh)
    if not isinstance(manifest, list):
        raise SystemExit(f"--models {path}: expected a JSON list of "
                         f"model entries, got {type(manifest).__name__}")
    specs = {}
    for i, ent in enumerate(manifest):
        ent = dict(ent)
        try:
            name = ent.pop("name")
        except KeyError:
            raise SystemExit(f"--models {path}: entry {i} has no 'name'")
        if name in specs:
            raise SystemExit(f"--models {path}: duplicate model "
                             f"name {name!r}")
        cfg, state = build_tm(ent.pop("classes", args.classes),
                              ent.pop("clauses", args.clauses),
                              ent.pop("features", args.features),
                              density=ent.pop("density", args.density),
                              seed=ent.pop("seed", args.seed),
                              device=args.device)
        # whatever remains (weight + TMServer lifecycle keywords) rides
        # through the spec dict: TMFleet pops 'weight' and hands the rest
        # to the member TMServer
        if ent.get("train_backend") and "train_seed" not in ent:
            ent["train_seed"] = args.seed
        specs[name] = {"cfg": cfg, "state": state, **ent}
    return specs


async def _fleet_stats_printer(fleet, every: float) -> None:
    """One aggregate live line per ``every`` seconds until cancelled."""
    t0 = time.monotonic()
    prev = 0
    while True:
        await asyncio.sleep(every)
        s = fleet.stats()
        total = sum(m["requests"] for m in s["models"].values())
        rps = (total - prev) / every
        prev = total
        worst = max((m["p99_ms"] for m in s["models"].values()
                     if m["p99_ms"] is not None), default=0.0)
        cache = s["engine_cache"]
        hits = cache["hits"] + cache["misses"]
        print(f"[t+{time.monotonic() - t0:5.1f}s] {rps:8.0f} req/s  "
              f"models={len(s['models'])}  groups={len(s['groups'])}  "
              f"worst_p99={worst:.2f}ms  "
              f"cache_hit={cache['hits'] / max(hits, 1):.3f}",
              flush=True)


async def _run_fleet(args) -> None:
    """``--models`` mode: serve a manifest of named models as a fleet on
    ``--device``, splitting the requested traffic across tenants."""
    from repro_torch.serve import ServePolicy, TMFleet, closed_loop, \
        open_loop

    specs = _load_manifest(args.models, args)
    policy = ServePolicy(max_batch=args.max_batch,
                         max_wait_us=args.max_wait_us,
                         queue_depth=args.queue_depth,
                         backend=args.backend,
                         shed_backend=args.shed_backend,
                         shed_qdepth=args.shed_qdepth,
                         pipeline_depth=args.pipeline_depth)
    fleet = TMFleet(specs, policy, pack=not args.no_pack,
                    device=args.device,
                    cache_entries=args.cache_entries or None,
                    cache_bytes=args.cache_bytes or None)
    names = fleet.model_names()
    pools = {}
    for i, name in enumerate(names):
        cfg = fleet.server_for(name).cfg
        rng = np.random.default_rng(args.seed + 10_000 + i)
        pools[name] = rng.integers(0, 2, (1024, cfg.n_literals),
                                   dtype=np.int8)
    async with fleet:
        s = fleet.stats()
        print(f"fleet: {len(names)} models, {len(s['groups'])} pack "
              f"group(s) on {fleet.device}" + (
                  "" if not s["groups"] else "  " + "  ".join(
                      f"[{'+'.join(g['members'])}: "
                      f"{g['fused_classes']} fused classes]"
                      for g in s["groups"])))
        t0 = time.monotonic()
        await fleet.warmup()
        print(f"warmup in {time.monotonic() - t0:.2f}s")

        printer = asyncio.ensure_future(
            _fleet_stats_printer(fleet, args.stats_every))
        t0 = time.monotonic()
        try:
            if args.clients:
                # round-robin split, every tenant gets at least one caller
                per = [max(1, args.clients // len(names)
                           + (1 if i < args.clients % len(names) else 0))
                       for i in range(len(names))]
                served = sum(await asyncio.gather(*[
                    closed_loop(_ModelClient(fleet, name), pools[name],
                                clients=n, duration=args.duration)
                    for name, n in zip(names, per)]))
                mode = (f"closed-loop x{args.clients} over {len(names)} "
                        f"models")
            else:
                rate = args.rate / len(names)
                served = sum(await asyncio.gather(*[
                    open_loop(_ModelClient(fleet, name), pools[name],
                              rate=rate, duration=args.duration,
                              rng=np.random.default_rng(
                                  args.seed + 20_000 + i))
                    for i, name in enumerate(names)]))
                mode = (f"open-loop {args.rate:.0f}/s over {len(names)} "
                        f"models")
        finally:
            printer.cancel()
        wall = time.monotonic() - t0

        s = fleet.stats()
        print(f"\n{mode}: {served} requests in {wall:.2f}s "
              f"({served / wall:,.0f} req/s aggregate)")
        for name in names:
            m = s["models"][name]
            plane = (f"group {m['group']} seg {m['segment']}"
                     if m["packed"] else "solo")
            print(f"  {name:>12}: {m['requests']:6d} req  "
                  f"p50={m['p50_ms'] or 0:.2f}ms  "
                  f"p99={m['p99_ms'] or 0:.2f}ms  v{m['version']}  "
                  f"weight={m['weight']:.3f}  errors={m['errors_total']}  "
                  f"[{plane}]")
        cache = s["engine_cache"]
        print(f"engine cache: {cache['hits']} hits  {cache['misses']} "
              f"misses  {cache['evictions']} evictions  "
              f"{cache['superseded']} superseded  "
              f"(size {cache['size']}/{cache['maxsize']}, "
              f"{cache['bytes']} bytes)")


async def _run(args) -> None:
    from repro_torch.serve import ServePolicy, TMServer, closed_loop, \
        open_loop
    if args.models:
        await _run_fleet(args)
        return
    cfg, state = build_tm(args.classes, args.clauses, args.features,
                          density=args.density, seed=args.seed,
                          device=args.device)
    policy = ServePolicy(max_batch=args.max_batch,
                         max_wait_us=args.max_wait_us,
                         queue_depth=args.queue_depth,
                         backend=args.backend,
                         shed_backend=args.shed_backend,
                         shed_qdepth=args.shed_qdepth,
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
    follower = args.ckpt_role == "follower"
    if follower and not args.checkpoint_dir:
        raise SystemExit("--ckpt-role follower needs --checkpoint-dir")
    if args.restore and not args.checkpoint_dir:
        raise SystemExit("--restore needs --checkpoint-dir")
    server = TMServer(cfg, state, policy, device=args.device,
                      train_backend=args.train_backend or None,
                      train_seed=args.seed,
                      checkpoint_dir=None if follower
                      else args.checkpoint_dir,
                      checkpoint_every_updates=0 if follower
                      else args.checkpoint_every,
                      checkpoint_keep=args.checkpoint_keep,
                      history_size=args.history_size,
                      probe=probe, probe_every_updates=args.probe_every)
    if follower:
        # a follower never writes to the shared directory: it waits for
        # the leader's atomic rename to land a .complete marker
        from repro_torch import checkpoint as ckpt
        step = ckpt.wait_for_complete(args.checkpoint_dir,
                                      timeout=args.ckpt_wait)
        version = server.restore(args.checkpoint_dir)
        print(f"follower: restored step_{step} from {args.checkpoint_dir} "
              f"at state version {version} (read-only)")
    elif args.restore:
        version = server.restore()
        print(f"restored from {args.checkpoint_dir} at state version "
              f"{version} (resuming the deterministic update chain)")
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
                  f"{len(rejects)} rejected at admission; "
                  f"{dl['slack_shed_batches']} batches slack-shed")
        if s["checkpoint"] is not None:
            c = s["checkpoint"]
            print(f"checkpoints: dir={c['dir']}  last_step={c['last_step']}"
                  f"  restored_from={c['restored_from']}  "
                  f"history={s['history']['versions']}")
        if s["probe"] is not None and s["probe"]["accuracy"] is not None:
            p = s["probe"]
            print(f"drift probe: acc={p['accuracy']:.3f}  "
                  f"best={p['best']:.3f}  drift={p['drift']:+.3f}  "
                  f"({p['evals']} evals, last at v{p['at_version']})")
        tiers, cache = s["tiers"], s["engine_cache"]
        if tiers["shed_backend"] is not None:
            print(f"shed tier ({tiers['shed_backend']}, qdepth>="
                  f"{tiers['shed_qdepth']}): {tiers['shed_batches']} "
                  f"batches / {tiers['shed_rows']} rows shed; "
                  f"escalated {tiers['escalated_rows']}/"
                  f"{tiers['cascade_rows']} rows "
                  f"(rate {tiers['escalation_rate']:.3f})")
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
    ap.add_argument("--shed-backend", default=None,
                    help="overload-tier backend (typically 'cascade'): "
                         "batches shed here when qdepth crosses "
                         "--shed-qdepth")
    ap.add_argument("--shed-qdepth", type=int, default=0,
                    help="queue depth at dispatch that triggers shedding "
                         "(0 = shed every batch when --shed-backend set)")
    ap.add_argument("--train-backend", default=None,
                    help="TrainEngine name (reference/packed/fused/"
                         "sparse): serve "
                         "and learn concurrently from a label feeder")
    ap.add_argument("--label-rate", type=float, default=10.0,
                    help="labeled feedback batches per second")
    ap.add_argument("--label-batch", type=int, default=32,
                    help="rows per labeled feedback batch")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist lifecycle snapshots here (the JAX "
                         "package's on-disk format)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="async snapshot every N applied updates "
                         "(0 = only on graceful stop; needs "
                         "--checkpoint-dir)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="newest valid snapshots retained on disk")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest valid snapshot in "
                         "--checkpoint-dir before serving")
    ap.add_argument("--ckpt-role", choices=("leader", "follower"),
                    default="leader",
                    help="shared --checkpoint-dir discipline: the leader "
                         "writes, a follower waits for a valid snapshot, "
                         "restores it and never writes")
    ap.add_argument("--ckpt-wait", type=float, default=60.0,
                    help="follower: seconds to wait for the leader's "
                         "first valid checkpoint")
    ap.add_argument("--history-size", type=int, default=8,
                    help="bounded in-memory ring of recent (version, "
                         "state) rollback targets")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="score the held-out probe stream every N "
                         "applied updates (0 = off; needs "
                         "--train-backend)")
    ap.add_argument("--probe-size", type=int, default=256,
                    help="rows in the held-out drift probe stream")
    ap.add_argument("--models", default=None, metavar="MANIFEST.json",
                    help="serve a JSON manifest of named models as a "
                         "TMFleet (see the module docstring for the "
                         "format; shape fields default to the flags "
                         "above)")
    ap.add_argument("--no-pack", action="store_true",
                    help="fleet mode: disable cross-model batch packing "
                         "(every tenant serves solo — the A/B control)")
    ap.add_argument("--cache-entries", type=int, default=0,
                    help="fleet mode: shared engine-cache entry budget "
                         "(0 = leave the process default)")
    ap.add_argument("--cache-bytes", type=int, default=0,
                    help="fleet mode: shared engine-cache byte budget "
                         "(0 = unlimited)")
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
