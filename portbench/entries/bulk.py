"""Bulk classification: fixed-size calls of the engine entry
(``repro_torch.engine.infer_padded``) over a pool of seeded rows.

Traffic parameters (``portbench/traffic/<name>.json``):

- ``rows_per_call``: rows of each call, which is also its bucket;
- ``pool_chunks``: distinct chunks of rows, drawn from the seed; call
  ``i`` classifies chunk ``i mod pool_chunks``;
- ``in_flight``: calls at most in flight.  The chunks stay resident on
  the card; each call's prediction and class sums, and the race's
  ``latency_ps`` and ``metastable`` where the backend returns them, are
  copied into pinned host memory;
- ``check_calls``, ``check_stride``: the sample of calls whose results
  are kept and compared with the reference: ``check_calls`` spread over
  the chunks, each chunk's share spread over the window
  (:class:`harness.Reservoir` over that chunk's calls);
- ``trace_seconds``: the last part of the window a traced run records
  (:mod:`portbench.devtrace`).

A row is one classified row: its prediction and class sums (and the
race's ``latency_ps`` and ``metastable``) back in host memory; a call's
rows count once its results are there.  The rate, the calls' spans and
the step's share of the peak are read over the untraced part of the
window, from the first call to the last result: the whole window of a
``--trace 0`` run.  A ``--trace 1`` run then waits for the
card, starts the profiler and records ``trace_seconds`` more.

The hooks of :data:`portbench.spec.ENTRY_HOOKS` besides :func:`run`:
:func:`small_cell`, :func:`check_config`, :func:`check_run` and
:func:`control`.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from portbench import harness, inputs
from portbench.devtrace import TracedWindow
from portbench.reference import tm as ref

# Every comparison is exact: integer votes, and the ideal device's delays
# rounded once to float32.  Sound runs read 0 on every seed; the controls
# (portbench/control.py) read thousands.
LIMITS = {"pred_mismatch": 0, "sums_mismatch": 0, "latency_mismatch": 0,
          "metastable_mismatch": 0}
# a run whose sample holds no call compared nothing: ``sample_missing`` 1
AUX = ("latency_ps", "metastable")
# the traffic at the sizes of the CPU tests: whole runs, and the control
SMALL = {"run": dict(rows_per_call=96, pool_chunks=2, check_calls=4,
                     check_stride=1, trace_seconds=0.1),
         "control": dict(rows_per_call=4096, pool_chunks=1)}


def tm_config(config: dict):
    """The program's ``TMConfig`` for a configuration file."""
    from repro_torch.core.tm import TMConfig
    return TMConfig(n_classes=config["n_classes"],
                    n_clauses=config["n_clauses"],
                    n_features=config["n_features"],
                    n_states=config["n_states"], T=config["T"],
                    s=config["s"])


def engine_opts(config: dict) -> dict:
    """Constructor options of the configuration's inference backend."""
    if "pdl" not in config:
        return {}
    from repro_torch.core.time_domain import PDLConfig
    p = config["pdl"]
    return {"pdl": PDLConfig(d_low=p["d_low"], d_high=p["d_high"],
                             sigma_elem=0.0, sigma_noise=0.0,
                             t_res=p["t_res"])}


def _host_buffers(res, aux: tuple, pinned: bool) -> dict:
    """Host memory for one call's results (page-locked on a card, where
    the copies run asynchronously)."""
    out = {"prediction": torch.empty(res.prediction.shape, dtype=torch.int32,
                                     pin_memory=pinned),
           "class_sums": torch.empty(res.class_sums.shape, dtype=torch.int32,
                                     pin_memory=pinned)}
    for k in aux:
        out[k] = torch.empty(res.aux[k].shape, dtype=res.aux[k].dtype,
                             pin_memory=pinned)
    return out


def _copy_out(res, buf: dict) -> None:
    buf["prediction"].copy_(res.prediction, non_blocking=True)
    buf["class_sums"].copy_(res.class_sums, non_blocking=True)
    for k, v in res.aux.items():
        if k in buf:
            buf[k].copy_(v, non_blocking=True)


def sample_plan(seed: int, n_chunks: int, check_calls: int, stride: int
                ) -> list:
    """One :class:`harness.Reservoir` a chunk, over that chunk's calls in
    order, together keeping about ``check_calls``: every chunk of the
    pool is compared, each at calls spread over the whole window."""
    offset = harness.seed_offset(seed, stride)
    per_chunk = -(-check_calls // n_chunks)
    return [harness.Reservoir(per_chunk, stride, offset)
            for _ in range(n_chunks)]


def run(run: harness.Run) -> None:
    from repro_torch.core.tm import TMState
    from repro_torch.engine import clear_engine_cache, get_engine, \
        infer_padded
    cfg_j, tr = run.cell.config, run.cell.traffic
    dev = run.device
    on_cuda = dev.type == "cuda"
    rows, n_chunks = tr["rows_per_call"], tr["pool_chunks"]
    in_flight = tr["in_flight"]

    run.mark("imports")
    gen = inputs.generator(run.seed, dev)
    ta = inputs.tm_state(cfg_j, gen)
    pool = inputs.literal_rows(gen, (n_chunks, rows), cfg_j["n_features"])
    chunks = [pool[i] for i in range(n_chunks)]
    run.mark("inputs")
    engine = get_engine(cfg_j["backend"], tm_config(cfg_j),
                        TMState(ta=ta.clone()), **engine_opts(cfg_j))

    run.mark("engine")
    # warm-up: the one shape, as many calls as may be in flight
    for i in range(max(2, in_flight)):
        res = infer_padded(engine, chunks[i % n_chunks], rows)
    aux = tuple(k for k in AUX if k in res.aux)
    slots = [_host_buffers(res, aux, on_cuda) for _ in range(in_flight)]
    samples = sample_plan(run.seed, n_chunks, tr["check_calls"],
                          tr["check_stride"])
    # fill the page-locked allocator's cache for the sample's buffers:
    # held together, then freed, they stay cached for the window
    held = [_host_buffers(res, aux, on_cuda) for _ in range(
        sum(s.capacity + 1 for s in samples) + in_flight)]
    del held
    _wait(dev)
    run.mark("warm-up")
    tw = TracedWindow(run.trace, chips=run.cell.chips)
    pending: collections.deque = collections.deque()

    def call(i: int) -> float:
        """Enqueue call ``i`` and its copies out → its host span (s)."""
        if len(pending) >= in_flight:
            pending.popleft().synchronize()
        chunk = i % n_chunks
        t_a = time.perf_counter()
        res = infer_padded(engine, chunks[chunk], rows)
        span = time.perf_counter() - t_a
        sample, j = samples[chunk], i // n_chunks
        if sample.wants(j):
            buf = _host_buffers(res, aux, on_cuda)
            sample.keep(j, buf)
        else:
            buf = slots[i % in_flight]
        _copy_out(res, buf)
        if on_cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
        return span

    t_start = time.perf_counter()
    run.setup_s = t_start - run.t0
    untraced = run.seconds - (tr["trace_seconds"] if run.trace else 0.0)
    stop = t_start + untraced
    spans, i = [], 0
    while time.perf_counter() < stop:
        spans.append(call(i))
        i += 1
    _wait(dev)
    run.window_s = time.perf_counter() - t_start
    run.rows = i * rows
    if run.trace:
        # the profiler starts with the card idle, outside the rate's part
        tw.begin()
        stop = time.perf_counter() + tr["trace_seconds"]
        while time.perf_counter() < stop:
            call(i)
            i += 1
        _wait(dev)
        tw.finish()
    run.trace_summary = tw.summary
    run.attempted = i
    run.spans["call"] = spans
    run.info.update(rows_per_call=rows, calls=i)
    if on_cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    # free the program's state, then judge the sample against the reference
    del engine, res, slots, call
    clear_engine_cache()
    kept = [(c, buf) for c, s in enumerate(samples) for buf in s.kept.values()]
    run.compared = check(run, ta, chunks, kept, aux)


def _wait(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check(run: harness.Run, ta: torch.Tensor, chunks: list, kept: list,
          aux: tuple) -> dict:
    """Mismatched rows of every kept ``(chunk, results)`` call against the
    plain reference."""
    cfg_j = run.cell.config
    dev = run.device
    by_chunk = collections.defaultdict(list)
    for chunk, buf in kept:
        by_chunk[chunk].append(buf)
    counts = dict.fromkeys(["pred_mismatch", "sums_mismatch", *(
        k.replace("_ps", "") + "_mismatch" for k in aux)], 0)
    checked = 0
    for chunk, bufs in by_chunk.items():
        lits = torch.as_tensor(chunks[chunk], device=dev)
        if aux:
            want = dict(zip(("prediction", "class_sums", "latency_ps",
                             "metastable"),
                            ref.infer_race(ta, lits, cfg_j["n_states"],
                                           cfg_j["pdl"])))
        else:
            want = dict(zip(("prediction", "class_sums"),
                            ref.infer(ta, lits, cfg_j["n_states"])))
        want = {k: v.cpu() for k, v in want.items()}
        for buf in bufs:
            checked += lits.shape[0]
            counts["pred_mismatch"] += int(
                (buf["prediction"] != want["prediction"]).sum())
            counts["sums_mismatch"] += int(
                (buf["class_sums"] != want["class_sums"]).any(-1).sum())
            if aux:
                counts["latency_mismatch"] += int(
                    (buf["latency_ps"] != want["latency_ps"]).sum())
                counts["metastable_mismatch"] += int(
                    (buf["metastable"] != want["metastable"]).sum())
    run.info.update(rows_checked=checked, chunks_checked=len(by_chunk))
    out = {k: (v, LIMITS[k]) for k, v in counts.items()}
    out["sample_missing"] = (int(checked == 0), 0)
    return out


def small_cell(cell, use: str = "run"):
    """The cell with its traffic at the CPU tests' size (:data:`SMALL`);
    the configuration, a few MB of state, stays as it is."""
    return dataclasses.replace(cell, traffic={**cell.traffic,
                                              **SMALL[use]})


def check_config(config: dict) -> None:
    """The configuration file holds the port's preset of its name."""
    from repro_torch.configs import get_config
    preset = get_config(config["preset"])
    assert (config["n_classes"], config["n_clauses"], config["n_features"],
            config["T"], config["s"], config["backend"]) == (
        preset.n_heads, preset.d_ff, preset.d_model,
        int(preset.rope_theta), preset.norm_eps, preset.backend)


def check_run(run: harness.Run, traced: bool) -> None:
    """A sound run compares every chunk of the pool; a traced one counts
    only the rows of the untraced part."""
    tr = run.cell.traffic
    if traced:
        assert run.rows < run.attempted * tr["rows_per_call"]
    else:
        assert run.info["chunks_checked"] == tr["pool_chunks"]


def control(cell, seed: int, device) -> dict:
    """The control's compared numbers for one seed of ``cell``: one call's
    rows (chunk 0 of the cell's pool) computed by the plain reference one
    precision down, through :func:`check`.

    - ``mxu_fused`` cells: the clause-violation counts and the class sums
      held in 4-bit two's complement (int4 below the stated int8
      operands), so class sums past ±7 wrap;
    - the time-domain race: the chain delays computed in bfloat16 (below
      the stated float32).
    """
    cfg_j, tr = cell.config, cell.traffic
    gen = inputs.generator(seed, device)
    ta = inputs.tm_state(cfg_j, gen)
    pool = inputs.literal_rows(gen, (tr["pool_chunks"], tr["rows_per_call"]),
                               cfg_j["n_features"])
    lits = pool[0]
    if "pdl" in cfg_j:
        got = ref.infer_race(ta, lits, cfg_j["n_states"], cfg_j["pdl"],
                             precision="bfloat16")
        keys, aux = ("prediction", "class_sums", "latency_ps",
                     "metastable"), AUX
    else:
        got = ref.infer(ta, lits, cfg_j["n_states"], precision="int4")
        keys, aux = ("prediction", "class_sums"), ()
    buf = {k: v.cpu() for k, v in zip(keys, got)}
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, t0=0.0)
    return check(run, ta, [lits], [(0, buf)], aux)
