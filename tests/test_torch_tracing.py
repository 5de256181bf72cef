"""The port's tracer (``repro_torch.tracing``) on the CPU: no span while
off and counters that count, spans only inside a profiler's recorded
step, the span tree of one engine call on each benchmarked backend, the
profiler's clock, the bounded buffer, and the one launch counter in
``kernels.ops.launch``."""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch import tracing
from repro_torch.core import prng
from repro_torch.core.time_domain import PDLConfig, make_device
from repro_torch.core.tm import TMConfig, TMState
from repro_torch.engine import clear_engine_cache, get_engine, infer_padded
from repro_torch.kernels import ops

torch.set_num_threads(2)

CFG = TMConfig(n_classes=3, n_clauses=4, n_features=8)
BACKENDS = ["mxu_fused", "time_domain", "time_domain+pdl_device"]
# the span tree under ``engine.infer``: a name, or (name, its children)
STAGES = {"mxu_fused": ["engine.literals", "kernel.clause_votes",
                        "tm.argmax"],
          "time_domain": ["engine.literals",
                          ("td.low_count", ["kernel.clause_votes"]),
                          "td.delays", "td.race"],
          "time_domain+pdl_device": ["engine.literals", "td.clause_bits",
                                     "td.low_count", "td.delays",
                                     "td.race"]}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _engine(backend: str):
    """The named backend's engine; ``time_domain+pdl_device`` is the
    time-domain engine on a simulated physical device."""
    g = torch.Generator().manual_seed(3)
    ta = torch.randint(120, 140, (3, 4, 16), generator=g, dtype=torch.int32)
    if backend == "time_domain+pdl_device":
        pdl = PDLConfig(sigma_elem=2.0, sigma_noise=0.0)
        dev = make_device(pdl, CFG.n_classes, CFG.n_clauses, prng.key(1))
        return get_engine("time_domain", CFG, TMState(ta=ta), pdl=pdl,
                          device=dev)
    return get_engine(backend, CFG, TMState(ta=ta))


def _subtree(spans, i):
    """The spans whose parent is ``spans[i]``, in STAGES' form."""
    out = []
    for j, s in enumerate(spans):
        if s.parent == i:
            sub = _subtree(spans, j)
            out.append((s.name, sub) if sub else s.name)
    return out


def _rows(b: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(b)
    return torch.randint(0, 2, (b, 16), generator=g, dtype=torch.int8)


def test_off_records_no_span_and_counters_count():
    clear_engine_cache()
    eng = _engine("mxu_fused")
    infer_padded(eng, _rows(5), 8)
    infer_padded(eng, _rows(6).numpy(), 6)
    assert not tracing.recording()
    assert tracing.spans() == []
    c = tracing.counters()
    assert c["engine.build_s"] > 0
    # the plain versions launch nothing; a CPU result is not copied back
    assert not any(k.startswith("kernel.") for k in c)
    assert "engine.d2h_bytes" not in c and "engine.h2d_bytes" not in c


def test_spans_only_inside_a_profilers_recorded_step():
    eng = _engine("mxu_fused")
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: None)
    prof.start()                      # warm-up
    infer_padded(eng, _rows(4), 4)
    assert tracing.spans() == []
    prof.step()                       # recording
    assert tracing.recording()
    infer_padded(eng, _rows(4), 4)
    prof.step()
    prof.stop()
    assert not tracing.recording()
    infer_padded(eng, _rows(4), 4)    # after the stop
    got = tracing.spans()
    assert [s.name for s in got if s.parent == -1] == ["engine.infer_padded"]
    assert len({s.call_id for s in got}) == 1
    # a new recording session starts from an empty buffer
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert tracing.spans() == []


def test_the_profiler_start_hook_is_chained_once():
    """Import chains the session start into torch's profiler-start hook;
    chaining again wraps nothing twice."""
    from torch.autograd import profiler
    hook = profiler._run_on_profiler_start
    assert getattr(hook, "starts_trace_session", False)
    assert tracing._flag is profiler
    assert tracing._chain_profiler_start() is profiler
    assert profiler._run_on_profiler_start is hook


def test_without_the_hook_spans_ignore_the_profiler(monkeypatch):
    """A torch with no profiler-start hook starts no session, so span
    sites read no profiler flag and record only under ``enable``."""
    bare = types.SimpleNamespace(_is_profiler_enabled=True)
    flag = tracing._chain_profiler_start(bare)
    assert flag is tracing._NoProfiler
    assert not hasattr(bare, "_run_on_profiler_start")
    monkeypatch.setattr(tracing, "_flag", flag)
    eng = _engine("mxu_fused")
    with profile(activities=[ProfilerActivity.CPU]):
        assert not tracing.recording()
        infer_padded(eng, _rows(4), 4)
    assert tracing.spans() == []
    tracing.enable()
    infer_padded(eng, _rows(4), 4)
    assert [s.name for s in tracing.spans()][0] == "engine.infer_padded"


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_call_is_one_tree_with_one_call_id(backend):
    eng = _engine(backend)
    tracing.enable()
    infer_padded(eng, _rows(5), 8)      # padded to the bucket
    infer_padded(eng, _rows(8), 8)
    got = tracing.spans()
    by_call = {}
    for i, s in enumerate(got):
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        assert s.thread == threading.get_ident()
        by_call.setdefault(s.call_id, []).append(i)
    assert len(by_call) == 2
    for n, idx in enumerate(by_call.values()):
        spans = [got[i] for i in idx]
        root = spans[0]
        assert root.name == "engine.infer_padded" and root.parent == -1
        kids = [s for s in spans if s.parent == idx[0]]
        assert [s.name for s in kids] == (["engine.pad"] if n == 0 else []) \
            + ["engine.infer"]
        infer = kids[-1]
        assert infer.attrs == {"backend": backend.split("+")[0]}
        assert _subtree(got, idx[spans.index(infer)]) == STAGES[backend]
        for s in spans[1:]:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_follow_their_thread():
    eng = _engine("mxu_fused")
    tracing.enable()
    threads = [threading.Thread(target=infer_padded,
                                args=(eng, _rows(4), 4)) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = tracing.spans()
    roots = [i for i, s in enumerate(got) if s.parent == -1]
    assert len(roots) == 3
    assert len({got[i].call_id for i in roots}) == 3
    for s in got:
        if s.parent != -1:
            assert got[s.parent].thread == s.thread
            assert got[s.parent].call_id == s.call_id


def test_profiler_clock_holds_every_aten_event_of_the_call():
    eng = _engine("time_domain")
    lits = _rows(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infer_padded(eng, lits, 8)
    start = prof.profiler.kineto_results.trace_start_ns()
    (root,) = [s for s in tracing.spans() if s.name == "engine.infer_padded"]
    a = tracing.to_profiler_us(root.start_ns, start)
    b = tracing.to_profiler_us(root.end_ns, start)
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    assert len(aten) > 10
    for e in aten:
        assert a - 20.0 <= e.time_range.start and e.time_range.end <= b + 20.0


def test_a_raising_body_closes_its_spans():
    @tracing.traced("outer")
    def outer():
        tracing.begin("left open")
        raise KeyError("x")

    tracing.enable()
    with pytest.raises(KeyError):
        outer()
    sp = tracing.begin("next")
    tracing.end(sp)
    got = tracing.spans()
    assert [s.name for s in got] == ["outer", "left open", "next"]
    assert got[0].end_ns is not None and got[1].end_ns is None
    assert got[2].parent == -1 and got[2].call_id != got[0].call_id


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.enable()
    for _ in range(6):
        tracing.end(tracing.begin("s"))
    assert len(tracing.spans()) == 4
    assert tracing.counters()["trace.dropped"] == 2


def test_off_sites_return_nothing_and_the_function_runs():
    @tracing.traced("f", k=1)
    def f(x, *, y):
        return x + y

    assert f.__name__ == "f" and f(1, y=2) == 3
    assert tracing.begin("x") is None
    tracing.end(None)
    assert tracing.spans() == []


def test_every_hand_written_launch_counts_in_one_place(monkeypatch):
    """``ops.launch`` counts ``kernel.launches.<library>``; a refused
    launch counts nothing."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0 if len(calls) < 3 else 2

    lib = types.SimpleNamespace(clause_votes=entry,
                                clause_votes_error=lambda rc: b"refused")
    monkeypatch.setattr(ops, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    t = torch.zeros(4, dtype=torch.int8)
    before = ops.launches("clause_votes")
    ops.launch("clause_votes", (t, t, t, t), (1, 2, 3, 4))
    ops.launch("clause_votes", (t, t, t, t), (1, 2, 3, 4))
    assert ops.launches("clause_votes") == before + 2
    with pytest.raises(RuntimeError, match="refused"):
        ops.launch("clause_votes", (t, t, t, t), (1, 2, 3, 4))
    assert ops.launches("clause_votes") == before + 2
    assert ops.launches("train_deltas") == 0
    assert len(calls) == 3


def test_host_literals_sent_to_a_device_count_their_bytes():
    """``engine.h2d_bytes`` counts the int8 literals a host array or CPU
    tensor sends to another device (``meta`` stands in for the card
    here); literals already there count nothing."""
    from repro_torch.engine.base import as_literals
    as_literals(np.ones((5, 16), np.int64), torch.device("cpu"))
    assert "engine.h2d_bytes" not in tracing.counters()
    lits = as_literals(np.ones((5, 16), np.int64), torch.device("meta"))
    assert lits.dtype == torch.int8 and lits.device.type == "meta"
    as_literals(torch.ones((3, 16)), torch.device("meta"))
    as_literals(lits, torch.device("meta"))
    assert tracing.counters()["engine.h2d_bytes"] == (5 + 3) * 16
