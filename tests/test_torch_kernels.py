"""Port parity: the plain versions of kernels K1 and K3 against the Pallas
kernels (interpret mode) and ``repro.kernels.ref``, bit for bit.

On the CPU each kernel wrapper runs its plain version — the arithmetic
``chip_smoke.py`` holds the CUDA kernels to on the card — and launches
nothing.  Densities 0, 0.15 and 1 cover the no-include, trained-like and
all-include extremes; batch sizes are ragged against every tile.
"""

import ctypes
import itertools
import math
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.popcount import pack_bits as jpack
from repro.kernels import clause_eval as jce
from repro.kernels import ref as jref
from repro.kernels.swar_fused import swar_fused_votes_pallas
from repro_torch.core.popcount import pack_bits
from repro_torch.kernels import ops, ref
from repro_torch.kernels.clause_eval import clause_votes, make_vote_matrix
from repro_torch.kernels.swar_fused import swar_fused_votes

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

CASES = [(b, c, m, f, d)
         for (b, c, m, f) in [(1, 2, 6, 9), (17, 3, 10, 12), (5, 4, 8, 40)]
         for d in (0.0, 0.15, 1.0)]


def _inputs(b, c, m, f, density, seed):
    rng = np.random.default_rng(seed)
    lits = rng.integers(0, 2, (b, 2 * f), dtype=np.int8)
    inc = (rng.random((c * m, 2 * f)) < density).astype(np.int8)
    return lits, inc


def _ids(case):
    return "B{}C{}M{}F{}-d{}".format(*case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_k3_plain_matches_pallas_and_ref(case):
    b, c, m, f, density = case
    lits, inc = _inputs(b, c, m, f, density, seed=b + c + m + f)
    jvm = jce.make_vote_matrix(c, m)
    pallas = jce.clause_votes_pallas(jnp.asarray(lits), jnp.asarray(inc), jvm,
                                     interpret=True)
    jax_ref = jref.ref_clause_votes(jnp.asarray(lits), jnp.asarray(inc), jvm)
    before = ops.launches("clause_votes")
    got = clause_votes(torch.from_numpy(lits), torch.from_numpy(inc),
                       make_vote_matrix(c, m))
    assert ops.launches("clause_votes") == before   # CPU: plain version
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_k1_plain_matches_pallas_and_ref(case):
    b, c, m, f, density = case
    lits, inc = _inputs(b, c, m, f, density, seed=7 * b + c + m + f)
    jnot = jpack(jnp.asarray(1 - lits))
    jinc = jpack(jnp.asarray(inc))
    jvm = jce.make_vote_matrix(c, m)
    pallas = swar_fused_votes_pallas(jnot, jinc, jvm, interpret=True)
    tnot = pack_bits(torch.from_numpy(1 - lits))
    tinc = pack_bits(torch.from_numpy(inc))
    np.testing.assert_array_equal(tnot.numpy().view(np.uint32),
                                  np.asarray(jnot))
    before = ops.launches("swar_fused_votes")
    got = swar_fused_votes(tnot, tinc, make_vote_matrix(c, m))
    assert ops.launches("swar_fused_votes") == before   # CPU: plain
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.ref_clause_votes(jnp.asarray(lits), jnp.asarray(inc),
                                         jvm)))


# (B, C, M, L, density): the edges of kernel K1's cluster design, as
# tests/test_torch_cuda.py::CASES and ::test_swar_fused_kernel_many_classes
# hold the kernel to this plain version there — B around the 8-row
# serving tile and the switch to the bulk tile at 1056 rows; CM around
# 256 and one cluster's 512 clauses; Wl = 1, 4, 5, 49, 65 and 128 words;
# odd B; many classes
K1_EDGES = [(7, 10, 50, 1568, 0.002), (8, 10, 50, 1568, 0.002),
            (9, 10, 50, 1568, 0.002), (1055, 10, 50, 1568, 0.002),
            (1056, 10, 50, 1568, 0.002), (33, 5, 51, 64, 0.02),
            (33, 8, 32, 64, 0.02), (33, 1, 257, 64, 0.02),
            (21, 7, 73, 96, 0.02), (21, 8, 64, 96, 0.02),
            (21, 27, 19, 96, 0.02), (19, 3, 11, 32, 0.05),
            (19, 3, 11, 128, 0.01), (19, 3, 11, 130, 0.01),
            (41, 4, 9, 2080, 0.001), (41, 4, 9, 4096, 0.0005),
            (2000, 500, 2, 40, 0.1), (1200, 900, 2, 40, 0.1)]


@pytest.mark.parametrize("case", K1_EDGES,
                         ids=lambda c: "B{}C{}M{}L{}-d{}".format(*c))
def test_k1_plain_matches_pallas_at_kernel_edges(case):
    b, c, m, lit, density = case
    rng = np.random.default_rng(b + c + m + lit)
    lits = rng.integers(0, 2, (b, lit), dtype=np.int8)
    inc = (rng.random((c * m, lit)) < density).astype(np.int8)
    want = np.asarray(swar_fused_votes_pallas(
        jpack(jnp.asarray(1 - lits)), jpack(jnp.asarray(inc)),
        jce.make_vote_matrix(c, m), interpret=True))
    got = swar_fused_votes(pack_bits(torch.from_numpy(1 - lits)),
                           pack_bits(torch.from_numpy(inc)),
                           make_vote_matrix(c, m))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_k1_plain_chunks_rows(monkeypatch):
    """The plain K1 version walks rows in chunks to bound its hit tensor;
    a chunk of one row gives the same votes as one chunk of all rows."""
    lits, inc = _inputs(11, 3, 7, 20, 0.1, seed=3)
    args = (pack_bits(torch.from_numpy(1 - lits)),
            pack_bits(torch.from_numpy(inc)), make_vote_matrix(3, 7))
    whole = ref.ref_swar_fused_votes(*args)
    monkeypatch.setattr(ref, "_HIT_ELEMS", 1)
    assert torch.equal(ref.ref_swar_fused_votes(*args), whole)


@pytest.mark.parametrize("c,m", [(1, 1), (3, 7), (10, 50)])
def test_make_vote_matrix(c, m):
    np.testing.assert_array_equal(make_vote_matrix(c, m).numpy(),
                                  np.asarray(jce.make_vote_matrix(c, m)))


def test_vote_matrix_is_an_input():
    """Neither plain version assumes the polarity structure: an arbitrary
    int8 vote matrix gives the reference's votes."""
    lits, inc = _inputs(9, 3, 5, 10, 0.1, seed=11)
    vm = np.random.default_rng(1).integers(-5, 6, (15, 4), dtype=np.int8)
    want = np.asarray(jref.ref_clause_votes(
        jnp.asarray(lits), jnp.asarray(inc), jnp.asarray(vm)))
    tvm = torch.from_numpy(vm)
    np.testing.assert_array_equal(
        clause_votes(torch.from_numpy(lits), torch.from_numpy(inc),
                     tvm).numpy(), want)
    np.testing.assert_array_equal(
        swar_fused_votes(pack_bits(torch.from_numpy(1 - lits)),
                         pack_bits(torch.from_numpy(inc)), tvm).numpy(),
        want)


def test_ref_popcount_words():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, (6, 5), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        ref.ref_popcount_words(torch.from_numpy(u.view(np.int32))).numpy(),
        np.asarray(jref.ref_popcount_words(jnp.asarray(u))))


def test_tm_fused_votes_and_predict():
    lits, inc = _inputs(13, 4, 6, 11, 0.15, seed=5)
    tl, ti = torch.from_numpy(lits), torch.from_numpy(inc)
    tvm = make_vote_matrix(4, 6)
    votes = ops.tm_fused_votes(tl, ti, tvm)
    assert torch.equal(votes, ref.ref_clause_votes(tl, ti, tvm))
    np.testing.assert_array_equal(
        votes.numpy(),
        np.asarray(jref.ref_clause_votes(jnp.asarray(lits), jnp.asarray(inc),
                                         jce.make_vote_matrix(4, 6))))
    np.testing.assert_array_equal(
        ops.tm_fused_predict(tl, ti, tvm).numpy(),
        np.argmax(votes.numpy(), -1))


def test_wrappers_reject_bad_inputs():
    lits, inc = _inputs(4, 2, 3, 5, 0.2, seed=2)
    tl, ti, vm = torch.from_numpy(lits), torch.from_numpy(inc), \
        make_vote_matrix(2, 3)
    with pytest.raises(ValueError, match="int8"):
        clause_votes(tl.to(torch.int32), ti, vm)
    with pytest.raises(ValueError, match="do not chain"):
        clause_votes(tl, ti[:, :-1], vm)
    with pytest.raises(ValueError, match="int32"):
        swar_fused_votes(pack_bits(tl).to(torch.int64), pack_bits(ti), vm)
    with pytest.raises(ValueError, match="do not chain"):
        swar_fused_votes(pack_bits(tl), pack_bits(ti)[:-1], vm)


def test_kernel_sources_and_build_flags():
    """Each kernel library builds from its own source under csrc/, for
    sm_90a, into the git-ignored build directory."""
    csrc = ops._CSRC
    for name, src in ops.KERNEL_SOURCES.items():
        text = (csrc / src).read_text()
        assert f'extern "C" int {name}(' in text
        assert f"{name}_error" in text
        assert ops._lib_path(name).parent == ops._BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in ops.NVCC_FLAGS
    assert ops._BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_variant_build_shares_the_build_route():
    """A variant build (extra nvcc flags, such as the phase clocks
    probe's) hashes its flags into the library's name and lives in a
    subdirectory of its own, so it never shadows a library the port
    loads."""
    flags = ("-DREPRO_PHASE_CLOCKS",)
    for name in ops.KERNEL_SOURCES:
        plain = ops._lib_path(name)
        variant = ops._lib_path(name, flags, "phase_clocks")
        assert variant.parent == ops._BUILD_DIR / "phase_clocks"
        assert variant.name != plain.name
        assert ops._lib_path(name, flags) != plain
        assert ops._lib_path(name, (), "") == plain


def test_lib_path_hashes_every_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``*.cuh`` under
    ``csrc/`` — the shared ones (``threefry.cuh``, ``mma_s8.cuh``) and
    any header added later — so an edited header never loads a stale
    build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(ops._CSRC, csrc)
    monkeypatch.setattr(ops, "_CSRC", csrc)

    def names():
        return {name: ops._lib_path(name) for name in ops.KERNEL_SOURCES}

    before = names()
    headers = sorted(csrc.glob("*.cuh"))
    assert {"threefry.cuh", "mma_s8.cuh"} <= \
        {h.name for h in headers}
    for header in headers:
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        after = names()
        assert all(after[n] != before[n] for n in before), header.name
        header.write_text(text)
        assert names() == before
    source = csrc / ops.KERNEL_SOURCES["clause_votes"]
    source.write_text(source.read_text() + "\n// edited\n")
    after = names()
    assert [n for n in before if after[n] != before[n]] == ["clause_votes"]
    (csrc / "new_shared.cuh").write_text("#pragma once\n")
    assert all(p != after[n] for n, p in names().items())


def _c_argtypes(source: str, name: str) -> list:
    """The ctypes types of ``extern "C" int <name>(...)``'s parameters in
    CUDA source text: pointers, ``float``, ``unsigned``, ``int``."""
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", source)
    assert found, f"no extern C entry {name}"
    kinds = []
    for param in found.group(1).split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            kinds.append(ctypes.c_void_p)
        elif "float" in words:
            kinds.append(ctypes.c_float)
        elif "unsigned" in words:
            kinds.append(ctypes.c_uint)
        elif "int" in words:
            kinds.append(ctypes.c_int)
        else:
            raise AssertionError(f"{name}: unknown C type in {param!r}")
    return kinds


@pytest.mark.parametrize("name", sorted(ops.KERNEL_SOURCES))
def test_kernel_argtypes_match_c_entry_points(name):
    """Each C launch function takes, in order, the pointers and scalars of
    ``KERNEL_ARGTYPES[name]`` and then (int device, void* stream): a
    mismatch would pass a pointer through ctypes as a 32-bit int, which
    nothing on the CPU would notice."""
    source = (ops._CSRC / ops.KERNEL_SOURCES[name]).read_text()
    assert _c_argtypes(source, name) == [*ops.KERNEL_ARGTYPES[name],
                                         ctypes.c_int, ctypes.c_void_p]


def test_c_argtypes_parser():
    text = ('extern "C" int k(const void* a, void *b, int n, unsigned t,\n'
            '                 float x, int device, void* stream) {')
    assert _c_argtypes(text, "k") == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def test_phase_clocks_k3_include_counts_are_binomial_quantiles():
    """The probe's K3 state: clause r includes the (r + 1/2) / n
    quantile of Binomial(L / 2, 2 * density) literals, against the
    binomial's CDF summed term by term."""
    from repro_torch.kernels.phase_clocks import include_counts
    for n, lits, density in ((500, 1568, 0.002), (1000, 1568, 0.002),
                             (7, 40, 0.1), (64, 200, 0.05)):
        k_max, p = lits // 2, 2 * density
        cdf = list(itertools.accumulate(
            math.comb(k_max, k) * p ** k * (1 - p) ** (k_max - k)
            for k in range(k_max + 1)))
        want = [next(k for k, c in enumerate(cdf)
                     if c >= (r + 0.5) / n) for r in range(n)]
        assert include_counts(n, lits, density) == want


def test_phase_clocks_summarize():
    """The probe's summary: per-phase median and max clocks over the
    blocks that reached every mark, the clock rate, the span and the
    start spread on the global timer."""
    from repro_torch.kernels.phase_clocks import summarize
    clk = np.zeros((8, 8), np.uint64)
    ns = np.zeros((8, 8), np.uint64)
    clk[0, :3], ns[0, :3] = [100, 300, 700], [1000, 1100, 1300]
    clk[1, :3], ns[1, :3] = [50, 150, 250], [1040, 1090, 1140]
    clk[2, :2], ns[2, :2] = [10, 20], [1000, 1005]    # never reached mark 2
    got = summarize(clk, ns, 2)
    assert got == {"blocks": 2, "median_clk": [150, 250],
                   "max_clk": [200, 400], "clk_per_ns": 2.0, "span_ns": 300,
                   "start_spread_ns": 40}
    with pytest.raises(ValueError, match="every mark"):
        summarize(clk, ns, 5)


@pytest.mark.parametrize("name", ["swar_fused_votes", "train_deltas",
                                  "clause_votes", "pdl_race"])
def test_phase_marks_match_the_probe(name):
    """Each probed source marks PHASE(0) .. PHASE(n) in order, one mark
    per boundary of the probe's phase names, and takes the marks from the
    header that compiles them out unless REPRO_PHASE_CLOCKS is set.  K3's
    mark 1 sits in the tile it shares with K6 (``mma_s8.cuh``), after
    the first chunk is staged."""
    from repro_torch.kernels import phase_clocks
    phases = {"swar_fused_votes": phase_clocks.K1_PHASES,
              "train_deltas": phase_clocks.K2_PHASES,
              "clause_votes": phase_clocks.K3_PHASES,
              "pdl_race": phase_clocks.K5_PHASES}[name]
    text = (ops._CSRC / ops.KERNEL_SOURCES[name]).read_text()
    marks = [int(i) for i in re.findall(r"PHASE\((\d+)\)", text)]
    if name == "clause_votes":
        tile = (ops._CSRC / "mma_s8.cuh").read_text()
        assert re.findall(r"PHASE\((\d+)\)", tile) == ["1"]
        marks.insert(1, 1)
    assert marks == list(range(len(phases) + 1))
    assert '#include "phase_clocks.cuh"' in text
    header = (ops._CSRC / "phase_clocks.cuh").read_text()
    assert "#ifdef REPRO_PHASE_CLOCKS" in header
    assert "#define PHASE(i) ((void)0)" in header
    assert "-DREPRO_PHASE_CLOCKS" not in ops.NVCC_FLAGS
