"""Port parity: the plain versions of kernels K1 and K3 against the Pallas
kernels (interpret mode) and ``repro.kernels.ref``, bit for bit.

On the CPU each kernel wrapper runs its plain version — the arithmetic
``chip_smoke.py`` holds the CUDA kernels to on the card — and launches
nothing.  Densities 0, 0.15 and 1 cover the no-include, trained-like and
all-include extremes; batch sizes are ragged against every tile.
"""

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
    before = clause_votes.launches
    got = clause_votes(torch.from_numpy(lits), torch.from_numpy(inc),
                       make_vote_matrix(c, m))
    assert clause_votes.launches == before      # CPU: plain version only
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
    before = swar_fused_votes.launches
    got = swar_fused_votes(tnot, tinc, make_vote_matrix(c, m))
    assert swar_fused_votes.launches == before  # CPU: plain version only
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.ref_clause_votes(jnp.asarray(lits), jnp.asarray(inc),
                                         jvm)))


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
