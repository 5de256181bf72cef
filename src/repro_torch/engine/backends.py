"""Built-in VoteEngine backends (port of ``repro.engine.backends``).

======================  ====================================================
``oracle``              violation-count matmul + ±1 dot + tournament
                        argmax — the functional reference.
``adder_tree``          same clause eval; class sums via pairwise binary
                        adder trees (the generic FPGA baseline structure).
``swar_packed``         bit-packed clause storage: include masks and clause
                        outputs as 32-bit words; violations are word ANDs,
                        sums are SWAR popcounts of polarity-masked words.
``swar_fused``          the bit-packed layout through CUDA kernel K1
                        (:func:`~repro_torch.kernels.swar_fused.
                        swar_fused_votes`): word AND + popcount + vote
                        product, the hit tensor never in device memory.
``sparse_csr``          clause-indexed sparsity: each clause ANDs only its
                        included literals' batch-packed words through the
                        padded ELL index matrix (:mod:`~repro_torch.engine.
                        sparse`); the default route for trained states.
``mxu_fused``           the dense int8 layout through CUDA kernel K3
                        (:func:`~repro_torch.kernels.clause_eval.
                        clause_votes`): clause matrix never in device
                        memory.  tm-mnist-50's default backend.
``time_domain``         the paper's PDL race: chain delays affine in the
                        vote count, arbiter-tree argmin (``race``).
======================  ====================================================

Every backend precomputes its clause layout on the state's device at
construction, so ``infer`` does only literal-dependent work, and all
return identical ``prediction`` and ``class_sums`` (ties → lowest
index), bit for bit equal to the JAX package's same-named backends.

The early-exit ``cascade`` backend lives in
:mod:`repro_torch.engine.cascade`.  The JAX ``block_b``/``block_cm`` tile
options of the fused backends are TPU tiling and have no counterpart
here.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.popcount import (argmax_tournament, int_matmul,
                                       pack_bits, popcount_adder_tree,
                                       popcount_swar, signed_vote_count)
from repro_torch.core.time_domain import (PDLConfig, PDLDevice,
                                          ideal_delays, low_select,
                                          pdl_delays, race)
from repro_torch.core.tm import (TMConfig, TMState, clause_polarity,
                                 include_mask)
from repro_torch.kernels.clause_eval import clause_votes, make_vote_matrix
from repro_torch.kernels.ell_gather import ell_clause_votes
from repro_torch.kernels.swar_fused import swar_fused_votes

from .base import EngineResult, as_literals, register_backend
from .sparse import ell_from_include

__all__ = ["OracleEngine", "AdderTreeEngine", "SwarPackedEngine",
           "SwarFusedEngine", "SparseCSREngine", "MXUFusedEngine", "TimeDomainEngine",
           "swar_clauses_votes"]


def _clause_bits(inc: torch.Tensor, literals: torch.Tensor) -> torch.Tensor:
    """(C, M, L) include × (B, L) {0,1} literals → (B, C, M) int8; a clause
    fires iff no included literal is 0 (violation-count form)."""
    c, m, lit = inc.shape
    viol = int_matmul(1 - literals.to(torch.int32),
                      inc.reshape(c * m, lit).T)
    return (viol == 0).to(torch.int8).reshape(-1, c, m)


def _result(sums: torch.Tensor) -> EngineResult:
    return EngineResult(argmax_tournament(sums), sums, {})


@register_backend("oracle")
class OracleEngine:
    """Functional reference: clause eval + ±1 dot + tournament argmax."""

    def __init__(self, cfg: TMConfig, state: TMState):
        self.cfg = cfg
        self.device = state.ta.device
        self._inc = include_mask(cfg, state)                     # (C, M, L)
        self._pol = clause_polarity(cfg.n_clauses, self.device)  # (M,) ±1

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        clauses = _clause_bits(self._inc, as_literals(literals, self.device))
        return _result(signed_vote_count(clauses, self._pol[None, None, :]))


@register_backend("adder_tree")
class AdderTreeEngine(OracleEngine):
    """Class sums as two pairwise adder trees (+ votes, − votes), depth
    ``ceil(log2 M)`` each — the critical path the paper's time-domain
    design removes."""

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        clauses = _clause_bits(self._inc, as_literals(literals, self.device))
        pos = (self._pol > 0).to(torch.int8)[None, None, :]
        neg = (self._pol < 0).to(torch.int8)[None, None, :]
        return _result(popcount_adder_tree(clauses * pos)
                       - popcount_adder_tree(clauses * neg))


def swar_clauses_votes(inc_words, pos_mask, neg_mask, literals, *, c, m):
    """The SWAR word body: inc_words (C·M, Wl) packed include masks;
    pos_mask/neg_mask (Wm,) packed clause polarities; literals (B, 2F)
    {0,1} → (clauses (B, C, M) int8, votes (B, C) int32).

    A clause fires iff ``include_word & ¬literal_word == 0`` for every
    word; votes are polarity-masked SWAR popcounts of the repacked clause
    words.
    """
    not_words = pack_bits(1 - literals.to(torch.int8))           # (B, Wl)
    hit = inc_words[None, :, :] & not_words[:, None, :]          # (B, CM, Wl)
    clauses = (hit == 0).all(-1).reshape(-1, c, m).to(torch.int8)
    words = pack_bits(clauses)                                   # (B, C, Wm)
    votes = popcount_swar(words & pos_mask) - popcount_swar(words & neg_mask)
    return clauses, votes


@register_backend("swar_packed")
class SwarPackedEngine:
    """Bit-packed clause storage: words all the way down.

    Build time: include masks pack to ``(C·M, ceil(L/32))`` words and the
    clause polarity to two ``(ceil(M/32),)`` masks.
    """

    def __init__(self, cfg: TMConfig, state: TMState):
        self.cfg = cfg
        self.device = state.ta.device
        inc = include_mask(cfg, state).reshape(
            cfg.n_classes * cfg.n_clauses, cfg.n_literals)
        self._inc_words = pack_bits(inc)                         # (CM, Wl)
        pol = clause_polarity(cfg.n_clauses, self.device)
        self._pos_mask = pack_bits((pol > 0).to(torch.int8))     # (Wm,)
        self._neg_mask = pack_bits((pol < 0).to(torch.int8))

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        _, sums = swar_clauses_votes(
            self._inc_words, self._pos_mask, self._neg_mask,
            as_literals(literals, self.device), c=self.cfg.n_classes,
            m=self.cfg.n_clauses)
        return _result(sums)


@register_backend("swar_fused")
class SwarFusedEngine:
    """Bit-packed layout through kernel K1: word AND + popcount + vote
    product in one CUDA kernel (its plain version on the CPU).  Packing
    the ¬literal words before the kernel is plain tensor code, as in the
    JAX backend."""

    def __init__(self, cfg: TMConfig, state: TMState):
        self.cfg = cfg
        self.device = state.ta.device
        inc = include_mask(cfg, state).reshape(
            cfg.n_classes * cfg.n_clauses, cfg.n_literals)
        self._inc_words = pack_bits(inc)                         # (CM, Wl)
        self._vm = make_vote_matrix(cfg.n_classes, cfg.n_clauses,
                                    self.device)

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        lits = as_literals(literals, self.device)
        not_words = pack_bits(1 - lits)                          # (B, Wl)
        return _result(swar_fused_votes(not_words, self._inc_words,
                                        self._vm))


@register_backend("sparse_csr")
class SparseCSREngine:
    """Clause-indexed sparsity (padded CSR/ELL gather).

    Build time: the include mask compresses to one ``(C·M, K)`` index
    matrix over only the included literals (K = max includes per clause,
    ≈ 5% of L for trained machines).  Infer: literals bit-pack over the
    batch axis, each clause gathers its K rows and AND-reduces
    (:func:`~repro_torch.kernels.ell_gather.ell_clause_votes`), so
    clause-eval work scales with the include density instead of L.

    ``ell=`` injects a prebuilt :class:`~repro_torch.engine.sparse.
    EllLayout` — the ``TMServer`` publish path passes its incrementally
    refreshed layout.  The caller guarantees that it matches ``state``'s
    include mask; only shapes are checked.  A layout holds tensors, so an
    ``ell=`` build bypasses the keyed engine cache.
    """

    def __init__(self, cfg: TMConfig, state: TMState, *, ell=None):
        self.cfg = cfg
        self.device = state.ta.device
        r = cfg.n_classes * cfg.n_clauses
        if ell is None:
            ell = ell_from_include(
                include_mask(cfg, state).reshape(r, cfg.n_literals))
        elif (ell.indices.shape[0] != r
                or ell.n_literals != cfg.n_literals):
            raise ValueError(
                f"ell layout is ({ell.indices.shape[0]} rows, "
                f"L={ell.n_literals}); cfg needs ({r}, "
                f"L={cfg.n_literals})")
        self.ell = ell
        self._pol = clause_polarity(cfg.n_clauses, self.device)

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        _, sums = ell_clause_votes(
            self.ell.indices, self._pol, as_literals(literals, self.device),
            c=self.cfg.n_classes, m=self.cfg.n_clauses)
        return _result(sums)


@register_backend("mxu_fused")
class MXUFusedEngine:
    """Dense int8 layout through kernel K3: clause-eval dot chained into
    the vote product in one CUDA kernel (its plain version on the CPU);
    the (B, C·M) clause matrix never reaches device memory."""

    def __init__(self, cfg: TMConfig, state: TMState):
        self.cfg = cfg
        self.device = state.ta.device
        self._inc = include_mask(cfg, state).reshape(
            cfg.n_classes * cfg.n_clauses, cfg.n_literals)       # (CM, L)
        self._vm = make_vote_matrix(cfg.n_classes, cfg.n_clauses,
                                    self.device)

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult` (bit-exact)."""
        return _result(clause_votes(as_literals(literals, self.device),
                                    self._inc, self._vm))


@register_backend("time_domain")
class TimeDomainEngine:
    """The paper's race: PDL chain delays + arbiter-tree argmin.

    Default is the *ideal* device (no variation, no skew): the chain
    delay is the affine ``M·d_high − Δ·low_count`` of the integer
    low-net count, so equal vote sums race to an exact tie and the
    arbiter's predetermined guess (lowest index) matches the oracle
    argmax bit for bit.  XLA contracts that expression into one fused
    multiply-add, so the port rounds it once too (``ideal_delays``) and
    its delays equal the JAX package's bit for bit.  Pass
    ``device=PDLDevice(...)`` to simulate a physical chip through
    per-element delays (and ``noise_key=`` for per-event jitter): then
    oracle agreement is physics, not arithmetic.

    ``aux``: per-sample ``latency_ps`` (float32, the winning arrival —
    data-dependent, paper §IV-A) and ``metastable`` (bool, any arbiter
    gap < ``t_res``).  The engine runs plain tensor code, as the JAX
    backend runs jnp outside any Pallas kernel.  ``noise_key`` is a
    threefry key (the port's, or a JAX key's raw data); the engine keeps
    the simulated chip as ``pdl_device``, since ``device`` is the torch
    device here as in every port engine.
    """

    def __init__(self, cfg: TMConfig, state: TMState, *,
                 pdl: PDLConfig | None = None,
                 device: PDLDevice | None = None,
                 noise_key: torch.Tensor | None = None):
        self.cfg = cfg
        self.device = state.ta.device
        self.pdl = pdl if pdl is not None else PDLConfig(sigma_elem=0.0,
                                                         sigma_noise=0.0)
        self.pdl_device = None if device is None else PDLDevice(
            device.elem_offset.to(self.device, torch.float32),
            device.skew.to(self.device, torch.float32))
        self.noise_key = None if noise_key is None else \
            prng.wrap_key_data(noise_key).to(self.device)
        self._inc = include_mask(cfg, state)                     # (C, M, L)
        self._pol = clause_polarity(cfg.n_clauses, self.device)  # (M,) ±1
        self._n_neg = cfg.n_clauses // 2     # odd-index (opposing) clauses

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult`; ``aux``
        carries per-sample ``latency_ps`` (float32) and ``metastable``
        (bool)."""
        clauses = _clause_bits(self._inc, as_literals(literals, self.device))
        low_count = low_select(clauses, self._pol).sum(-1, dtype=torch.int32)
        sums = low_count - self._n_neg     # low_count = votes + n_neg
        if self.pdl_device is None:
            delays = ideal_delays(self.pdl, low_count, self.cfg.n_clauses)
        else:
            delays = pdl_delays(self.pdl, self.pdl_device, clauses,
                                self._pol, key=self.noise_key)
        res = race(self.pdl, delays)
        return EngineResult(res.winner, sums,
                            {"latency_ps": res.latency,
                             "metastable": res.metastable})
