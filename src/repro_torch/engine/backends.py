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
``mxu_fused``           the dense int8 layout through CUDA kernel K3
                        (:func:`~repro_torch.kernels.clause_eval.
                        clause_votes`): clause matrix never in device
                        memory.  tm-mnist-50's default backend.
======================  ====================================================

Every backend precomputes its clause layout on the state's device at
construction, so ``infer`` does only literal-dependent work, and all
return identical ``prediction`` and ``class_sums`` (ties → lowest
index), bit for bit equal to the JAX package's same-named backends.

Not registered yet (see ROADMAP.md): ``sparse_csr``, ``time_domain`` and
``cascade``; asking for one raises the registry's unknown-backend error.
The JAX ``block_b``/``block_cm`` tile options of the fused backends are
TPU tiling and have no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.core.popcount import (argmax_tournament, int_matmul,
                                       pack_bits, popcount_adder_tree,
                                       popcount_swar, signed_vote_count)
from repro_torch.core.tm import (TMConfig, TMState, clause_polarity,
                                 include_mask)
from repro_torch.kernels.clause_eval import clause_votes, make_vote_matrix
from repro_torch.kernels.swar_fused import swar_fused_votes

from .base import EngineResult, as_literals, register_backend

__all__ = ["OracleEngine", "AdderTreeEngine", "SwarPackedEngine",
           "SwarFusedEngine", "MXUFusedEngine", "swar_clauses_votes"]


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
