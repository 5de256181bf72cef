"""Tsetlin Machine model + inference (port of ``repro.core.tm``).

A TM with ``C`` classes, ``M`` clauses per class over ``F`` Boolean
features:

- literals: ``l = [x, ¬x]`` (length ``2F``);
- Tsetlin-automaton state ``ta``: int32 ``(C, M, 2F)`` in ``[1, 2N]``;
  literal *included* in a clause iff ``ta > N``;
- clause output: conjunction of included literals (an empty clause
  outputs 1 unless ``empty_clause_output=0``);
- class sum ("votes"): even-indexed clauses vote +1, odd-indexed −1;
- prediction: argmax over class sums (ties → lowest index).

``init_tm`` draws from a ``torch.Generator``; it is not held bitwise to
``jax.random`` (a JAX-made state crosses over through
:func:`repro_torch.convert.state_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .popcount import int_matmul, signed_vote_count

__all__ = ["TMConfig", "TMState", "init_tm", "include_mask",
           "clause_outputs", "class_sums", "predict", "clause_polarity"]


@dataclasses.dataclass(frozen=True)
class TMConfig:
    n_classes: int
    n_clauses: int          # clauses per class (half vote +, half vote −)
    n_features: int         # Boolean features (literals = 2×)
    n_states: int = 128     # N: per-action states; ta in [1, 2N]
    T: int = 15             # vote clamp threshold
    s: float = 3.9          # specificity

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features


class TMState(NamedTuple):
    ta: torch.Tensor  # (C, M, 2F) int32 in [1, 2N]


def clause_polarity(n_clauses: int, device=None) -> torch.Tensor:
    """+1 for even clause index (supporting), −1 for odd (opposing)."""
    idx = torch.arange(n_clauses, device=device)
    return torch.where(idx % 2 == 0, 1, -1).to(torch.int32)


def init_tm(cfg: TMConfig, generator: torch.Generator, *,
            device=None) -> TMState:
    """Each TA uniform at the include/exclude boundary {N, N+1}.

    ``device`` defaults to the generator's device."""
    ta = torch.randint(
        cfg.n_states, cfg.n_states + 2,
        (cfg.n_classes, cfg.n_clauses, cfg.n_literals), generator=generator,
        dtype=torch.int32,
        device=generator.device if device is None else device)
    return TMState(ta=ta)


def include_mask(cfg: TMConfig, state: TMState) -> torch.Tensor:
    """(C, M, 2F) int8: literal included in clause."""
    return (state.ta > cfg.n_states).to(torch.int8)


def clause_outputs(cfg: TMConfig, state: TMState, literals: torch.Tensor,
                   *, empty_clause_output: int = 1) -> torch.Tensor:
    """All clauses on a batch: ``(B, 2F)`` {0,1} → ``(B, C, M)`` int8 {0,1}.

    A clause fires iff no *included* literal is 0, counted as
    ``violations[b,c,m] = Σ_f include[c,m,f] · (1 − l[b,f])`` so the
    fused kernels match bit-exactly; clause = 1 iff violations == 0 (and,
    optionally, the clause is non-empty).
    """
    inc = include_mask(cfg, state)                            # (C, M, 2F)
    c, m, lit = inc.shape
    literals = torch.as_tensor(literals, device=inc.device)
    viol = int_matmul(1 - literals.to(torch.int32),
                      inc.reshape(c * m, lit).T).reshape(-1, c, m)
    out = (viol == 0).to(torch.int8)
    if not empty_clause_output:
        nonempty = (inc.sum(-1) > 0).to(torch.int8)           # (C, M)
        out = out * nonempty[None]
    return out


def class_sums(cfg: TMConfig, clauses: torch.Tensor) -> torch.Tensor:
    """(B, C, M) clause outputs → (B, C) int32 signed vote counts."""
    pol = clause_polarity(cfg.n_clauses, device=clauses.device)
    return signed_vote_count(clauses, pol[None, None, :])


def predict(cfg: TMConfig, state: TMState, literals: torch.Tensor,
            *, backend: str | None = None) -> torch.Tensor:
    """(B, 2F) literals → (B,) predicted class (tournament argmax).

    Delegates to the :mod:`repro_torch.engine` registry (``None`` selects
    the functional oracle); repeated calls on one state reuse
    ``get_engine``'s cached clause layout.
    """
    from repro_torch.engine import DEFAULT_BACKEND, get_engine
    engine = get_engine(backend or DEFAULT_BACKEND, cfg, state)
    return engine.infer(literals).prediction

