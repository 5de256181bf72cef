"""A cell's inputs, drawn on the device from the run's seed: the automaton
states of the configuration and rows of literals.

Every draw comes from one ``torch.Generator`` on the run's device, in a
fixed order, so the same seed gives the same inputs and every seed the
same sizes and the same amount of work.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def include_counts(n_clauses: int, n_literals: int, density: float
                   ) -> list[int]:
    """Included literals of each of ``n_clauses`` clauses: the quantiles of
    Binomial(``n_literals / 2``, ``2 · density``) at ``(r + ½) / n_clauses``,
    a clause's count in a draw at ``density`` with ``x`` and ``¬x`` never
    both included.  The same counts for every seed."""
    n, p = n_literals // 2, 2 * density
    counts, cdf, k = [], 0.0, 0
    pmf = (1 - p) ** n
    for r in range(n_clauses):
        q = (r + 0.5) / n_clauses
        while cdf + pmf < q and k < n:
            cdf += pmf
            pmf *= (n - k) / (k + 1) * p / (1 - p)
            k += 1
        counts.append(k)
    return counts


def tm_state(config: dict, gen: torch.Generator) -> torch.Tensor:
    """(C, M, 2F) int32 automaton states at the boundary: ``n_states + 1``
    (included) or ``n_states``.  Every seed gives each clause the same
    count of included literals (:func:`include_counts`, dealt in
    ascending order over the classes in turn, so every class holds the
    same counts and a positive clause's neighbour the next one); the seed
    draws which features, each as ``x`` or as ``¬x``.  So how often each
    clause fires on random rows, and with it the kernels' work, does not
    change with the seed."""
    c, m, f = config["n_classes"], config["n_clauses"], config["n_features"]
    n, dev = config["n_states"], gen.device
    counts = torch.tensor(include_counts(c * m, 2 * f,
                                         config["include_density"]),
                          device=dev).reshape(m, c).T.reshape(-1)
    keys = torch.rand((c * m, f), generator=gen, device=dev)
    rank = keys.argsort(-1).argsort(-1)
    chosen = rank < counts[:, None]
    negated = torch.randint(0, 2, (c * m, f), generator=gen, device=dev,
                            dtype=torch.bool)
    inc = torch.cat([chosen & ~negated, chosen & negated], dim=-1)
    return torch.where(inc, n + 1, n).to(torch.int32).reshape(c, m, 2 * f)


def literal_rows(gen: torch.Generator, shape: tuple, n_features: int
                 ) -> torch.Tensor:
    """``shape + (2F,)`` int8 literals ``[x, ¬x]`` of uniform bits x."""
    x = torch.randint(0, 2, (*shape, n_features), generator=gen,
                      device=gen.device, dtype=torch.int8)
    return torch.cat([x, 1 - x], dim=-1)

