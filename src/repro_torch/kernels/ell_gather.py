"""ELL-fed clause evaluation: batch-bit-packed gather + AND reduction
(port of ``repro.kernels.ell_gather``).

The compute body behind the clause-indexed sparse layout
(:mod:`repro_torch.engine.sparse`): a ``(R, K)`` padded index matrix
names each clause row's *included* literals, the literals transpose and
bit-pack over the batch axis into 32-bit words (32 samples per word), and
each clause AND-reduces only its K gathered rows — ``O(R·K·B/32)`` word
ops against the dense ``O(R·L·B)``.

The JAX reference is jnp outside any Pallas kernel, so this is plain
tensor code too.  It runs as a fixed number of torch ops per batch,
whatever K is: one gather of the packed words, then a log-depth AND tree
over K (about ``log2 K`` pairs of slices; a loop over K would launch one
kernel per included literal on the card).  A hand-written gather kernel
is queued in ROADMAP.md.

Padding slots point at the sentinel literal ``L``, an all-ones word, so
they are no-ops for the conjunction; all-padding (empty-clause) rows
fire, the oracle's ``viol == 0`` convention.  Words are int32 tensors
holding the JAX package's uint32 bits.
"""

from __future__ import annotations

import torch

from repro_torch.core.popcount import pack_bits, unpack_bits

__all__ = ["ell_clause_words", "ell_clause_votes"]


def ell_clause_words(indices: torch.Tensor,
                     literals: torch.Tensor) -> torch.Tensor:
    """ELL clause eval, batch-bit-packed: → ``(R, ceil(B/32))`` int32.

    ``indices``: ``(R, K)`` int32, padding slots = ``L`` (the sentinel);
    ``literals``: ``(B, L)`` {0,1}.  Bit ``b`` of word ``w`` of row ``r``
    is clause ``r``'s output on sample ``32·w + b``.  Padded batch lanes
    (B not a multiple of 32) come back 0 in every row that includes a
    literal, and must be ignored by the caller.
    """
    words = pack_bits(literals.T)                        # (L, Wb)
    ext = torch.cat([words, words.new_full((1, words.shape[1]), -1)])
    r, k = indices.shape
    if k == 0:                      # every clause empty: all fire
        return words.new_full((r, words.shape[1]), -1)
    g = ext[indices.to(torch.int64)]                     # (R, K, Wb)
    while g.shape[1] > 1:           # AND tree over K, log2(K) levels
        if g.shape[1] % 2:
            g = torch.cat([g, g.new_full((r, 1, g.shape[2]), -1)], dim=1)
        g = g[:, 0::2] & g[:, 1::2]
    return g[:, 0]


def ell_clause_votes(indices: torch.Tensor, pol: torch.Tensor,
                     literals: torch.Tensor, *, c: int, m: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """ELL clause eval + signed class sums.

    ``indices``: ``(C·M, K)`` padded clause-index rows; ``pol``: ``(M,)``
    ±1 clause polarity; ``literals``: ``(B, 2F)`` {0,1} →
    ``(clauses (B, C, M) int8, votes (B, C) int32)``, bit-exact with the
    dense oracle.  Shared by the ``sparse_csr`` inference backend and the
    ``sparse`` train backend.
    """
    cw = ell_clause_words(indices, literals)             # (CM, Wb)
    cl = unpack_bits(cw, literals.shape[0]).reshape(c, m, -1)  # (C, M, B)
    votes = (cl.to(torch.int32) * pol.to(torch.int32).view(1, m, 1)) \
        .sum(1, dtype=torch.int32)                       # (C, B)
    return cl.permute(2, 0, 1), votes.T.contiguous()
