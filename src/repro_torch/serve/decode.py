"""Batched LM serving: greedy decode (port of ``repro.serve.decode``).

``decode_step`` uses the paper-inspired argmax-without-softmax head
(relative magnitude suffices for greedy decode).
"""

from __future__ import annotations

import torch

__all__ = ["generate"]


def generate(lm, tokens: torch.Tensor, *, max_new: int,
             cache_len: int | None = None) -> torch.Tensor:
    """Greedy-generate ``max_new`` tokens for a (B, S) prompt batch on
    ``lm``'s device → (B, max_new) int32.

    As the JAX function: the cache is built by decode-stepping the whole
    prompt (exact, S steps); the token the last prompt step picks is fed
    to the first generation step, and the output holds the ``max_new``
    tokens the generation steps pick (that first pick is not among
    them).  The JAX ``lax.scan`` loops are Python loops here.
    """
    b, s = tokens.shape
    cache_len = cache_len or (s + max_new)
    tokens = tokens.to(lm.device)
    cache = lm.init_cache(b, cache_len)
    last = tokens[:, 0]
    for pos in range(s):
        last, cache = lm.decode_step(cache, tokens[:, pos:pos + 1], pos)
    out = []
    for pos in range(s, s + max_new):
        last, cache = lm.decode_step(cache, last[:, None], pos)
        out.append(last)
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=lm.device)
    return torch.stack(out, dim=1)
