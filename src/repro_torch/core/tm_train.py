"""Vanilla Tsetlin Machine training (port of ``repro.core.tm_train``).

Per sample with label ``y``:
- target class ``y`` receives feedback with per-clause probability
  ``(T − clip(v_y)) / 2T``; a uniformly sampled negative class ``ŷ`` with
  probability ``(T + clip(v_ŷ)) / 2T``.
- On the target class, positive-polarity clauses receive Type I feedback
  and negative-polarity clauses Type II; on the negative class the roles
  swap.

Type I: clause=1, literal=1 → +1 w.p. (s−1)/s (1.0 if boost_tpf);
clause=1, literal=0 or clause=0 → −1 w.p. 1/s.  Type II: clause=1,
literal=0 → +1 on currently excluded literals.  Per-sample deltas sum
over the batch before the clip to [1, 2N].

The PRNG contract is the JAX package's, bit for bit, through
:mod:`repro_torch.core.prng`: the step key splits into the negative-class
offsets, the feedback uniforms and per-row threefry keys, and row ``i``'s
Type I uniforms come from its own key.  So for the same key (JAX key data
carried over with ``prng.wrap_key_data``) every function here returns
exactly the JAX package's result.  Probabilities are float32 and divided
by a tensor, never by a Python scalar: on CUDA torch multiplies by the
reciprocal of a scalar divisor, which can move a ``u < p`` decision.
"""

from __future__ import annotations

import torch

from . import prng
from .tm import TMConfig, TMState, class_sums, clause_outputs, \
    clause_polarity

__all__ = ["feedback_draws", "feedback_thresholds", "feedback_masks",
           "feedback_update", "train_step", "train_epoch", "evaluate"]


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _type_i_delta(keys: torch.Tensor, clause: torch.Tensor,
                  literals: torch.Tensor, s: float,
                  boost_tpf: bool) -> torch.Tensor:
    """Type I feedback delta for one class block: keys (B, 2) per-row
    keys; clause (B, M) {0,1}; literals (B, 2F) {0,1} → (B, M, 2F)
    int32."""
    m, f2 = clause.shape[1], literals.shape[-1]
    u = prng.uniform(keys, (m, f2))                         # (B, M, 2F)
    lit = literals[:, None, :]
    cl = clause[:, :, None]
    p_inc = _f32(1.0 if boost_tpf else (s - 1.0) / s, u.device)
    p_dec = _f32(1.0 / s, u.device)
    inc = (cl == 1) & (lit == 1) & (u < p_inc)
    dec_match = (cl == 1) & (lit == 0) & (u < p_dec)
    dec_nomatch = (cl == 0) & (u < p_dec)
    return inc.to(torch.int32) - (dec_match | dec_nomatch).to(torch.int32)


def _type_ii_delta(clause: torch.Tensor, literals: torch.Tensor,
                   included: torch.Tensor) -> torch.Tensor:
    """Type II feedback: +1 on excluded literals that are 0 in firing
    clauses; ``included`` is the per-sample (B, M, 2F) include mask."""
    return ((clause[:, :, None] == 1) & (literals[:, None, :] == 0)
            & (included == 0)).to(torch.int32)


def feedback_draws(cfg: TMConfig, key: torch.Tensor, batch: int) -> tuple:
    """The votes-independent half of the PRNG contract, on ``key``'s
    device → ``(offs, u, k1s, k2s)``: offs (B,) negative-class offsets in
    1..C−1, u (B, 2, M) float32 feedback uniforms, k1s/k2s (B, 2) per-row
    threefry keys for the target/negative Type I draws."""
    k_neg, k_fb, k_i = prng.split(key, 3)
    offs = prng.randint(k_neg, (batch,), 1, cfg.n_classes)
    u = prng.uniform(k_fb, (batch, 2, cfg.n_clauses))
    w = prng.bits(k_i, (2, batch, 2))
    return offs, u, w[0], w[1]


def feedback_thresholds(cfg: TMConfig, votes: torch.Tensor,
                        y: torch.Tensor, offs: torch.Tensor,
                        u: torch.Tensor) -> tuple:
    """The votes-dependent half: threshold the drawn uniforms → ``(y_neg
    (B,), fb_t (B, M) bool, fb_n (B, M) bool)``.  Row-local; a row with
    ``u = 2.0`` gets all-False masks."""
    rows = torch.arange(y.shape[0], device=votes.device)
    v = votes.clamp(-cfg.T, cfg.T).to(torch.float32)
    y_neg = (y + offs) % cfg.n_classes
    two_t = torch.full((y.shape[0],), 2.0 * cfg.T, dtype=torch.float32,
                       device=votes.device)
    p_target = (cfg.T - v[rows, y]) / two_t                        # (B,)
    p_neg = (cfg.T + v[rows, y_neg]) / two_t
    fb_t = u[:, 0] < p_target[:, None]
    fb_n = u[:, 1] < p_neg[:, None]
    return y_neg, fb_t, fb_n


def feedback_masks(cfg: TMConfig, key: torch.Tensor, votes: torch.Tensor,
                   y: torch.Tensor) -> tuple:
    """Everything downstream of the class sums → ``(y_neg, fb_t, fb_n,
    k1s, k2s)`` on ``votes``' device.  The draws run on ``key``'s device
    (a CPU key keeps the many tiny threefry ops off the card)."""
    offs, u, k1s, k2s = feedback_draws(cfg, key, y.shape[0])
    dev = votes.device
    y_neg, fb_t, fb_n = feedback_thresholds(cfg, votes, y, offs.to(dev),
                                            u.to(dev))
    return y_neg, fb_t, fb_n, k1s.to(dev), k2s.to(dev)


def feedback_update(cfg: TMConfig, state: TMState, key: torch.Tensor,
                    x_literals: torch.Tensor, y: torch.Tensor,
                    clauses: torch.Tensor, votes: torch.Tensor,
                    boost_tpf: bool = True) -> TMState:
    """Shared Type I/II delta math: clause outputs (B, C, M) + votes
    (B, C) → the new state.  Materialises the per-sample (B, M, 2F)
    deltas and sums them per class (``index_add_``, exact in int32)."""
    b = x_literals.shape[0]
    dev = state.ta.device
    y_neg, fb_t, fb_n, k1s, k2s = feedback_masks(cfg, key, votes, y)
    rows = torch.arange(b, device=dev)
    pos = (clause_polarity(cfg.n_clauses, dev) > 0)[None, :]      # (1, M)

    cl_t = clauses[rows, y]                                        # (B, M)
    cl_n = clauses[rows, y_neg]
    included = state.ta > cfg.n_states
    inc_t = included[y].to(torch.int8)                             # (B, M, 2F)
    inc_n = included[y_neg].to(torch.int8)

    d1_t = _type_i_delta(k1s, cl_t, x_literals, cfg.s, boost_tpf)
    d1_n = _type_i_delta(k2s, cl_n, x_literals, cfg.s, boost_tpf)
    d2_t = _type_ii_delta(cl_t, x_literals, inc_t)
    d2_n = _type_ii_delta(cl_n, x_literals, inc_n)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # target class: Type I on positive clauses, Type II on negative ones;
    # the negative class swaps the roles
    delta_t = torch.where((fb_t & pos)[:, :, None], d1_t, zero) \
        + torch.where((fb_t & ~pos)[:, :, None], d2_t, zero)
    delta_n = torch.where((fb_n & pos)[:, :, None], d2_n, zero) \
        + torch.where((fb_n & ~pos)[:, :, None], d1_n, zero)

    upd = torch.zeros_like(state.ta)
    upd.index_add_(0, y, delta_t).index_add_(0, y_neg, delta_n)
    return TMState(ta=(state.ta + upd).clamp(1, 2 * cfg.n_states))


def _as_batch(state: TMState, x_literals, y) -> tuple:
    dev = state.ta.device
    x = torch.as_tensor(x_literals, device=dev).to(torch.int8)
    return x, torch.as_tensor(y, device=dev).to(torch.int64)


def train_step(cfg: TMConfig, state: TMState, key: torch.Tensor,
               x_literals, y, boost_tpf: bool = True) -> TMState:
    """One batched TM update on ``state``'s device: x_literals (B, 2F)
    {0,1}; y (B,) labels; key a ``(2,)`` threefry key."""
    x, y = _as_batch(state, x_literals, y)
    clauses = clause_outputs(cfg, state, x)                        # (B, C, M)
    votes = class_sums(cfg, clauses)                               # (B, C)
    return feedback_update(cfg, state, key, x, y, clauses, votes, boost_tpf)


def train_epoch(cfg: TMConfig, state: TMState, key: torch.Tensor,
                x_literals, y, batch_size: int = 32,
                backend: str | None = None) -> TMState:
    """Minibatch loop (drops the ragged tail), one key per batch from
    ``split(key, n_batches)``.  ``backend`` names a
    :mod:`repro_torch.engine.train` engine; ``None`` runs
    :func:`train_step`."""
    x, y = _as_batch(state, x_literals, y)
    n = (x.shape[0] // batch_size) * batch_size
    keys = prng.split(key, n // batch_size)
    if backend is None:
        def step(st, k, xb, yb):
            return train_step(cfg, st, k, xb, yb)
    else:
        from repro_torch.engine.train import get_train_engine
        step = get_train_engine(backend, cfg).step
    for i in range(n // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        state = step(state, keys[i], x[sl], y[sl])
    return state


def evaluate(cfg: TMConfig, state: TMState, x_literals, y) -> float:
    """Accuracy of :func:`repro_torch.core.tm.predict` on (x, y)."""
    from .tm import predict
    x, y = _as_batch(state, x_literals, y)
    pred = predict(cfg, state, x)
    return float((pred.to(torch.int64) == y).to(torch.float32).mean())
