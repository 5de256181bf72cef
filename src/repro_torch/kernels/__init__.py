"""Hand-written CUDA kernels for every Pallas kernel of the JAX package,
each with its plain PyTorch version and a launch counter.

========  ========================================  ========================
kernel    wrapper                                   replaces (Pallas)
========  ========================================  ========================
K1        ``swar_fused.swar_fused_votes``           ``swar_fused_votes_pallas``
K2        ``train_fused.train_deltas_keyed``        ``train_deltas_pallas``
K3        ``clause_eval.clause_votes``              ``clause_votes_pallas``
K4        ``popcount.popcount_words``               ``popcount_words_pallas``
K5        ``pdl_race.pdl_race``                     ``pdl_race_pallas``
K6        ``binary_matmul.binary_matmul``           ``binary_matmul_pallas``
========  ========================================  ========================

Each wrapper runs its plain version only on a CPU tensor; the JAX
package's ``ops.use_kernel=`` knob has no counterpart here (call the
``ref`` oracle by name instead).
"""
