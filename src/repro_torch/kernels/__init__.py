"""Hand-written CUDA kernels for the Pallas kernels of the serving path,
each with its plain PyTorch version (``ref.py``) and a launch counter.

========  =================================  ===========================
kernel    wrapper                            replaces (Pallas)
========  =================================  ===========================
K1        ``swar_fused.swar_fused_votes``    ``swar_fused_votes_pallas``
K3        ``clause_eval.clause_votes``       ``clause_votes_pallas``
========  =================================  ===========================
"""
