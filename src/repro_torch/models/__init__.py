"""The LM model zoo (port of ``repro.models``): the dense family —
tinyllama-1.1b, qwen1.5-4b, qwen1.5-110b, starcoder2-7b and internvl2-26b —
the ssm family (mamba2-130m) and the hybrid family (zamba2-2.7b) through
:class:`~repro_torch.models.model.LM`.  The MoE, MLA and
encoder-decoder families are ROADMAP.md queue 1 work.
"""
