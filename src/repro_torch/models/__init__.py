"""The LM model zoo (port of ``repro.models``): every family — dense
(tinyllama-1.1b, qwen1.5-4b, qwen1.5-110b, starcoder2-7b, internvl2-26b),
moe (llama4-scout, deepseek-v2 with MLA), ssm (mamba2-130m), hybrid
(zamba2-2.7b) and encdec (seamless-m4t-large-v2) — through
:class:`~repro_torch.models.model.LM`; :mod:`.sharded` runs the dense
family over a device mesh.
"""
