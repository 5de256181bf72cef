"""PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The package mirrors ``src/repro/`` module for module (``core/``,
``kernels/``, ``engine/``, ``serve/``, ``launch/``) so each file's
counterpart is easy to find, and holds every result bit for bit to the
JAX package, which stays the reference.  It imports ``torch`` and never
``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` where no GPU is visible raises instead of falling
back.  The Pallas kernels of the serving path are hand-written CUDA C++
under ``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first use); on a
CPU tensor each kernel wrapper runs its plain PyTorch version.

>>> from repro_torch.convert import state_from_numpy
>>> from repro_torch.engine import get_engine
>>> state = state_from_numpy(ta)                 # (C, M, 2F) int32, on cuda
>>> get_engine("mxu_fused", cfg, state).infer(literals).prediction
"""
