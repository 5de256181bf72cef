"""The paper's own architectures: Tsetlin Machines (Table I) + the §V BNN
(port of ``repro.configs.tm_paper``, the same names and fields).

Not LM configs: they are registered so a preset name selects the paper's
model, with the time-domain popcount/argmax path as a first-class
feature.  :func:`repro_torch.engine.engine_from_model_config` reads the
repurposed fields.
"""

from .base import ModelConfig, register

# backend: the VoteEngine each architecture defaults to — small iris TMs
# stay on the functional oracle; the MNIST-scale ones use the fused
# tensor-core kernel, the paper's flagship the time-domain race
for name, (classes, clauses, features, t, s, backend) in {
    "tm-iris-10": (3, 10, 12, 5, 1.5, "oracle"),
    "tm-iris-50": (3, 50, 12, 7, 6.5, "oracle"),
    "tm-mnist-50": (10, 50, 784, 5, 7.0, "mxu_fused"),
    "tm-mnist-100": (10, 100, 784, 5, 10.0, "time_domain"),
}.items():
    register(ModelConfig(
        name=name, family="tm",
        n_layers=1, d_model=features,        # reuse fields: F
        n_heads=classes,                     # C
        d_ff=clauses,                        # M (clauses per class)
        rope_theta=t,                        # T (vote clamp)
        norm_eps=s,                          # s (specificity)
        backend=backend,
        notes="paper Table I TM; fields repurposed (see docstring)",
    ))

register(ModelConfig(
    name="bnn-mnist", family="tm",
    n_layers=2, d_model=784, n_heads=10, d_ff=256,
    notes="paper §V future-work BNN: 784→256→10 xnor-popcount MLP",
))
