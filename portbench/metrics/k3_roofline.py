"""Kernel K3 (``clause_votes_kernel``) against its roofline: the bound of
each traced launch from its shapes (:func:`portbench.roofline.k3_bound_s`)
over the device time the profiler gives its launches in the traced
sub-window."""

from portbench.roofline import k3_bound_s

KERNEL = "clause_votes_kernel"


def read(run):
    t = run.trace_summary
    if t is None:
        return None
    names = [n for n in t.device_ops if KERNEL in n]
    seconds = sum(t.device_ops[n] for n in names)
    launches = sum(t.device_counts[n] for n in names)
    if not launches or seconds <= 0:
        return None
    c = run.cell.config
    bound, _ = k3_bound_s(run.info["rows_per_call"], c["n_classes"],
                          c["n_clauses"], c["n_features"])
    return 100.0 * launches * bound / seconds
