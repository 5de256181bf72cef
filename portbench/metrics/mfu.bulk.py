"""The step's share of the card's int8 peak: the violation- and
vote-product operations of every row classified (2·L·C·M + 2·C·M·C a row,
whatever computes them) over 1,979 TOP/s, over the untraced part of the
window of the ``--trace 1`` run, which ends before the profiler starts."""

from portbench.roofline import INT8_OPS, tm_ops_per_row


def read(run):
    if "call" not in run.spans or not run.window_s:
        return None
    c = run.cell.config
    ops = run.rows * tm_ops_per_row(c["n_classes"], c["n_clauses"],
                                    c["n_features"])
    return 100.0 * ops / run.window_s / INT8_OPS
