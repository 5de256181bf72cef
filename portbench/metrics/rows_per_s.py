"""Result rows per second: every result row back in host memory, as the
cell's entry defines a row (bulk: a classified row, its prediction and
class sums; a decode entry: one sequence's next-token logits row, one
generated token), over the window from the first call to the last result
(host clock)."""


def read(run):
    if "call" not in run.spans or not run.window_s:
        return None
    return run.rows / run.window_s
