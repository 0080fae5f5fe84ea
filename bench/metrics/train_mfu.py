"""Model operations of the window's training steps over the window and
the configuration's peak, in %: 6 x the matmul weights a token uses
(output head yes, input embedding no, a mixture's chosen experts and
router) x the loss tokens, plus causal attention within each packed
document, forward and backward (``harness/flops.py``).  A mixture's count
takes all k pairs of every token: where the program drops pairs beyond
an expert's capacity it did less, by the share that the reference's
checked steps print ("routed pairs within capacity")."""

from bench.harness import flops


def read(run):
    if "tokens" not in run or not run["steps"]:
        return None
    cf = run["config"]
    ops = flops.train_step_flops(cf, run["tokens"], run["segment_lengths"])
    peak = float(cf["compute"]["peak_flops_per_s"])
    return 100.0 * ops / run["window_s"] / peak
