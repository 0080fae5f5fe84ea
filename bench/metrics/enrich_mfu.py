"""Model operations the window's completed documents need (each prompt's
forward once, logits at its last position, then its decoded tokens over
their caches) over the window and the configuration's peak, in %
(``harness/flops.py``)."""

from bench.harness import flops


def read(run):
    if not run.get("docs"):
        return None
    cf = run["config"]
    ops = sum(flops.enrich_doc_flops(cf, len(d["prompt"]), len(d["tokens"]))
              for d in run["docs"])
    peak = float(cf["compute"]["peak_flops_per_s"])
    return 100.0 * ops / run["window_s"] / peak
