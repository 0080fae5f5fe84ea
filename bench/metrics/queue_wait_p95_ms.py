"""95th percentile, over the documents admitted in the window, of the
host milliseconds from ``ServingEngine.submit`` to the start of the
document's admission: the ``serve.queue`` program span."""

import statistics

from bench.harness.spans import named


def read(run):
    waits = [s["dur"] * 1e-6 for s in named(run, "serve.queue")]
    if len(waits) < 20:
        return None
    return statistics.quantiles(waits, n=100, method="inclusive")[94]
