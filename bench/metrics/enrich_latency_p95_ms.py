"""95th percentile over every document completed in the window of the
milliseconds from its hand-over to the engine (in an open loop, from
when it was due) to the step that produced its last token."""

import statistics


def read(run):
    lat = [d["latency_s"] for d in run.get("docs", ())]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
