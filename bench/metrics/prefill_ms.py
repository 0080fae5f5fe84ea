"""Mean host milliseconds of one admission in the window
(``ServingEngine.prefill_s / prefills``): the prefill into the cache, the
first-token forward and the splice, ending in a device-to-host read."""


def read(run):
    if not run.get("prefills"):
        return None
    return run["prefill_s"] / run["prefills"] * 1e3
