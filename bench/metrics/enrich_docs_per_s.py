"""Documents whose label was complete within the window, over the
window (host clock, to the end of the last engine step)."""


def read(run):
    if "docs" not in run:
        return None
    return len(run["docs"]) / run["window_s"]
