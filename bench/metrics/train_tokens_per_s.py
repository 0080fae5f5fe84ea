"""Loss tokens trained in the window over the window: every step the
window took, with its data wait, forward, backward and optimizer, and the
window's whole length (host clock, to the last step's end)."""


def read(run):
    if "tokens" not in run:
        return None
    return run["tokens"] / run["window_s"]
