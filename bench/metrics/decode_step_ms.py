"""Mean host milliseconds of one batched decode step in the window
(``ServingEngine.decode_s / decode_steps``), ending in a device-to-host
read of the chosen tokens."""


def read(run):
    if not run.get("decode_steps"):
        return None
    return run["decode_s"] / run["decode_steps"] * 1e3
