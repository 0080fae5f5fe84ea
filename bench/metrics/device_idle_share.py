"""Share of the traced stretch in which no operation ran on the device,
in % (``torch.profiler``'s device events): one minus the union of its
operations' intervals over the stretch.  The reader of every
``device_idle_share.<kind>``."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
