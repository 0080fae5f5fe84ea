"""Share of the routed (token, expert) pairs that the MoE layers kept
within capacity over the window's steps, in %: 100 x the sum of
``step_times[*].moe_pairs_kept`` over that of ``moe_pairs`` (the
``moe.pairs_kept`` and ``moe.pairs_routed`` counters, tallied on the
device in the forward)."""


def read(run):
    times = run.get("step_times") or ()
    routed = sum(t.get("moe_pairs", 0) for t in times)
    if not routed:
        return None
    return 100.0 * sum(t["moe_pairs_kept"] for t in times) / routed
