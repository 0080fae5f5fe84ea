"""Mean device milliseconds a training step spends routing, dispatching
and combining its MoE layers' tokens in the forward
(``step_times[*].moe_route_fwd_s``: the ``moe.route``, ``moe.dispatch``
and ``moe.combine`` program spans; the expert products are not
counted), leaving out ``tracer_steps``."""

from bench.harness.spans import traced_step_mean_ms


def read(run):
    return traced_step_mean_ms(run, "moe_route_fwd_s")
