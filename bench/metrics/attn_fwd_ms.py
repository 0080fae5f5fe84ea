"""Mean device milliseconds a training step spends in its layers'
attention in the forward (``step_times[*].attn_fwd_s``, the
``model.attention`` program spans, CUDA event pairs; a checkpoint's
recompute is not counted), leaving out ``tracer_steps``.  The reader of
``attn_fwd_ms.<kind>`` too."""

from bench.harness.spans import traced_step_mean_ms


def read(run):
    return traced_step_mean_ms(run, "attn_fwd_s")
