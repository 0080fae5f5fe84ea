"""Mean host milliseconds a training step of the window waited for its
packed batch (``Trainer.step_times[*].data_wait_s``): the LM data plane
(the feed, UDF2, the tokenizer, the filter, the packer)."""

from bench.harness.readings import step_mean_ms


def read(run):
    return step_mean_ms(run, "data_wait_s")
