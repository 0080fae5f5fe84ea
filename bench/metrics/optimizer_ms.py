"""Mean device milliseconds of a training step's AdamW update
(``Trainer.step_times[*].update_s``, CUDA events around
``TrainStep.update``)."""

from bench.harness.readings import step_mean_ms


def read(run):
    return step_mean_ms(run, "update_s")
