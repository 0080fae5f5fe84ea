"""Mean device milliseconds of a training step's forward and backward
(``Trainer.step_times[*].grad_s``, CUDA events around
``TrainStep.accumulate``)."""

from bench.harness.readings import step_mean_ms


def read(run):
    return step_mean_ms(run, "grad_s")
