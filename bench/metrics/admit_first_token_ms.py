"""Mean device milliseconds of an admission's first-token forward (the
``apply`` over every prompt position and the argmax read): the
``serve.first_token`` program span of ``ServingEngine``, a CUDA event
pair."""

from bench.harness.spans import device_mean_ms


def read(run):
    return device_mean_ms(run, "serve.first_token")
