"""Mean device milliseconds of a decode step, from the step's first
launch to its tokens' read: the ``serve.decode`` program span of
``ServingEngine``, a CUDA event pair (where the host launches slower
than the card runs, the pair holds the card's waits too)."""

from bench.harness.spans import device_mean_ms


def read(run):
    return device_mean_ms(run, "serve.decode")
