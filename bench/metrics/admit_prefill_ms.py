"""Mean device milliseconds of an admission's prefill into the cache
(``api.prefill`` and ``pad_cache``): the ``serve.prefill`` program span
of ``ServingEngine``, a CUDA event pair."""

from bench.harness.spans import device_mean_ms


def read(run):
    return device_mean_ms(run, "serve.prefill")
