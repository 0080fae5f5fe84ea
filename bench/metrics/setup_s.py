"""Seconds from the process's start to the window's: imports, the CUDA
context, the weights, the feed or the engine, kernel builds on a first
run, and the warm-up of every shape the window uses."""


def read(run):
    return run["setup_s"]
