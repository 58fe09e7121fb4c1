"""Dispatch: the host ms of the port's `train.step` span per train step,
over the traced steps (under the profiler, which inflates it). Beside
the step's device time (the batch over `train_examples_per_s`) it says
whether the host paces the step."""

from benchmark.port_spans import per_step


def read(out):
    return per_step("train.step", "host_ms")
