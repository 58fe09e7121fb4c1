"""Optimizer: the device ms of the port's `train.update` span (the
optimizer's update, `apply_updates` and the EMA) per train step, over
the traced steps."""

from benchmark.port_spans import per_step


def read(out):
    return per_step("train.update", "device_ms")
