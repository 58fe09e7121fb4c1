"""Backward: the device ms of the port's `train.backward` span
(`torch.autograd.grad`: its exit event follows every backward kernel
on the stream) per train step, over the traced steps."""

from benchmark.port_spans import per_step


def read(out):
    return per_step("train.backward", "device_ms")
