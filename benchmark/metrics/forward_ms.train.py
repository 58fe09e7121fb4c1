"""Forward: the device ms of the port's `train.forward` span (the pileup's
normalization, the network in training mode, the loss and the L2 penalty)
per train step, over the traced steps."""

from benchmark.port_spans import per_step


def read(out):
    return per_step("train.forward", "device_ms")
