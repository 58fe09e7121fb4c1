"""Pooling: the device ms of the port's `pool.forward` and `pool.backward`
spans (`deepvariant_tpu_torch/ops/pool.py`: one around each of the
network's 13 pools each way, the backward on autograd's thread) per train
step, over the traced steps. A port without those spans reads None."""

from benchmark.port_spans import per_step


def read(out):
    forward = per_step("pool.forward", "device_ms")
    backward = per_step("pool.backward", "device_ms")
    if forward is None or backward is None:
        return None
    return forward + backward
