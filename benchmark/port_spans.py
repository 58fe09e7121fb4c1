"""The port's own spans, as the per-layer metrics read them.

`deepvariant_tpu_torch/utils/trace.py` records a span of each phase of
the train step (`train.step` around `train.forward`, `train.backward`
and `train.update`) while torch's profiler records, which in a traced
run is the traced part of the window. A port without that module, or a
run that recorded no `train.step`, reads None.
"""

from typing import Optional


def per_step(name: str, key: str) -> Optional[float]:
    """`key` ('device_ms' or 'host_ms') of the span `name`, summed over
    its calls, per `train.step` call."""
    try:
        from deepvariant_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()
    steps = spans.get("train.step", {}).get("calls")
    value = spans.get(name, {}).get(key)
    if not steps or value is None:
        return None
    return value / steps
