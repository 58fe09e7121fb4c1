"""The whole train step's share of the card's bf16 peak: three times
the reference network's forward FLOPs for every example of the steps
that finished in the untraced part of the window, against 989
TFLOP/s."""

from benchmark.roofline import BF16_PEAK_FLOPS


def read(out):
    rate = out.facts.get("examples_per_s")
    if not rate:
        return None
    return 100.0 * out.facts["flops_per_example"] * rate / BF16_PEAK_FLOPS
