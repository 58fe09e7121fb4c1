"""Train step: the share of the training-mode batch norms of the traced
steps that took the port's fused batch norm + ReLU kernels, from the
port's counters `batch_norm.fused` and `batch_norm.plain`
(`deepvariant_tpu_torch/utils/trace.py`, on while the profiler records),
in %. A port without those counters, or a run that counted none, reads
None."""


def read(out):
    try:
        from deepvariant_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = getattr(trace, "counts", None)
    if counts is None:
        return None
    got = counts()
    fused = got.get("batch_norm.fused", 0)
    plain = got.get("batch_norm.plain", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
