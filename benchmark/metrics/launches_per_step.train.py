"""Device kernels a train step: the kernels launched inside the
benchmark's range around one step (the batch's gather and the port's
train step), per step that closed inside the traced part of the
window."""


def read(out):
    r = out.reduced
    per = r.per_range("step") if r is not None else None
    if per is None or per[0] <= 0:
        return None
    return per[0]
