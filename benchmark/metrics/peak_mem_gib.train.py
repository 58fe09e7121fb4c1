"""Device memory: `torch.cuda.max_memory_allocated` over the window,
after a reset at the end of set-up, in GiB (corpus, state and the
step's activations)."""


def read(out):
    peak = out.facts.get("peak_bytes")
    return peak / 2**30 if peak else None
