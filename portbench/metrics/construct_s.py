"""Seconds the program spent building its scorers or training steps
(moving the model to the card, folding BatchNorm into the kernels'
weights, packing the head), from its ``construct_s`` counter.  None where
the program keeps no such counter."""


def read(ctx):
    try:
        from srsem_torch.utils.profiling import snapshot
    except ImportError:  # a program without the tracer
        return None
    return snapshot()["counters"].get("construct_s")
