"""Host milliseconds a call (or training step) spends putting its inputs
on the card, read from the program's own spans in the profiled calls:
``srsem.normalize`` (a scorer's uint8 copy and normalize) and
``srsem.batch_to_device`` (a training batch's pin and copy), over the
calls recorded (root ``srsem.score`` or ``srsem.train_step`` spans).
None where the program records no spans."""

ROOTS = ("srsem.score", "srsem.train_step")
INPUT = ("srsem.normalize", "srsem.batch_to_device")


def recorded():
    """``(spans, roots)`` the program recorded, or None without any root."""
    try:
        from srsem_torch.utils.profiling import snapshot
    except ImportError:  # a program without the tracer
        return None
    spans = snapshot()["spans"]
    roots = [s for s in spans if s["parent"] is None and s["name"] in ROOTS]
    return (spans, roots) if roots else None


def read(ctx):
    got = recorded() if ctx.profile is not None else None
    if got is None:
        return None
    spans, roots = got
    ns = sum(s["t1_ns"] - s["t0_ns"] for s in spans if s["name"] in INPUT)
    return ns / 1e6 / len(roots)
