"""Host milliseconds the program takes to issue a call's (or training
step's) work, read from its own spans in the profiled calls: the root
``srsem.score`` or ``srsem.train_step`` spans less the ``srsem.normalize``
spans inside them (whose pageable copies wait for the card), per call.
Beside the device's busy milliseconds a call, it says whether the host
keeps the card fed.  None where the program records no spans."""

from portbench.metrics.input_host_ms_per_call import recorded


def read(ctx):
    got = recorded() if ctx.profile is not None else None
    if got is None:
        return None
    spans, roots = got
    calls = {r["id"] for r in roots}
    ns = sum(r["t1_ns"] - r["t0_ns"] for r in roots)
    ns -= sum(s["t1_ns"] - s["t0_ns"] for s in spans
              if s["name"] == "srsem.normalize" and s["call"] in calls)
    return ns / 1e6 / len(roots)
