"""Device milliseconds per call of the library's forward convolutions and
matrix products (cuDNN, cuBLAS: the stems, the downsample blocks, the
decoder levels off the kernel, the trained decoder's forward)."""

def read(ctx):
    p = ctx.profile
    if p is None or not p.ops:
        return None
    return p.group_ms_per_call("cudnn conv")
