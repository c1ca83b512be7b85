"""Seconds the program spent building (nvcc) and loading its CUDA kernel
libraries, from its ``kernel_load_s`` counter: near 0 where the
checkout's build directory already held them, seconds where nvcc ran.
None where the program keeps no such counter or loaded no kernel."""


def read(ctx):
    try:
        from srsem_torch.utils.profiling import snapshot
    except ImportError:  # a program without the tracer
        return None
    return snapshot()["counters"].get("kernel_load_s")
