"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick every share is taken against, whatever
implements the work."""

#: bf16 (and fp16) tensor-core operations a second.
BF16_FLOPS = 989e12
#: float32 operations a second: TF32 on the tensor cores, the fastest this
#: chip multiplies float32 inputs by any route (the FMA pipe gives 67e12,
#: 3xTF32 an effective 165e12), so no route can read over 100%.
F32_FLOPS = 495e12
#: HBM3 bytes a second.
HBM_BYTES = 3.35e12

FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the dtype's peak and the bytes over HBM's."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES)
