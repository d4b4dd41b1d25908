"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit)."""

BF16_FLOPS = 989e12  # tensor-core bfloat16, dense
HBM_BYTES_PER_S = 3.35e12
