"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit).  A roofline share is stated against
these, with the card's ``power.limit`` read beside it."""

INT8_TC_OPS = 1979e12        # int8 tensor-core operations / s
FP64_TC_FLOPS = 67e12        # f64 tensor-core FLOP / s (DGEMM-based solves)
FP64_FLOPS = 34e12           # f64 FLOP / s outside the tensor cores
HBM_BYTES = 3.35e12          # HBM3 bytes / s
