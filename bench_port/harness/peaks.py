"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit), which every share of a peak or roofline is taken
against."""

#: TF32 on the tensor cores: the fastest rate at which the card multiplies
#: float32 operands, so no float32 implementation can exceed it
TF32_FLOPS = 495e12
#: HBM3 bandwidth
HBM_BYTES = 3.35e12
