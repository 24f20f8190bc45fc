"""Target-hardware constants (NVIDIA H100 SXM, 80 GB HBM3) for the
roofline model: NVIDIA's data sheet, dense rates without sparsity, at the
700 W power limit.  A card set below 700 W runs slower under load, so a
share against these peaks is stated with the card's power limit beside it.
"""
import torch

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: bf16 tensor-core peak, FLOP/s (dense)
PEAK_FLOPS_BF16 = 989e12
#: float32 outside the tensor cores counts an FMA as two: 67e12 FLOP/s, so
#: 33.5e12 32-bit lane instructions/s (132 SMs x 128 lanes x 1.98 GHz).
#: That is also the SM's issue rate — each of its four schedulers issues at
#: most one 32-lane warp instruction per clock — so no instruction mix runs
#: faster.
PEAK_FLOPS_FP32 = 67e12
LANE_INSTR_S = PEAK_FLOPS_FP32 / 2
#: NVLink 4, each way a link: 18 links carry 900 GB/s to the host's other
#: cards (450 GB/s each way)
NVLINK_LINK_BW = 25e9

BYTES_PER_DTYPE = {
    torch.bool: 1,
    torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.uint16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.uint32: 4, torch.float32: 4,
    torch.int64: 8, torch.uint64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}
