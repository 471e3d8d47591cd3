"""Peak rates of one NVIDIA H100 SXM at its 700 W limit, frozen from
fourdgs_tpu_torch/utils/timing.py (NVIDIA's H100 data sheet and the CUDA
programming guide): 128 FP32 lanes per SM issuing one instruction a clock
(a fused multiply-add counts two floating-point operations), 132 SMs, the
1.98 GHz boost clock the peaks assume; 3.35 TB/s of HBM3. The float32 rate
outside the tensor cores is the port's: it computes in float32 with TF32
off. A card set below 700 W runs slower under load; each result carries
the card's power limit beside it.
"""
BOOST_HZ = 1.98e9
FP32_LANES = 128 * 132
FP32_FLOP_S = 2 * FP32_LANES * BOOST_HZ          # 66.9e12, "67 TFLOP/s"
HBM_BYTES_S = 3.35e12
