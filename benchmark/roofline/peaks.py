"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W runs
slower under load, so a run prints its ``power.limit`` beside every
roofline share, which stays a share of these published peaks."""

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0

#: HBM3 bandwidth, bytes/s.
PEAK_BYTES = 3.35e12

#: Operations/s by unit.  f32 runs on the CUDA cores (the tensor cores'
#: f32 path is TF32); f64 has the FP64 tensor cores (DMMA) and the CUDA
#: cores at half their rate.
PEAK_FLOPS = {
    "float32.cuda_core": 67e12,
    "float64.tensor_core": 67e12,
    "float64.cuda_core": 34e12,
    "tf32.tensor_core": 495e12,
    "bfloat16.tensor_core": 989e12,
}
