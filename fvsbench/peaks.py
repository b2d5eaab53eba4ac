"""The yardstick's peak rates of one NVIDIA H100 SXM5 80GB (NVIDIA's H100
Tensor Core GPU data sheet, dense figures, no sparsity, at the full 700 W
power limit).  A copy kept with the benchmark, so that no change to the
program can move the bound a roofline share is read against."""

HBM_BYTES_PER_S = 3.35e12       # HBM3
FP32_FLOPS_PER_S = 67e12        # FP32 on the CUDA cores, no tensor cores
