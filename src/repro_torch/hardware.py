"""The peak rates of the card the port targets, in one place.

NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet
(dense figures, no sparsity): HBM3 bandwidth 3.35 TB/s, FP32 outside the
tensor cores 67 TFLOP/s, BF16 on the tensor cores 989 TFLOP/s.  The
kernel table's bound (`chip_smoke.py`) and the dry runs' roofline
(`launch/dryrun.py`, `launch/fvs_dryrun.py`) both read these, so the two
cannot drift apart.

Interconnect.  The production meshes are (16, 16) and (2, 16, 16): an
axis of 16 positions spans two 8-GPU NVLink nodes (a DGX H100 node holds
8 cards), so a ring over it crosses the node boundary, and the slowest
link of the ring sets its rate.  `LINK_BYTES_PER_S` is that link: one
400 Gb/s NDR InfiniBand port (ConnectX-7) a GPU, 50 GB/s a direction
(NVIDIA DGX H100 data sheet: 8 single-port ConnectX-7 a node).  The
NVLink 4 rate inside a node, 900 GB/s a GPU in both directions together
(450 GB/s each way), is kept beside it for an axis that stays inside a
node; the dry runs do not use it.
"""
from __future__ import annotations

CARD = "NVIDIA H100 SXM5 80GB"
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_FP32_PER_S = 67e12         # FP32, CUDA cores
PEAK_BF16_PER_S = 989e12        # BF16 tensor cores, dense
LINK_BYTES_PER_S = 50e9         # NDR InfiniBand, one port a GPU, one way
NVLINK_BYTES_PER_S = 450e9      # NVLink 4 inside a node, one way

CONSTANTS = {"card": CARD, "peak_bf16_flops_per_s": PEAK_BF16_PER_S,
             "peak_fp32_flops_per_s": PEAK_FP32_PER_S,
             "hbm_bytes_per_s": PEAK_BYTES_PER_S,
             "link_bytes_per_s": LINK_BYTES_PER_S,
             "link": "NDR InfiniBand 400 Gb/s a GPU (a 16-wide axis "
                     "spans two 8-GPU NVLink nodes)"}
