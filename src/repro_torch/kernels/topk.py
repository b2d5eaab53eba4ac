"""The top-k CUDA kernel (csrc/topk.cu) and its plain version: the k
smallest values of a 1-D float32 array and their indices, by masked-min
extractions per chunk, then over the survivors until one chunk is left."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_partial_ref as plain  # noqa: F401

CHUNK = 1024
# a later pass holds max(CHUNK, 2k) values and indices in shared memory,
# within the 227 KB a block may take
MAX_K = 14_000


def topk_cuda(values: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """values (n,) f32, contiguous on a CUDA device -> (values (k,),
    indices (k,) int32), ascending, ties to the lowest index; +inf values
    and the slots past n report index -1.  Each pass is one launch."""
    n = values.shape[0]
    build.require(values, torch.float32, (n,), "values")
    if not 0 < k <= MAX_K:
        raise ValueError(f"topk kernel: k={k} outside 1..{MAX_K}")
    if n >= 2 ** 31:
        raise ValueError(f"topk kernel: n={n} too large")
    dev = values.device
    if n == 0:
        return (torch.full((k,), float("inf"), device=dev),
                torch.full((k,), -1, dtype=torch.int32, device=dev))
    lib = build.load("topk")
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the first pass's chunk is the reference's block, min(1024, max(k, n))
    chunk = min(CHUNK, max(k, n))
    vals, idx, m = values, None, n
    while True:
        nb = -(-m // chunk)
        out_v = torch.empty(nb * k, dtype=torch.float32, device=dev)
        out_i = torch.empty(nb * k, dtype=torch.int32, device=dev)
        status = lib.topk_chunk_f32(
            vals.data_ptr(), None if idx is None else idx.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), m, chunk, k, stream)
        build.check(status, "topk")
        if nb == 1:
            return out_v, out_i
        # survivors: k per chunk; a chunk of >= 2k shrinks them each pass
        vals, idx, m = out_v, out_i, nb * k
        chunk = max(CHUNK, 2 * k)
