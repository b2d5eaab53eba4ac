"""The top-k CUDA kernel (csrc/topk.cu) and its plain version: the k
smallest values of a 1-D float32 array and their indices, by a radix select
over (value, index) keys in each chunk, then over the chunks' survivors."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_partial_ref as plain  # noqa: F401

# chunk sizes of the first stage: about one chunk per SM, within these
CHUNK_MIN, CHUNK_MAX = 2048, 8192
# the second stage holds k keys (and up to 8,192 survivors) in the 227 KB
# of shared memory a block may take
MAX_K = 14_000


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_size(n: int, n_sm: int) -> int:
    """The first stage's chunk: the power of two nearest above n / n_sm,
    clamped to [CHUNK_MIN, CHUNK_MAX]."""
    per_sm = max(1, -(-n // n_sm))
    return min(CHUNK_MAX, max(CHUNK_MIN, 1 << (per_sm - 1).bit_length()))


def topk_cuda(values: torch.Tensor, k: int, lib=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """values (n,) f32, contiguous on a CUDA device -> (values (k,),
    indices (k,) int32), ascending, ties to the lowest index; +inf values
    and the slots past n report index -1.  One launch when n fits one
    chunk, else two; one allocation holds the outputs and the survivors.
    `lib`: the bound library whose `topk_f32` to launch (another
    checkout's build of csrc/topk.cu; default this checkout's)."""
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
    chunk = chunk_size(n, _sm_count(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
    nb = -(-n // chunk)
    survivors = nb * min(k, chunk) if nb > 1 else 0
    buf = torch.empty(2 * k + 2 * survivors, dtype=torch.int32, device=dev)
    out_v, out_i = buf[:k].view(torch.float32), buf[k:2 * k]
    lib = lib or build.load("topk")
    status = lib.topk_f32(values.data_ptr(), out_v.data_ptr(),
                          out_i.data_ptr(), buf[2 * k:].data_ptr(), n, k,
                          chunk, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "topk")
    return out_v, out_i
