"""The control: the reference put in the program's place, a step of
precision down from what the configuration states.  The configurations
state float32 with TF32 off; the control is the exact filtered search with
both operands of its cross term rounded to TF32, as the tensor cores
round them.  Its answers have to come out as not correct."""
from __future__ import annotations

import dataclasses
import types

import torch

from fvsbench.reference import exact


@dataclasses.dataclass
class Counters:
    """The program's seven counters, all zero: the control counts nothing."""

    distance_comps: torch.Tensor
    filter_checks: torch.Tensor
    hops: torch.Tensor
    page_accesses_index: torch.Tensor
    page_accesses_heap: torch.Tensor
    tmap_lookups: torch.Tensor
    reorder_rows: torch.Tensor


class ControlExecutor:
    """`search(queries, bitmaps, params)` as the program's executors have
    it, answered by the exact search at TF32."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def search(self, queries, bitmaps, params):
        dists, ids = exact.exact_knn(self.rows, queries, bitmaps, params.k,
                                     operand=exact.to_tf32)
        z = torch.zeros(queries.shape[0], dtype=torch.int32,
                        device=queries.device)
        return types.SimpleNamespace(
            ids=ids.to(torch.int32), dists=dists,
            stats=Counters(*(z for _ in dataclasses.fields(Counters))))


def control_factory(cell, rows, seed, device):
    return ControlExecutor(rows)
