"""Dry run of the paper's technique at scale: the sharded filtered ScaNN
search over the production mesh, counted on the meta device.

The counterpart of the reference's `launch/fvs_dryrun.py`.  A 10M-row x
768-d store (the paper's cohere10m scale) has its leaves and its
leaf-ordered heap sharded over the mesh's data axis (queries and bitmaps
replicated); `abstract_sharded_fvs` builds it of meta tensors (nothing
is allocated), and the search of `core.distributed.distributed_search_fn`
runs through `DistributedScannExecutor` under `op_cost.step_cost`.  The
roofline terms are taken at the H100's constants (`repro_torch.hardware`:
the search's products are f32, so its compute term is at the FP32 peak).

Per device.  The reference's shard body runs on each of the mesh's
devices (`count_jaxpr` multiplies it by `mesh.size`, 256 or 512) and its
record divides the count by the chips: its per-device figure is one
shard's body plus the step's residency over the chips.  The port's
`StackedShards` runs the axis's S = 16 bodies once each, so the port's
per-device figure is the counted work over S, plus the residency over
the chips.  The work the port does once for every shard rather than
once a shard (the query projection, the final top-k over the gathered
S x k pairs, the centroid norms made when the search is built) is thus
1/S of the reference's per-device figure for it.

The all-gather is counted by the shard collectives: the (S, Q, k) f32
distances and int32 ids on one position, S x Q x k x 8 bytes (163,840 at
the defaults), the reference's figure.  `memory` is arithmetic on the
shapes: the arguments' bytes one position holds.

  PYTHONPATH=src python -m repro_torch.launch.fvs_dryrun [--multi-pod] \\
      [--n 10000000] [--dim 768] [--queries 128] [--leaves-searched 256] \\
      [--pallas]

`--pallas` charges the leaf scan as its kernel (the counter's
`fused_kernels`); without it the scan's plain version is counted op by
op, as the reference's `use_pallas=False`.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import hardware as hw
from repro_torch.core.distributed import DistributedScannExecutor, ShardedFVS
from repro_torch.core.scann import ScannIndex
from repro_torch.core.types import SearchParams, VectorStore
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import P, per_position_bytes


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_sharded_fvs(mesh, n: int, dim: int, leaf_rows: int,
                         axis: str = "data") -> tuple[ShardedFVS, dict]:
    """A ShardedFVS of meta tensors (no allocation), the reference's
    shapes plus the port's `row_norms_sq`: the leaf count padded to a
    multiple of the axis, each leaf's rows padded to 8."""
    num_leaves = -(-n // leaf_rows)
    nd = mesh.shape[axis]
    num_leaves += (-num_leaves) % nd
    cap = leaf_rows + (-leaf_rows) % 8
    words = (n + 31) // 32
    idx = ScannIndex(
        leaf_tiles=_meta((num_leaves, cap, dim), torch.int8),
        leaf_rowids=_meta((num_leaves, cap), torch.int32),
        leaf_centroids=_meta((num_leaves, dim)),
        scale=_meta((dim,)), mean=_meta((dim,)),
        branch_centroids=_meta((1, dim)),
        branch_leaves=_meta((1, num_leaves), torch.int32),
        pca=_meta((dim + 1, dim)),
        row_norms_sq=_meta((num_leaves, cap)), metric="l2", levels=1)
    store = VectorStore(vectors=_meta((n, dim)), norms_sq=_meta((n,)),
                        metric="l2")
    return ShardedFVS(index=idx, store=store, mesh=mesh, axis=axis), \
        {"words": words}


def argument_specs(sharded: ShardedFVS) -> tuple[dict, dict]:
    """(shapes, specs) of the search's arguments: leaves and the
    leaf-ordered heap over the axis, the rest replicated."""
    idx, store, ax = sharded.index, sharded.store, sharded.axis
    shapes = {"leaf_tiles": idx.leaf_tiles, "leaf_rowids": idx.leaf_rowids,
              "leaf_centroids": idx.leaf_centroids,
              "row_norms_sq": idx.row_norms_sq, "scale": idx.scale,
              "mean": idx.mean, "pca": idx.pca, "vectors": store.vectors,
              "norms_sq": store.norms_sq}
    specs = {"leaf_tiles": P(ax, None, None), "leaf_rowids": P(ax, None),
             "leaf_centroids": P(ax, None), "row_norms_sq": P(ax, None),
             "scale": P(), "mean": P(), "pca": P(),
             "vectors": P(ax, None), "norms_sq": P(ax)}
    return shapes, specs


def run(multi_pod: bool = False, n: int = 10_000_000, dim: int = 768,
        queries: int = 128, leaf_rows: int = 512, leaves_searched: int = 256,
        k: int = 10, pallas: bool = False) -> dict:
    """The dry run's record (the reference's keys)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.devices.size
    sharded, meta = abstract_sharded_fvs(mesh, n, dim, leaf_rows)
    params = SearchParams(k=k, num_leaves_to_search=leaves_searched,
                          reorder_factor=4)
    executor = DistributedScannExecutor(sharded, heap_layout="leaf_ordered",
                                        with_stats=False)
    q = _meta((queries, dim))
    bm = _meta((queries, meta["words"]), torch.int32)
    t0 = time.time()
    counter = op_cost.CostCounter(fused_kernels=pallas)
    with counter:
        res = executor.search(q, bm, params)
    io = op_cost.nbytes(argument_specs(sharded)[0]) + op_cost.nbytes(
        (q, bm, res.dists, res.ids))
    work = counter.total
    s = sharded.num_shards
    flops_dev = work.flops / s
    bytes_dev = work.bytes / s + io / chips
    coll = dict(counter.collectives)
    coll_dev = sum(coll.values())
    terms = {"compute_s": flops_dev / hw.PEAK_FP32_PER_S,
             "memory_s": bytes_dev / hw.PEAK_BYTES_PER_S,
             "collective_s": coll_dev / hw.LINK_BYTES_PER_S}
    shapes, specs = argument_specs(sharded)
    arg_bytes = per_position_bytes(shapes, specs, mesh) \
        + op_cost.nbytes((q, bm))
    return {
        "cell": "distributed-filtered-scann-serving",
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "store": {"n": n, "dim": dim, "leaves_searched": leaves_searched,
                  "batch_queries": queries},
        "trace_s": round(time.time() - t0, 3),
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "roofline": {**terms, "dominant": max(terms, key=terms.get)},
        "collectives": coll,
        "memory": {"argument_gb": arg_bytes / 1e9},
        "queries_per_s_bound": queries / max(*terms.values(), 1e-12),
        "kernel_calls": dict(counter.kernel_calls),
        "constants": dict(hw.CONSTANTS, compute_peak="fp32"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--leaf-rows", type=int, default=512)
    ap.add_argument("--leaves-searched", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pallas", action="store_true",
                    help="charge the leaf scan as its fused kernel")
    args = ap.parse_args(argv)
    rec = run(args.multi_pod, args.n, args.dim, args.queries, args.leaf_rows,
              args.leaves_searched, args.k, args.pallas)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
