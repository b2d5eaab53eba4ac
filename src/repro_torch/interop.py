"""Carry the reference package's objects across to the port.

Each function reads the reference object's attributes through
`np.asarray` (so it needs no import of the reference package) and builds
the port's object on the chosen device.  This is what lets both sides
search the very same index in the parity tests.  uint32 bitmaps become the
port's bit-reinterpreted int32 words.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.distributed import ShardedFVS
from repro_torch.core.exclusion import ExclusionIndex
from repro_torch.core.hnsw import GraphPartition, HNSWGraph, PartitionedGraph
from repro_torch.core.mutable import MutableIndex
from repro_torch.core.scann import ScannIndex
from repro_torch.core.types import (VectorStore, resolve_device,
                                    words_from_uint32)
from repro_torch.launch.mesh import make_mesh
from repro_torch.storage import (DeltaTier, FaultPlan, GraphAdjacencyLayout,
                                 HeapLayout, ScannLeafLayout, StorageEngine,
                                 Tombstones)


def _t(x, device, dtype=None) -> torch.Tensor:
    arr = np.array(np.asarray(x), copy=True)
    t = torch.as_tensor(arr, device=device)
    return t if dtype is None else t.to(dtype)


def vector_store(store, device="cuda") -> VectorStore:
    """A reference VectorStore (vectors, norms_sq, metric), with its SQ8
    shadow when it has one."""
    dev = resolve_device(device)
    shadow = {}
    if getattr(store, "q_vectors", None) is not None:
        shadow = dict(q_vectors=_t(store.q_vectors, dev, torch.int8),
                      q_scale=_t(store.q_scale, dev, torch.float32),
                      q_mean=_t(store.q_mean, dev, torch.float32),
                      q_norms_sq=_t(store.q_norms_sq, dev, torch.float32))
    return VectorStore(vectors=_t(store.vectors, dev, torch.float32),
                       norms_sq=_t(store.norms_sq, dev, torch.float32),
                       metric=store.metric, **shadow)


def hnsw_graph(graph, device="cuda") -> HNSWGraph:
    """A reference HNSWGraph (neighbors, node_level, entry_point, m)."""
    dev = resolve_device(device)
    return HNSWGraph(neighbors=_t(graph.neighbors, dev, torch.int32),
                     node_level=_t(graph.node_level, dev, torch.int32),
                     entry_point=int(np.asarray(graph.entry_point)),
                     m=int(graph.m))


def scann_index(index, device="cuda") -> ScannIndex:
    """A reference ScannIndex, row norms included."""
    dev = resolve_device(device)
    tiles = _t(index.leaf_tiles, dev, torch.int8)
    scale = _t(index.scale, dev, torch.float32)
    mean = _t(index.mean, dev, torch.float32)
    norms = getattr(index, "row_norms_sq", None)
    if norms is None:
        x = tiles.to(torch.float32) * scale + mean
        norms_t = (x * x).sum(-1)
    else:
        norms_t = _t(norms, dev, torch.float32)
    return ScannIndex(
        leaf_tiles=tiles,
        leaf_rowids=_t(index.leaf_rowids, dev, torch.int32),
        leaf_centroids=_t(index.leaf_centroids, dev, torch.float32),
        scale=scale, mean=mean,
        branch_centroids=_t(index.branch_centroids, dev, torch.float32),
        branch_leaves=_t(index.branch_leaves, dev, torch.int32),
        pca=_t(index.pca, dev, torch.float32),
        row_norms_sq=norms_t, metric=index.metric, levels=int(index.levels))


def sharded_fvs(sharded, device="cuda") -> ShardedFVS:
    """A reference ShardedFVS: its (padded) index and its store, on a port
    mesh of the same axes and sizes (its shards run stacked)."""
    mesh = sharded.mesh
    shape = tuple(int(v) for v in dict(mesh.shape).values())
    return ShardedFVS(index=scann_index(sharded.index, device),
                      store=vector_store(sharded.store, device),
                      mesh=make_mesh(shape, tuple(mesh.axis_names)),
                      axis=sharded.axis)


def bitmaps(words, device="cuda") -> torch.Tensor:
    """Reference uint32 bitmap words (any shape) -> the port's int32."""
    return words_from_uint32(np.asarray(words), device=device)


def exclusion_index(excl, device="cuda") -> ExclusionIndex:
    """A reference ExclusionIndex: its ladder and family rows become the
    port's one (R + F, n) radius table."""
    dev = resolve_device(device)
    radii = np.concatenate([np.asarray(excl.ladder, np.float32),
                            np.asarray(excl.family_radii, np.float32)])
    return ExclusionIndex(radii=_t(radii, dev),
                          family_bitmaps=bitmaps(excl.family_bitmaps, dev),
                          ladder_ks=tuple(excl.ladder_ks),
                          family_tags=tuple(excl.family_tags))


def families(fams, device="cuda") -> dict[str, torch.Tensor]:
    """Reference family bitmaps (tag -> uint32 words) as the port's."""
    return {tag: bitmaps(words, device) for tag, words in fams.items()}


def partitioned_graph(pg, device="cuda") -> PartitionedGraph:
    """A reference PartitionedGraph: each partition's bitmap, row map,
    gathered store (with its SQ8 shadow) and subgraph."""
    dev = resolve_device(device)
    parts = tuple(GraphPartition(
        tag=p.tag, bitmap=bitmaps(p.bitmap, dev),
        rows=_t(p.rows, dev, torch.int64),
        store=vector_store(p.store, dev), graph=hnsw_graph(p.graph, dev))
        for p in pg.partitions)
    return PartitionedGraph(partitions=parts, built_n=int(pg.built_n))


def _layout(cls, layout):
    if layout is None:
        return None
    return cls(**{f.name: getattr(layout, f.name)
                  for f in dataclasses.fields(cls)})


def storage_engine(engine) -> StorageEngine:
    """A reference StorageEngine: its layouts, pool capacity and policy,
    fault plan, and the resident pages of its pool in the pool's order
    (with their clock bits and dirty marks), so a warm pool starts both
    packages from the same state.  The pool's counters start at zero and
    its fault injector afresh."""
    faults = None
    if engine.faults is not None:
        faults = FaultPlan(**{f.name: getattr(engine.faults, f.name)
                              for f in dataclasses.fields(FaultPlan)})
    out = StorageEngine(
        _layout(HeapLayout, engine.heap),
        scann=_layout(ScannLeafLayout, engine.scann),
        graph=_layout(GraphAdjacencyLayout, engine.graph),
        capacity_pages=int(engine.pool.capacity),
        policy=engine.pool.policy,
        qheap=_layout(HeapLayout, engine.qheap), faults=faults,
        delta=_layout(HeapLayout, engine.delta),
        wal_pages=int(engine.wal_pages))
    out.pool.restore(list(engine.pool._pages.items()),
                     sorted(engine.pool._dirty))
    return out


def mutable_index(index, wal_path: str, ckpt_dir: str,
                  device="cuda") -> MutableIndex:
    """A reference MutableIndex: its store with the SQ8 shadow, graph and
    ScaNN index (as they are, not rebuilt), delta tier, tombstones,
    applied_lsn, capacities, settings and counters.  The port's index
    logs to `wal_path` (copy the reference's log there to continue it)
    and checkpoints to `ckpt_dir`; a storage engine comes across warm."""
    dev = resolve_device(device)
    plan = None
    if index.faults is not None:
        plan = FaultPlan(**{f.name: getattr(index.faults, f.name)
                            for f in dataclasses.fields(FaultPlan)})
    out = MutableIndex(
        np.asarray(index.store.vectors), wal_path, ckpt_dir,
        metric=index.metric, capacity=index.capacity,
        delta_capacity=index.delta_capacity, num_leaves=index.num_leaves,
        graph_m=index.graph_m, ef_construction=index.ef_construction,
        seed=index.seed, with_graph=index.with_graph,
        with_scann=index.with_scann, with_storage=index.with_storage,
        storage_capacity_frac=index.storage_capacity_frac,
        wal_pages=index.wal_pages_budget, faults=plan, device=dev,
        _defer_build=True)
    out.store = vector_store(index.store, dev)
    out.graph = None if index.graph is None else hnsw_graph(index.graph, dev)
    out.scann = None if index.scann is None else scann_index(index.scann,
                                                             dev)
    out._executors = {}
    out.engine = None if index.engine is None \
        else storage_engine(index.engine)
    if out.engine is not None and out._injector is not None:
        out.engine.pool.faults = out._injector
    d = index.delta
    out.delta = DeltaTier(base_n=int(d.base_n), capacity=int(d.capacity),
                          dim=int(d.dim), count=int(d.count),
                          version=int(d.version),
                          vectors=np.array(d.vectors, np.float32),
                          inserted_bytes=int(d.inserted_bytes), device=dev)
    out.tombstones = Tombstones(int(index.tombstones.capacity),
                                words=index.tombstones.words, device=dev)
    out.tombstones.version = int(index.tombstones.version)
    out.applied_lsn = int(index.applied_lsn)
    out._ckpt_step = int(index._ckpt_step)
    out.compactions = int(index.compactions)
    out.user_bytes = int(index.user_bytes)
    out._open_wal()
    return out


def lm_params(params, device="cuda"):
    """A reference model's parameter pytree (nested dicts of arrays, layers
    stacked (L, ...) or (G, group, ...)) as the port's nested dicts of
    tensors, same keys, shapes and dtypes (float32 and integer arrays)."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: lm_params(v, dev) for k, v in params.items()}
    return _t(params, dev)


def arch_config(cfg) -> ArchConfig:
    """A reference ArchConfig as the port's, field by field."""
    return ArchConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(ArchConfig)})
