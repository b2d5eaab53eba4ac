"""The port's sharded ScaNN executor, distributed k-means, the several-
process counterpart of `shard_map`, `serve --rag`, the mesh factory, the
streamed dataset and the sharded cost summary, against the reference on
the same numpy inputs.

The reference's `DistributedScannExecutor` needs S devices: its outputs
for S in {2, 4, 8} are computed once, in a subprocess with 8 forced XLA
host devices (as `tests/test_distributed.py` does), on the fixtures'
indexes written to disk, and held against the port's stacked mode on the
same index carried across.  The process-group runner is checked with 4
gloo ranks in one subprocess whose path holds only `src/`."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import interop
from repro_torch.core import costmodel as tcost
from repro_torch.core.distributed import (DistributedScannExecutor,
                                          distributed_kmeans_fn, shard_index)
from repro_torch.launch import mesh as tmesh

from torch_parity import (COUNTERS, exact_fixture, float_fixture,
                          recall_vs, torch_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SHARDS = (2, 4, 8)
FIXTURES = {"exact": exact_fixture, "float": float_fixture}


def _scann_params() -> "R.SearchParams":
    return R.SearchParams(k=10, num_leaves_to_search=12, reorder_factor=6)


_REFERENCE_SCANN = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, sys.argv[2])
    import json
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import SearchParams, VectorStore
    from repro.core.scann import ScannIndex
    from repro.core.distributed import (DistributedScannExecutor,
                                        shard_index)
    d = dict(np.load(sys.argv[1] + "/in.npz"))
    meta = json.load(open(sys.argv[1] + "/in.json"))
    out = {}
    for kind in meta["kinds"]:
        g = {k[len(kind) + 1:]: v for k, v in d.items()
             if k.startswith(kind + ":")}
        idx = ScannIndex(**{f: jnp.asarray(g["ix_" + f])
                            for f in meta["index_fields"]},
                         metric=meta["metric"], levels=meta["levels"])
        store = VectorStore(vectors=jnp.asarray(g["vectors"]),
                            norms_sq=jnp.asarray(g["norms_sq"]),
                            metric=meta["metric"])
        p = SearchParams(**meta["params"])
        for S in meta["shards"]:
            mesh = Mesh(np.asarray(jax.devices()[:S]), ("data",))
            sh = shard_index(idx, store, mesh, "data")
            res = DistributedScannExecutor(sh).search(
                jnp.asarray(g["queries"]), jnp.asarray(g["bitmaps"]), p)
            out[f"{kind}:{S}:ids"] = np.asarray(res.ids)
            out[f"{kind}:{S}:dists"] = np.asarray(res.dists)
            for c in meta["counters"]:
                out[f"{kind}:{S}:{c}"] = np.asarray(getattr(res.stats, c))
    np.savez(sys.argv[1] + "/out.npz", **out)
""")

_INDEX_FIELDS = ("leaf_tiles", "leaf_rowids", "leaf_centroids", "scale",
                 "mean", "branch_centroids", "branch_leaves", "pca")


@pytest.fixture(scope="module")
def reference_scann(tmp_path_factory):
    """The reference's DistributedScannExecutor on both fixtures for S in
    {2, 4, 8}, from one 8-device subprocess."""
    tmp = tmp_path_factory.mktemp("ref_scann")
    arrays = {}
    for kind, make in FIXTURES.items():
        fx = make()
        for f in _INDEX_FIELDS:
            arrays[f"{kind}:ix_{f}"] = np.asarray(getattr(fx["jscann"], f))
        arrays[f"{kind}:vectors"] = np.asarray(fx["jstore"].vectors)
        arrays[f"{kind}:norms_sq"] = np.asarray(fx["jstore"].norms_sq)
        arrays[f"{kind}:queries"] = np.asarray(fx["jq"])
        arrays[f"{kind}:bitmaps"] = np.asarray(fx["jbitmaps"]["med_pos_0.1"])
    np.savez(tmp / "in.npz", **arrays)
    p = _scann_params()
    meta = {"kinds": list(FIXTURES), "index_fields": list(_INDEX_FIELDS),
            "metric": "l2", "levels": 2, "shards": list(SHARDS),
            "counters": list(COUNTERS),
            "params": {"k": p.k, "num_leaves_to_search":
                       p.num_leaves_to_search,
                       "reorder_factor": p.reorder_factor}}
    (tmp / "in.json").write_text(json.dumps(meta))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SCANN, str(tmp),
                          str(SRC)], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _port_sharded(fx, S: int):
    """The fixture's reference index, padded by the reference's rule and
    carried across, on a stacked mesh of S shards."""
    mesh = tmesh.make_mesh((S,), ("data",))
    return shard_index(fx["scann"], fx["store"], mesh, "data")


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_distributed_scann_matches_reference(reference_scann, kind, S):
    fx = FIXTURES[kind]()
    res = DistributedScannExecutor(_port_sharded(fx, S)).search(
        fx["q"], fx["bitmaps"]["med_pos_0.1"], torch_params(_scann_params()))
    ref_ids = reference_scann[f"{kind}:{S}:ids"]
    if kind == "exact":
        np.testing.assert_array_equal(res.ids.numpy(), ref_ids)
        np.testing.assert_array_equal(
            res.dists.numpy().view(np.int32),
            reference_scann[f"{kind}:{S}:dists"].view(np.int32))
        for c in COUNTERS:
            np.testing.assert_array_equal(
                getattr(res.stats, c).numpy(),
                reference_scann[f"{kind}:{S}:{c}"], err_msg=c)
    else:
        assert recall_vs(res.ids.numpy(), ref_ids) >= 0.99


@pytest.mark.parametrize("S", SHARDS)
def test_distributed_scann_counters_carry_the_mesh(S):
    """hops = S * nsel leaves, index pages = S * nsel * pages a leaf; the
    stats-free search gives the same ids."""
    from repro_torch.core.scann import _quant_pages_per_leaf
    fx = exact_fixture()
    sh = _port_sharded(fx, S)
    p = torch_params(_scann_params())
    res = DistributedScannExecutor(sh).search(fx["q"], fx["bitmaps"][
        "med_pos_0.1"], p)
    nsel = min(max(1, -(-p.num_leaves_to_search // S)),
               sh.index.num_leaves // S)
    assert (res.stats.hops == S * nsel).all()
    assert (res.stats.page_accesses_index
            == S * nsel * _quant_pages_per_leaf(sh.index)).all()
    plain = DistributedScannExecutor(sh, with_stats=False).search(
        fx["q"], fx["bitmaps"]["med_pos_0.1"], p)
    assert plain.stats is None and torch.equal(plain.ids, res.ids)
    # leaf-ordered heaps: a shard drops the candidates outside its rows
    leaf = DistributedScannExecutor(sh, heap_layout="leaf_ordered").search(
        fx["q"], fx["bitmaps"]["med_pos_0.1"], p)
    assert leaf.ids.shape == res.ids.shape
    assert bool((leaf.stats.reorder_rows <= res.stats.reorder_rows).all())
    assert bool((leaf.stats.reorder_rows < res.stats.reorder_rows).any())
    with pytest.raises(ValueError, match="heap_layout"):
        DistributedScannExecutor(sh, heap_layout="striped").search(
            fx["q"], fx["bitmaps"]["med_pos_0.1"], p)


def test_shard_index_pads_like_the_reference():
    fx = exact_fixture()
    from repro.core.distributed import shard_index as rshard

    class OneAxis:        # a 3-device mesh's shape and axis names
        shape = {"data": 3}
        axis_names = ("data",)
    ref = rshard(fx["jscann"], fx["jstore"], OneAxis(), "data")
    port = shard_index(fx["scann"], fx["store"],
                       tmesh.make_mesh((3,), ("data",)), "data")
    for f in ("leaf_tiles", "leaf_rowids", "leaf_centroids"):
        np.testing.assert_array_equal(getattr(port.index, f).numpy(),
                                      np.asarray(getattr(ref.index, f)))
    carried = interop.sharded_fvs(ref, "cpu")
    assert carried.num_shards == 3 and carried.mesh.group is None
    np.testing.assert_array_equal(carried.index.leaf_rowids.numpy(),
                                  np.asarray(ref.index.leaf_rowids))


def test_distributed_kmeans_matches_reference_at_one_shard():
    from repro.core.distributed import distributed_kmeans_fn as rkm
    fx = float_fixture()
    x = np.array(fx["jstore"].vectors)
    init = x[np.random.RandomState(0).choice(len(x), 8, False)]
    want = np.asarray(rkm(jax.make_mesh((1,), ("data",)), "data", k=8,
                          iters=5)(jnp.asarray(x), jnp.asarray(init)))
    got = distributed_kmeans_fn(tmesh.make_mesh((1,), ("data",)), "data",
                                k=8, iters=5)(torch.as_tensor(x),
                                              torch.as_tensor(init))
    assert float(np.abs(got.numpy() - want).max()) < 1e-3
    got4 = distributed_kmeans_fn(tmesh.make_mesh((4,), ("data",)), "data",
                                 k=8, iters=5)(torch.as_tensor(x),
                                               torch.as_tensor(init))
    assert float((got4 - got).abs().max()) < 1e-3


def test_sharded_cycle_summary_matches_reference():
    z = np.full((4,), 2_000, np.int32)
    hops = np.full((4,), 400, np.int32)
    jst = R.SearchStats(*(jnp.asarray(a) for a in
                          (z, z, hops, z // 10, z // 10, z * 0, z * 0)))
    tst = T.SearchStats(*(torch.as_tensor(a) for a in
                          (z, z, hops, z // 10, z // 10, z * 0, z * 0)))
    from repro.core import costmodel as rcost
    for E in (1, 4):
        p = R.SearchParams(k=10, ef_search=32, beam_width=128,
                           strategy="sweeping", max_hops=150,
                           beam_exchange_interval=E)
        for S in (1, 8):
            for quant in ("none", "sq8"):
                want = rcost.sharded_cycle_summary(jst, p, 768, S,
                                                   graph_quant=quant)
                got = tcost.sharded_cycle_summary(tst, torch_params(p), 768,
                                                  S, graph_quant=quant)
                assert got == want, (E, S, quant)


@pytest.mark.parametrize("shape,axes,match", [
    ((2, 4), ("data",), "one name per dim"),
    ((0,), ("data",), "non-positive"),
    ((2, 2), ("data", "data"), "duplicate"),
    ((2,), ("shrad",), "did you mean 'shard'"),
    ((3,), ("data",), "divisible"),
])
def test_mesh_validation_messages_match_reference(shape, axes, match):
    from repro.launch.mesh import validate_mesh_request as rvalidate
    kw = {"num_devices": 8} if match == "divisible" else {}
    with pytest.raises(ValueError, match=match) as rerr:
        rvalidate(shape, axes, **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tmesh.validate_mesh_request(shape, axes, **kw)
    assert str(terr.value) == str(rerr.value)


def test_make_mesh_and_batch_axes():
    tmesh.validate_mesh_request((2, 4), ("data", "model"))
    m = tmesh.make_mesh((1,), ("shard",))
    assert m.axis_names == ("shard",) and m.shape == {"shard": 1}
    assert m.group is None and m.devices.shape == (1,)
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.batch_axes(prod) == ("pod", "data")
    assert tmesh.KNOWN_AXES == ("pod", "data", "model", "shard")


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_streamed_dataset_matches_reference(metric, f32):
    """Rows, queries and the SQ8 shadow byte-equal to the reference's with
    a small block_rows; the shadow norms equal the port's batch quantizer
    and sit within float32 rounding of the reference's."""
    from repro.data import DatasetSpec as RSpec
    from repro.data import make_dataset_streamed as rstream
    from repro_torch.data import DatasetSpec, make_dataset_streamed
    shape = (3000, 16, metric)
    rs, rq = rstream(RSpec("t-stream", *shape, clusters=8), num_queries=6,
                     seed=3, block_rows=512, f32=f32)
    ts, tq = make_dataset_streamed(DatasetSpec("t-stream", *shape,
                                               clusters=8), num_queries=6,
                                   seed=3, block_rows=512, f32=f32,
                                   device="cpu")
    assert np.asarray(rq).tobytes() == tq.numpy().tobytes()
    for f in ("vectors", "q_vectors", "q_scale", "q_mean"):
        assert np.asarray(getattr(rs, f)).tobytes() == \
            getattr(ts, f).numpy().tobytes(), f
    np.testing.assert_allclose(ts.q_norms_sq.numpy(),
                               np.asarray(rs.q_norms_sq), rtol=1e-6)
    if f32:
        q = T.quantize_store(T.VectorStore(ts.vectors, ts.norms_sq, metric))
        assert torch.equal(q.q_norms_sq, ts.q_norms_sq)
    else:
        assert ts.vectors.stride() == (0, 1) and not ts.vectors.any()


def test_serve_rag_runs_on_the_cpu(capsys):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    out = serve.main(["--arch", "granite-8b", "--device", "cpu", "--rag",
                      "--prompt-len", "6", "--max-new", "3", "--batch",
                      "3"])
    text = capsys.readouterr().out
    assert out.shape == (3, 3)
    assert "retrieved ids pass their filters: True" in text
    assert "augmented prompt len: 38" in text
    bundle = build_model(smoke_config("granite-8b"))
    params = bundle.init(0, "cpu")
    prompts = np.zeros((5, 4), np.int32)
    res, bitmaps = serve.rag_retrieve(bundle, params, prompts,
                                      np.random.RandomState(1), 0.05, "cpu")
    ids = torch.as_tensor(res.ids)
    assert ids.shape == (5, 4) and (ids >= 0).any()
    assert bool((T.probe_batch(bitmaps, ids) | (ids < 0)).all())


_GLOO_RANKS = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 4


    def data():
        import repro_torch.core as T
        from repro_torch.data import DatasetSpec, make_dataset
        store, q = make_dataset(DatasetSpec("pg", 3000, 32, "l2",
                                            clusters=12), num_queries=8,
                                seed=0, device="cpu")
        store = T.quantize_store(store)
        graph = T.build_graph(store, m=8, ef_construction=32, seed=0,
                              device="cpu")
        bm = T.generate_bitmaps(store, q, T.WorkloadSpec(0.3, "none"),
                                seed=5, device="cpu")
        return store, q, graph, bm


    def params(quant="none", E=1):
        from repro_torch.core import SearchParams
        return SearchParams(k=10, ef_search=32, beam_width=128,
                            strategy="sweeping", max_hops=150,
                            graph_quant=quant, beam_exchange_interval=E,
                            num_leaves_to_search=12, reorder_factor=6)


    def same(a, b):
        return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    and all(torch.equal(getattr(a[2], f), getattr(b[2], f))
                            for f in ("distance_comps", "filter_checks",
                                      "hops", "page_accesses_index",
                                      "page_accesses_heap", "tmap_lookups",
                                      "reorder_rows")))


    def rank_main(rank, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=WORLD)
        try:
            from repro_torch.core.distributed import (
                DistributedScannExecutor, ShardedGraphExecutor,
                build_sharded_scann, distributed_kmeans_fn,
                sharded_graph_search_fn)
            from repro_torch.launch.mesh import make_mesh
            store, q, graph, bm = data()
            out = {}
            for name, quant, E in (("lockstep", "none", 1),
                                   ("lockstep_sq8", "sq8", 1),
                                   ("drift2", "none", 2)):
                p = params(quant, E)
                got = sharded_graph_search_fn(graph, store, WORLD, p)(q, bm)
                want = ShardedGraphExecutor(graph, store, WORLD,
                                            graph_quant=quant,
                                            device="cpu").search(
                    q, bm, p)
                out[name] = same(got, (want.dists, want.ids, want.stats))
            mesh = make_mesh((WORLD,), ("data",))
            out["group_attached"] = mesh.group is not None
            stacked = type(mesh)(mesh.devices, mesh.axis_names, None)
            sh = build_sharded_scann(store, mesh, "data", num_leaves=32,
                                     levels=1, seed=0, device="cpu")
            res = DistributedScannExecutor(sh).search(q, bm, params())
            import dataclasses
            ref = DistributedScannExecutor(dataclasses.replace(
                sh, mesh=stacked)).search(q, bm, params())
            out["scann_ids"] = bool(torch.equal(res.ids, ref.ids))
            out["scann_stats"] = bool(torch.equal(res.stats.hops,
                                                  ref.stats.hops))
            x = store.vectors
            init = x[torch.arange(8) * 97]
            km = distributed_kmeans_fn(mesh, "data", 8, 5)(x, init)
            km1 = distributed_kmeans_fn(stacked, "data", 8, 5)(x, init)
            out["kmeans_err"] = float((km - km1).abs().max())
            with open(f"{tmp}/rank{rank}.json", "w") as f:
                json.dump(out, f)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD, join=True)
""")


def test_process_group_runner_matches_stacked_on_4_gloo_ranks(tmp_path):
    """The several-process counterpart of shard_map: 4 gloo ranks, each
    holding its row block (or its leaves), against the stacked emulation
    in the same processes."""
    script = tmp_path / "ranks.py"
    script.write_text(_GLOO_RANKS)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(4):
        rec = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert rec["group_attached"], rec
        assert rec["lockstep"] and rec["lockstep_sq8"], rec
        assert rec["drift2"], rec
        assert rec["scann_ids"] and rec["scann_stats"], rec
        assert rec["kmeans_err"] <= 1e-6, rec
