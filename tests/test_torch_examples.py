"""The port's twins of the three example entry points
(`repro_torch.filtered_search_study`, `rag_serving`, `train_lm`) on the
CPU: each runs end to end at a small shape, and against the reference.

* The study's 3 x 3 x 5 grid (`study`) on the reference's store, graph,
  ScaNN index and bitmaps carried across (`interop`) against the
  reference library's loop of examples/filtered_search_study.py on the
  same objects: recall@10 within 0.01, the SYSTEM and LIBRARY modeled
  QPS within 2 %, the adaptive planner's choice equal.
* The RAG twin's `serve` with the reference's LM weights, sharded ScaNN
  index and bitmaps carried across and the reference's projection as
  `embed_fn`: the reference's retrieved ids and augmented prompts.
* `train_lm`: a crash at step 2 of 4 resumed from the latest checkpoint
  onto the straight run's losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import smoke_config as jsmoke
from repro.core.distributed import (DistributedScannExecutor,
                                    build_sharded_scann)
from repro.data import DatasetSpec as JSpec
from repro.data import make_dataset as jmake
from repro.launch.mesh import make_mesh as jmesh
from repro.models import build_model as jbuild
from repro.serving import RetrievalAugmentedServer
from repro_torch import filtered_search_study as study_mod
from repro_torch import interop, rag_serving, train_lm
from repro_torch.models import build_model

torch.set_num_threads(1)

N, DIM, CLUSTERS, QUERIES, LEAVES = 400, 16, 8, 2, 24


def _reference_grid(store, queries, graph, index, bitmaps):
    """examples/filtered_search_study.py's loop on built state."""
    p = R.SearchParams(k=10, ef_search=96, beam_width=512, max_hops=2048,
                       num_leaves_to_search=24)
    rows = []
    for corr in study_mod.CORRS:
        for sel in study_mod.SELS:
            bm = bitmaps[(corr, sel)]
            _, tid = R.filtered_knn(store, queries, bm, 10)
            for m in study_mod.METHODS:
                ex = R.make_executor(m, store, graph=graph, index=index)
                res = ex.search(queries, bm, p)
                rec = float(np.mean(np.asarray(jax.vmap(
                    lambda f, t: R.recall_at_k(f, t, 10))(res.ids, tid))))
                tag = m if m != "adaptive" else f"adaptive>{res.strategy}"
                rows.append({"corr": corr, "sel": sel, "method": tag,
                             "recall": rec,
                             "sys_qps": R.modeled_qps(res.stats, store.dim,
                                                      R.SYSTEM),
                             "lib_qps": R.modeled_qps(res.stats, store.dim,
                                                      R.LIBRARY)})
    return rows


def test_study_grid_matches_the_reference_loop(capsys):
    store, queries = jmake(JSpec("study", N, DIM, "l2", clusters=CLUSTERS),
                           num_queries=QUERIES)
    queries = jnp.asarray(queries)
    graph = R.build_graph(store, m=16, ef_construction=64, seed=0)
    index = R.build_scann(store, num_leaves=LEAVES, levels=2, seed=0)
    bitmaps = {(c, s): R.generate_bitmaps(store, queries,
                                          R.WorkloadSpec(s, c),
                                          seed=study_mod.BITMAP_SEED)
               for c in study_mod.CORRS for s in study_mod.SELS}
    want = _reference_grid(store, queries, graph, index, bitmaps)
    got = study_mod.study(
        interop.vector_store(store, "cpu"),
        torch.as_tensor(np.array(queries)),
        interop.hnsw_graph(graph, "cpu"), interop.scann_index(index, "cpu"),
        {k: interop.bitmaps(v, "cpu") for k, v in bitmaps.items()})
    assert len(got) == len(want) == 45
    for g, w in zip(got, want):
        cell = (w["corr"], w["sel"], w["method"])
        assert (g["corr"], g["sel"], g["method"]) == cell
        assert abs(g["recall"] - w["recall"]) <= 0.01, cell
        for k in ("sys_qps", "lib_qps"):
            assert abs(g[k] / w[k] - 1) <= 0.02, (cell, k, g[k], w[k])
    out = capsys.readouterr().out
    assert "adaptive>" in out and out.count("\n") >= 46


def test_study_main_runs_on_the_cpu(capsys):
    rows = study_mod.main(device="cpu", n=300, dim=8, clusters=4,
                          num_queries=QUERIES, num_leaves=12)
    assert len(rows) == 45
    assert {r["method"].split(">")[0] for r in rows} == set(
        study_mod.METHODS)
    assert all(0.0 <= r["recall"] <= 1.0 and r["sys_qps"] > 0
               and r["lib_qps"] > 0 for r in rows)
    assert "Fig. 1's point" in capsys.readouterr().out


def test_rag_twin_retrieves_the_reference_ids(capsys):
    n = 1024
    cfg = jsmoke("llama3.2-3b")
    jb = jbuild(cfg)
    jp = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    store, _ = jmake(JSpec("docs", n, 64, "l2", clusters=16), num_queries=1)
    docs = rng.randint(0, cfg.vocab, (n, 8)).astype(np.int32)
    sharded = build_sharded_scann(store, jmesh((1,), ("data",)), "data",
                                  num_leaves=16, levels=1)
    prompts = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    q = jnp.asarray(rng.randn(2, 64).astype(np.float32))
    bm = jnp.concatenate([
        R.generate_bitmaps(store, q[:1], R.WorkloadSpec(0.2, "none"), 1),
        R.generate_bitmaps(store, q[1:], R.WorkloadSpec(0.05, "none"), 2)])
    server = RetrievalAugmentedServer(
        jb, jp, DistributedScannExecutor(sharded),
        R.SearchParams(k=4, num_leaves_to_search=32), docs, chunk_len=8)
    want = server.retrieve(prompts, bm)
    # the reference's projection (its default embed_fn's PRNGKey(7) draw)
    proj = torch.as_tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (cfg.d_model, 64), jnp.float32)
        / np.sqrt(cfg.d_model)))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    got = rag_serving.serve(
        build_model(interop.arch_config(cfg)), tp,
        interop.sharded_fvs(sharded, "cpu"), docs, prompts,
        interop.bitmaps(bm, "cpu"), max_new_tokens=4,
        embed_fn=lambda p, tok: p["embed"]["tok"].to(torch.float32)[
            tok].mean(1) @ proj)
    np.testing.assert_array_equal(got["ids"], np.asarray(want.ids))
    assert got["augmented_len"] == want.tokens.shape[1] == 16 + 4 * 8
    assert got["tokens"].shape == (2, 4) and got["decoded_tokens"] == 6
    assert "retrieved ids per request" in capsys.readouterr().out


def test_rag_main_runs_on_the_cpu(capsys):
    out = rag_serving.main(device="cpu", n=1024, num_leaves=16)
    assert out["ids"].shape == (2, 4) and out["tokens"].shape == (2, 12)
    assert out["augmented_len"] == 16 + 4 * 8
    assert "decode throughput" in capsys.readouterr().out


def test_train_lm_crash_resumes_onto_the_straight_run(tmp_path, capsys):
    # a checkpoint every step; the crash at step 2 may catch step 2's
    # asynchronous write in flight, so the run resumes from step 1 or 2
    kw = dict(device="cpu", steps=4, seq_len=32, batch=2, d_model=64,
              n_layers=2, log_every=1)
    straight = train_lm.main(checkpoint_dir=str(tmp_path / "a"), **kw)
    assert [h["step"] for h in straight] == [1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        train_lm.main(checkpoint_dir=str(tmp_path / "b"), fail_at=2, **kw)
    resumed = train_lm.main(checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed and resumed[0]["step"] in (2, 3)
    assert [(h["step"], h["loss"]) for h in resumed] == \
        [(h["step"], h["loss"]) for h in straight[-len(resumed):]]
    assert "start: 0" in capsys.readouterr().out


def test_train_lm_config_is_the_example_s():
    cfg = train_lm.config()
    assert cfg.name == "llama3.2-3b" and cfg.family == "dense"
    assert (cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab, cfg.n_heads,
            cfg.n_kv, cfg.d_head) == (256, 6, 1024, 2048, 8, 4, 32)
