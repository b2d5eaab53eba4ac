"""The port's HNSW builders against the reference's on the clustered float
fixture.  The dense distances run as torch instead of numpy, so sums are
taken in another order and a near-tie may flip: at least 99 % of the
neighbor-table entries must agree (tensors on the CPU)."""
import numpy as np
import pytest

import repro.core as R
from repro.core.hnsw import build_graph_blocked as jblocked
import repro_torch.core as T
from torch_parity import FIXTURES, torch_params


def _agree(tg, jg) -> float:
    a, b = tg.neighbors.numpy(), np.asarray(jg.neighbors)
    assert a.shape == b.shape
    return float((a == b).mean())


def test_build_graph_matches_reference():
    fx = FIXTURES["float"]()
    tg = T.build_graph(fx["store"], m=12, ef_construction=48, seed=0,
                       device="cpu")
    assert _agree(tg, fx["jgraph"]) >= 0.99
    assert tg.entry_point == int(fx["jgraph"].entry_point)
    np.testing.assert_array_equal(tg.node_level.numpy(),
                                  np.asarray(fx["jgraph"].node_level))


@pytest.mark.parametrize("exact_threshold", [1000, 20_000])
def test_build_graph_blocked_matches_reference(exact_threshold):
    # 1000 < n = 4000 takes the cluster-routed path on the base level
    fx = FIXTURES["float"]()
    jg = jblocked(fx["jstore"], m=12, ef_construction=48, seed=0,
                  exact_threshold=exact_threshold)
    tg = T.build_graph_blocked(fx["store"], m=12, ef_construction=48, seed=0,
                               exact_threshold=exact_threshold, device="cpu")
    assert _agree(tg, jg) >= 0.99


def test_own_graph_search_recall():
    fx = FIXTURES["float"]()
    tg = T.build_graph_blocked(fx["store"], m=12, ef_construction=48, seed=0,
                               exact_threshold=1000, device="cpu")
    bm = fx["bitmaps"]["med_pos_0.1"]
    _, truth = T.filtered_knn(fx["store"], fx["q"], bm, 10)
    p = torch_params(R.SearchParams(k=10, ef_search=64, beam_width=128,
                                    max_hops=512))
    res = T.make_executor("sweeping", fx["store"], graph=tg,
                          device="cpu").search(fx["q"], bm, p)
    assert float(T.recall_at_k(res.ids, truth, 10).mean()) >= 0.9
