"""The port's frontier engine against the reference, filter-first
strategies (acorn, navix with each of its heuristics), on the reference's
own graph carried across: exact fixture bit for bit, float fixture within
tolerance (tensors on the CPU)."""
import dataclasses

import pytest

import repro.core as R
from torch_parity import check, fixture_kind, FIXTURES, run_both  # noqa: F401

BASE = R.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=256)


@pytest.mark.parametrize("workload", ["med_pos_0.1", "none_0.02"])
def test_acorn_parity(fixture_kind, workload):
    jres, tres = run_both(FIXTURES[fixture_kind](), "acorn", BASE, workload)
    check(fixture_kind, jres, tres)


@pytest.mark.parametrize("heuristic", ["blind", "directed", "onehop",
                                       "adaptive"])
def test_navix_parity(fixture_kind, heuristic):
    p = dataclasses.replace(BASE, navix_heuristic=heuristic)
    jres, tres = run_both(FIXTURES[fixture_kind](), "navix", p)
    check(fixture_kind, jres, tres)


@pytest.mark.parametrize("knobs", [
    dict(adaptive_skip_2hop=False),
    dict(frontier_chunk2=0),                 # 2-hop block in one chunk
    dict(translation_map=False),
])
def test_acorn_knobs_exact(knobs):
    jres, tres = run_both(FIXTURES["exact"](), "acorn",
                          dataclasses.replace(BASE, **knobs), "none_0.02")
    check("exact", jres, tres)
