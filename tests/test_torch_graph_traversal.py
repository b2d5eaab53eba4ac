"""The port's frontier engine against the reference, traversal-first
strategies (sweeping, iterative_scan, unfiltered), on the reference's own
graph carried across: exact fixture bit for bit, float fixture within
tolerance (tensors on the CPU)."""
import dataclasses

import pytest

import repro.core as R
from torch_parity import check, fixture_kind, FIXTURES, run_both  # noqa: F401

BASE = R.SearchParams(k=10, ef_search=32, beam_width=64, max_hops=256)


@pytest.mark.parametrize("method", ["sweeping", "iterative_scan",
                                    "unfiltered"])
@pytest.mark.parametrize("workload", ["med_pos_0.1", "none_0.02"])
def test_traversal_first_parity(fixture_kind, method, workload):
    p = dataclasses.replace(BASE, batch_tuples=32, max_rounds=8)
    jres, tres = run_both(FIXTURES[fixture_kind](), method, p, workload)
    check(fixture_kind, jres, tres)


@pytest.mark.parametrize("knobs", [
    dict(frontier_chunk=8),                  # chunked 1-hop scoring
    dict(translation_map=False),             # Fig. 13 ablation counters
    dict(hop_budget=20),                     # anytime budgets
    dict(page_budget=150),
    dict(deadline_cycles=3e5),
])
def test_sweeping_knobs_exact(knobs):
    jres, tres = run_both(FIXTURES["exact"](), "sweeping",
                          dataclasses.replace(BASE, **knobs))
    check("exact", jres, tres)
    assert (tres.anytime.truncated == jres.anytime.truncated).all()
    assert (tres.anytime.budget_exhausted
            == jres.anytime.budget_exhausted).all()


def test_iterative_scan_budget_exact():
    p = dataclasses.replace(BASE, batch_tuples=16, max_rounds=4,
                            hop_budget=40)
    jres, tres = run_both(FIXTURES["exact"](), "iterative_scan", p,
                          "none_0.02")
    check("exact", jres, tres)
