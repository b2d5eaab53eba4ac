"""The port on a "cos" store against the JAX reference, on the CPU: the
dense distances, exact (filtered, partial) KNN, the workload generator and
the correlation probe.  Fixture: a 1000 x 16 standard-normal store with
metric "cos" and 4 standard-normal queries (numpy RandomState(0)), k = 5.
The reference's bitmaps cross over as numpy words; the port's own
generator cannot match the reference's RNG bit for bit, so it is held to
the popcount and the nearest-rows properties instead."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import workload as RW
import repro_torch.core as T
from repro_torch import interop
from repro_torch.core.workload import empirical_correlation, full_distances

K = 5
SEL = 0.5


@functools.lru_cache(maxsize=None)
def fixture():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    jstore = R.VectorStore.build(x, metric="cos")
    words = np.asarray(R.generate_bitmaps(jstore, jnp.asarray(q),
                                          R.WorkloadSpec(SEL, "med_pos"),
                                          seed=3))
    return {"x": x, "q": q, "jstore": jstore, "words": words,
            "store": interop.vector_store(jstore, device="cpu"),
            "bitmaps": interop.bitmaps(words, device="cpu")}


def test_full_distances_match_reference():
    fx = fixture()
    want = np.asarray(RW.full_distances(fx["jstore"], jnp.asarray(fx["q"])))
    got = full_distances(fx["store"], torch.as_tensor(fx["q"])).numpy()
    # sqrt and division: float32 rounding only (tests/test_torch_types.py)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_knn_ids_match_reference():
    fx = fixture()
    wd, wi = R.knn(fx["jstore"], jnp.asarray(fx["q"]), K)
    gd, gi = T.knn(fx["store"], torch.as_tensor(fx["q"]), K)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=1e-6)


def test_filtered_knn_ids_match_reference():
    fx = fixture()
    q = fx["q"]
    wd, wi = R.filtered_knn(fx["jstore"], jnp.asarray(q),
                            jnp.asarray(fx["words"]), K)
    gd, gi = T.filtered_knn(fx["store"], torch.as_tensor(q), fx["bitmaps"],
                            K)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("max_rows", [3, 40, 1000])
def test_filtered_knn_partial_matches_reference(max_rows):
    fx = fixture()
    want = R.filtered_knn_partial(fx["jstore"], jnp.asarray(fx["q"]),
                                  jnp.asarray(fx["words"]), K, max_rows)
    got = T.filtered_knn_partial(fx["store"], torch.as_tensor(fx["q"]),
                                 fx["bitmaps"], K, max_rows)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empirical_correlation_matches_reference():
    fx = fixture()
    bits = np.unpackbits(fx["words"].view(np.uint8), axis=1,
                         bitorder="little")[:, :1000].astype(bool)
    for i in range(fx["q"].shape[0]):
        rows = np.flatnonzero(bits[i])
        want = RW.empirical_correlation(fx["jstore"],
                                        jnp.asarray(fx["q"][i]), rows, k=50)
        got = empirical_correlation(fx["store"], torch.as_tensor(fx["q"][i]),
                                    torch.as_tensor(rows), k=50)
        assert got == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("corr", ["high_pos", "none", "negative"])
def test_generate_bitmaps_runs_on_a_cos_store(corr):
    fx = fixture()
    q = torch.as_tensor(fx["q"])
    bm = T.generate_bitmaps(fx["store"], q, T.WorkloadSpec(SEL, corr),
                            seed=4, device="cpu")
    assert bm.shape == (4, 32)
    counts = T.unpack_bitmap(bm, 1000).sum(1)
    assert (counts == round(SEL * 1000)).all()
    if corr == "high_pos":
        # the closest third all pass, the rest of the 500 uniformly: about
        # three quarters of the passing rows are nearer than the median
        d = full_distances(fx["store"], q)
        passing = T.unpack_bitmap(bm, 1000)
        med = d.median(1, keepdim=True).values
        assert bool((d[passing].reshape(4, -1) < med).float().mean() > 0.6)


def test_generate_families_runs_on_a_cos_store():
    fx = fixture()
    fams = T.generate_families(fx["store"], 0.05, num_families=3, seed=0,
                               device="cpu")
    want = R.generate_families(fx["jstore"], 0.05, num_families=3, seed=0)
    assert sorted(fams) == sorted(want)
    for tag, words in fams.items():
        bits = T.unpack_bitmap(words[None], 1000)[0]
        assert int(bits.sum()) == 50
        ref_bits = np.unpackbits(np.asarray(want[tag]).view(np.uint8),
                                 bitorder="little")[:1000].astype(bool)
        # the same centre and the nearest 50 rows by cos distance; a
        # boundary tie may order differently (the reference's unstable
        # argsort)
        assert (bits.numpy() == ref_bits).mean() >= 0.99


@pytest.mark.parametrize("name,extra", [
    ("frontier_scan", 0), ("frontier_scan_sq8", 2),
    ("frontier_scan_excl", 3), ("frontier_scan_excl_sq8", 5)])
def test_cos_frontier_scans_still_refuse_other_devices(name, extra):
    """cos goes to the plain version on the CPU and on the card alike, but
    a device with neither a kernel nor a plain version is still refused."""
    from repro_torch.kernels import ops
    q = torch.zeros(2, 16, device="meta")
    args = [q] + [torch.zeros(4) for _ in range(4 + extra)]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        getattr(ops, name)(*args, metric="cos")
