"""What `chip_smoke.py` and the scripts in `tools_torch/` share, on the CPU:
the relative L2 error that holds a bf16 kernel against its plain version,
and where the build puts a library of another checkout's source."""
import shutil

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.measure import rel_l2


def test_rel_l2_reads_the_whole_and_the_worst_row():
    want = torch.tensor([[3.0, 4.0], [6.0, 8.0]])
    got = want.clone()
    got[1, 0] += 1.0                     # row 1: |d| 1 of |w| 10
    whole, worst = rel_l2(got, want)
    assert whole == pytest.approx(1.0 / 125.0 ** 0.5)
    assert worst == pytest.approx(0.1)
    assert rel_l2(want.to(torch.bfloat16), want) == (0.0, 0.0)


def test_rel_l2_sees_one_dropped_key_tile():
    # the tolerance's control, on the plain version: attention over S keys
    # without its last 64 reads about sqrt(64 / S) relative L2, far above
    # the tensor-core route's limit of 1e-2
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1024, 2, 80, generator=g) for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, False)
    cut = ref.flash_attention_ref(q, k[:, :-64], v[:, :-64], False)
    whole, worst = rel_l2(cut, want)
    assert 0.1 < whole < 0.5 and worst > whole


def test_a_source_from_another_directory_builds_into_its_own(tmp_path):
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    shutil.copy(build.CSRC / "distance.cu", src / "distance.cu")
    same = build._lib_path("distance", src, out)
    assert same.parent == out
    assert same.name == build._lib_path("distance").name
    (src / "distance.cu").write_text("// another version\n")
    assert build._lib_path("distance", src, out).name != same.name
