"""Shared pieces of the benchmark's CPU tests: the repository's paths and
each cell cut to a size a test run holds."""
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from fvsbench import harness  # noqa: E402

CELLS = ("sift1m.acorn.sel10", "cohere1m.scann.sel01")


def tiny(name: str, dim: int = 16, batch: int = 32, pool: int = 64
         ) -> harness.Cell:
    """The cell as BENCHMARK.json has it, its data cut to test size and
    its batch and pool to test sizes; everything else as configured.  A
    ScaNN cell keeps 500 rows a leaf and opens half of its 80 leaves, so
    that a query's opened leaves hold many more passing rows than it
    rescores, as at full size; a graph cell holds 2,000 rows."""
    cell = harness.load_cell(ROOT, name)
    scann = cell.method.startswith("scann")
    cfg = dict(cell.config, n=40_000 if scann else 2000, dim=dim, clusters=8)
    cfg["scann"] = dict(cfg["scann"], num_leaves=80)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, batch=batch,
                                            pool=pool))


def run_tiny(name: str, seed: int = 5, seconds: float = 0.2,
             traced: bool = False, **kw) -> dict:
    return harness.run_cell(ROOT, name, seed, seconds, traced, device="cpu",
                            cell=tiny(name), **kw)
