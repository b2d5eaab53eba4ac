"""The port's serving engine (`repro_torch.serving.ServeEngine`) and its
launcher against the reference's, at smoke size on the CPU, with the
reference's weights carried across by `interop.lm_params`.  Greedy tokens
must be equal; temperature sampling draws from a torch.Generator, so it is
checked for determinism under a seed, not against jax.random's draws."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import build_model as jbuild
from repro.serving import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.serving import ServeEngine, ServeStats

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CACHE = {}


def _cfg(arch):
    cfg = RC.smoke_config(arch)
    if arch == "gemma3-12b":       # two 5:1 groups (smoke_config: none)
        cfg = dataclasses.replace(cfg, n_layers=12, window=8)
    return cfg


def _both(arch):
    """(reference bundle and params, the port's) for one smoke config."""
    if arch not in _CACHE:
        cfg = _cfg(arch)
        jb = jbuild(cfg)
        jp = jb.init(jax.random.PRNGKey(0))
        tb = tbuild(interop.arch_config(cfg))
        tp = interop.lm_params(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[arch] = (cfg, jb, jp, tb, tp)
    return _CACHE[arch]


def _prompts(cfg, b, plen, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, plen)
                                               ).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "llama3.2-3b",
                                  "gemma3-12b"])
def test_greedy_tokens_equal_reference(arch):
    cfg, jb, jp, tb, tp = _both(arch)
    prompts = _prompts(cfg, 3, 7)
    want_engine = JEngine(jb, jp, max_seq=7 + 6, batch_size=3)
    want = want_engine.generate(prompts, 6)
    seen = {"prefill": [], "decode": []}

    def kept(kind, fn):
        def run(*a):
            out = fn(*a)
            seen[kind].append(out if kind == "prefill" else out[0])
            return out
        return run

    tbk = dataclasses.replace(tb, prefill=kept("prefill", tb.prefill),
                              decode=kept("decode", tb.decode))
    engine = ServeEngine(tbk, tp, max_seq=7 + 6, batch_size=3, device="cpu")
    got = engine.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(engine.stats) == \
        dataclasses.asdict(want_engine.stats)
    # the replayed prompt reaches the prefill's logits at its last position
    # (decode call 7 of the replay)
    np.testing.assert_allclose(seen["decode"][7 - 1].numpy(),
                               seen["prefill"][0].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stop_token_and_stats_equal_reference():
    cfg, jb, jp, tb, tp = _both("granite-8b")
    prompts = _prompts(cfg, 1, 5, seed=4)
    free = ServeEngine(tb, tp, max_seq=5 + 8, batch_size=1,
                       device="cpu").generate(prompts, 8)
    stop = int(free[0, 3])
    want_engine = JEngine(jb, jp, max_seq=13, batch_size=1)
    want = want_engine.generate(prompts, 8, stop_token=stop)
    engine = ServeEngine(tb, tp, max_seq=13, batch_size=1, device="cpu")
    got = engine.generate(prompts, 8, stop_token=stop)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 4 and got[0, -1] == stop
    assert engine.stats == ServeStats(**dataclasses.asdict(want_engine.stats))
    # stats accumulate over calls as the reference's do
    engine.generate(prompts, 8, stop_token=stop)
    want_engine.generate(prompts, 8, stop_token=stop)
    assert dataclasses.asdict(engine.stats) == \
        dataclasses.asdict(want_engine.stats)


def test_temperature_sampling_is_deterministic_under_a_seed():
    cfg, _, _, tb, tp = _both("granite-8b")
    prompts = _prompts(cfg, 2, 6, seed=2)

    def run(seed):
        eng = ServeEngine(tb, tp, max_seq=14, batch_size=2, temperature=0.8,
                          device="cpu")
        return eng.generate(prompts, 8, seed=seed)

    a, b = run(5), run(5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 8) and a.min() >= 0 and a.max() < cfg.vocab
    assert any(not np.array_equal(run(s), a) for s in (6, 7, 8))


def test_launcher_runs_on_the_cpu(capsys):
    out = tserve.main(["--arch", "granite-8b", "--device", "cpu",
                       "--prompt-len", "6", "--max-new", "4", "--batch",
                       "2"])
    assert out.shape == (2, 4)
    assert "generated (2, 4) tokens" in capsys.readouterr().out
    # --rag retrieves from the sharded ScaNN store first (its checks:
    # tests/test_torch_distributed.py)
    out = tserve.main(["--arch", "granite-8b", "--device", "cpu", "--rag",
                       "--prompt-len", "6", "--max-new", "4", "--batch",
                       "2"])
    assert out.shape == (2, 4)
    assert "retrieved ids pass their filters: True" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_launcher_module_runs_as_a_script():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--device", "cpu", "--prompt-len", "8", "--max-new",
         "4"], capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=env)
    assert out.returncode == 0, out.stderr
    assert "generated (4, 4) tokens" in out.stdout
