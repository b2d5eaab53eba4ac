"""The pieces of the `sp` scheme that cross a rank's positions, held to
the one-process functions on the CPU without spawning ranks: each rank
of S runs in turn against `_Emulated`, which plays `GroupShards`'
forward (a first pass records every rank's blocks at each collective,
a second hands them back put together), so every rank's output over its
positions is compared with the one-process output over the whole
sequence:

* the positions and rows a rank holds (`batch_specs(shard_seq=True)`);
* causal and sliding-window attention of a rank's queries against every
  key (`flash_attention(q_offset=)`);
* the halo a causal shift and Mamba2's conv read (`layers.halo`), and
  RWKV6's token shift (`ssm._shift`);
* the state handed across ranks (`ssm.carry_in`, `ssm.split_scan`) for
  the RWKV6 scan and chunked forms and the Mamba2 SSD: bit-equal on two
  ranks, where rank 1 starts from rank 0's final state as the one
  process hands it on, within 1e-5 on four;
* the MoE route of positions gathered over `model`
  (`layers.moe_route(seq=)`) equal to the whole rows' route;
* the VLM prefix by global position (`vlm._prefix`).

The gradients through these pieces, on real ranks, are
`test_torch_tp_sp.py`'s and `test_torch_tp_sp_ssm.py`'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import vlm


class _Emulated:
    """Rank `rank` of `num_shards` in turn: `gather` records this rank's
    block at each call (`record`), or returns every rank's recorded
    blocks put together."""

    def __init__(self, rank, num_shards, store, record):
        self.rank, self.num_shards = rank, num_shards
        self.store, self.record, self.calls = store, record, 0

    def gather(self, x, dim, summed=True):
        i, self.calls = self.calls, self.calls + 1
        if self.record:
            self.store.setdefault(i, {})[self.rank] = x.clone()
            return torch.cat([x] * self.num_shards, dim)
        return torch.cat([self.store[i][j] for j in range(self.num_shards)],
                         dim)


def on_ranks(fn, blocks):
    """`fn(block, seq)` on every rank's block, as the ranks run it
    together: every rank's output."""
    s, store = len(blocks), {}
    for r, b in enumerate(blocks):
        fn(b, _Emulated(r, s, store, True))
    return [fn(b, _Emulated(r, s, store, False))
            for r, b in enumerate(blocks)]


def _split(x, s, dim=1):
    return list(torch.chunk(x, s, dim))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_a_rank_holds_its_rows_and_positions(shape):
    cfg = dataclasses.replace(smoke_config("granite-8b"),
                              sharding_scheme="sp")
    mesh = make_mesh(shape, ("data", "model"))
    leaf = torch.empty((8, 32), device="meta")
    spec = SH.batch_specs(cfg, {"t": leaf}, mesh, shard_seq=True)["t"]
    assert spec == ("data", "model") if shape[0] > 1 else (None, "model")
    d, s = shape
    for c in np.ndindex(*shape):
        rows, pos = SH.NamedSharding(mesh, spec).slices((8, 32), c)
        assert (rows.start, rows.stop) == (c[0] * 8 // d,
                                           (c[0] + 1) * 8 // d)
        assert (pos.start, pos.stop) == (c[1] * 32 // s,
                                         (c[1] + 1) * 32 // s)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("window", [0, 5])
def test_a_ranks_queries_attend_at_their_offset(s, window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    whole = L.flash_attention(q, k, v, causal=True, window=window)
    t = 32 // s
    for r in range(s):
        mine = L.flash_attention(q[:, r * t:(r + 1) * t], k, v, causal=True,
                                 window=window, q_offset=r * t)
        torch.testing.assert_close(mine, whole[:, r * t:(r + 1) * t],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("n", [1, 3])
def test_halo_is_the_previous_ranks_last_positions(s, n):
    x = torch.randn(2, 32, 8, generator=torch.Generator().manual_seed(1))
    padded = torch.cat([x.new_zeros(2, n, 8), x], 1)
    t = 32 // s
    got = on_ranks(lambda b, seq: L.halo(b, n, seq), _split(x, s))
    for r, h in enumerate(got):
        assert torch.equal(h, padded[:, r * t:r * t + n])
    shifted = on_ranks(lambda b, seq: ssm._shift(b, seq), _split(x, s))
    assert torch.equal(torch.cat(shifted, 1), ssm._shift(x))


def test_carry_in_is_the_recurrence_over_segments():
    g = torch.Generator().manual_seed(2)
    ld = -torch.rand(4, 3, 1, generator=g)
    f = torch.randn(4, 3, 5, generator=g)
    want = torch.zeros(3, 5)
    for r in range(4):
        assert torch.equal(ssm.carry_in(ld, f, r), want)
        want = torch.exp(ld[r]) * want + f[r]
    # two segments: segment 1 starts from segment 0's final state exactly
    assert torch.equal(ssm.carry_in(ld[:2], f[:2], 1), f[0])


def _rwkv_inputs(seed=3, t=32):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(2, t, 2, 8, generator=g) for _ in range(3))
    w_log = -torch.exp(torch.randn(2, t, 2, 8, generator=g) - 1)
    u = torch.randn(2, 8, generator=g)
    return r, k, v, w_log, u


RECURRENCES = {
    "rwkv_scan": lambda r, k, v, w, u, init: ssm._rwkv_scan(
        r, k, v, w, u, init),
    "rwkv_chunked": lambda r, k, v, w, u, init: ssm._rwkv_chunked(
        r, k, v, w, u, 8, init),
}


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", sorted(RECURRENCES) + ["ssd"])
def test_split_scan_hands_the_state_across_ranks(name, s):
    if name == "ssd":
        g = torch.Generator().manual_seed(4)
        x = torch.randn(2, 32, 2, 8, generator=g)
        a_log = -torch.rand(2, 32, 2, generator=g)
        bm, cm = (torch.randn(2, 32, 4, generator=g) for _ in range(2))

        def run(parts, init):
            return ssm._ssd_chunked(*parts, 8, init)
        ins, state = (x, a_log, bm, cm), (2, 2, 8, 4)

        def decay(parts):
            return parts[1].sum(1)
    else:
        fn = RECURRENCES[name]

        def run(parts, init):
            return fn(*parts[:4], u, init)
        *ins, u = _rwkv_inputs()
        state = (2, 2, 8, 8)

        def decay(parts):
            return parts[3].sum(1)
    whole, _ = run(ins, None)
    blocks = list(zip(*(_split(a, s) for a in ins)))
    got = on_ranks(lambda b, seq: ssm.split_scan(
        lambda init: run(b, init), decay(b), state, seq), blocks)
    got = torch.cat(got, 1)
    if s == 2:
        assert torch.equal(got, whole)
    else:
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_moe_routes_whole_rows_of_gathered_positions(s):
    cfg = smoke_config("granite-moe-1b-a400m")
    g = torch.Generator().manual_seed(5)
    params = L.init_moe(g, cfg)
    x = torch.randn(4, 32, cfg.d_model, generator=g)
    xt, gate, route, cap = L.moe_route(params, x, cfg)
    for got in on_ranks(lambda b, seq: L.moe_route(params, b, cfg, seq=seq),
                        _split(x, s)):
        mine_xt, mine_gate, mine_route, mine_cap = got
        assert mine_cap == cap
        torch.testing.assert_close(mine_xt, xt, rtol=0, atol=0)
        torch.testing.assert_close(mine_gate, gate, rtol=1e-6, atol=1e-7)
        for a, b in zip(mine_route, route):
            assert torch.equal(a, b)


@pytest.mark.parametrize("s, want", [(2, [(16, 0), (0, 16)]),
                                     (4, [(8, 0), (8, 8), (0, 16),
                                          (0, 24)])])
def test_the_vlm_prefix_falls_by_global_position(monkeypatch, s, want):
    cfg = smoke_config("llava-next-mistral-7b")
    patches = torch.zeros(2, 16 // s, cfg.d_model)
    got = []
    for r in range(s):
        monkeypatch.setattr(vlm, "seq_shards",
                            lambda *_, r=r: _Emulated(r, s, {}, True))
        got.append(vlm._prefix(patches, 32 // s, cfg))
    assert got == want
