"""Mesh factory of the port.

A FUNCTION, not a module-level constant: importing this module touches no
device.  Single pod: (data=16, model=16); multi-pod: (pod=2, data=16,
model=16).

`make_mesh` front-loads shape and axis validation with actionable messages
(wrong arity, non-positive or non-divisible dims, duplicate or misspelled
axis names, the closest known spelling suggested), as the reference does.
The port's `Mesh` is a small record: the shape by axis name, the devices
that back it and, when a `torch.distributed` process group is initialized
with one rank per mesh position, that group.  A mesh with no group runs
its shards stacked in one process (`core.collectives.StackedShards`):
the one-card emulation of a mesh larger than the machine.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any

import numpy as np
import torch

# Axis names the repo's sharded programs bind (core/distributed.py):
# misspelling one of these is the typo class the validator catches; any
# OTHER novel name is legal, just unknown.
KNOWN_AXES = ("pod", "data", "model", "shard")


def validate_mesh_request(shape: tuple[int, ...], axes: tuple[str, ...],
                          num_devices: int | None = None) -> None:
    """Raise ValueError (with the fix spelled out) on a bad mesh request.

    `num_devices=None` checks shape/axes consistency only: meshes larger
    than the machine are legal (their shards run stacked), so device-count
    checks stay opt-in.
    """
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh shape {tuple(shape)} has {len(shape)} dims but "
            f"{len(axes)} axis names {tuple(axes)} — one name per dim")
    for dim, name in zip(shape, axes):
        if int(dim) < 1:
            raise ValueError(
                f"mesh axis {name!r} has non-positive size {dim}; every "
                "axis needs at least one device")
    dupes = {a for a in axes if list(axes).count(a) > 1}
    if dupes:
        raise ValueError(
            f"duplicate mesh axis name(s) {sorted(dupes)} in {tuple(axes)}"
            " — collectives bind by name, so names must be unique")
    for name in axes:
        if name not in KNOWN_AXES:
            close = difflib.get_close_matches(name, KNOWN_AXES, n=1)
            hint = f" — did you mean {close[0]!r}?" if close else ""
            raise ValueError(
                f"unknown mesh axis name {name!r}{hint} (known axes: "
                f"{KNOWN_AXES}; a shard_map program binding the intended "
                "axis would fail to find it at lowering time)")
    if num_devices is not None:
        total = 1
        for dim in shape:
            total *= int(dim)
        if num_devices % total != 0:
            raise ValueError(
                f"mesh shape {tuple(shape)} needs {total} devices but "
                f"{num_devices} are available — {num_devices} is not "
                f"divisible by {total}; shrink an axis (e.g. shard over "
                f"{num_devices} or a divisor) or free devices")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device grid: `devices` has the mesh's shape and holds the
    `torch.device` of each position; `group` is the process group with one
    rank per position, or None (the positions run stacked in this
    process)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _default_group(size: int):
    """The initialized default process group, when it has one rank per
    mesh position; else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == size:
        return dist.group.WORLD
    return None


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              check_devices: bool = False) -> Mesh:
    """Validated mesh construction; `check_devices=True` additionally
    checks the request against `torch.cuda.device_count()`.  Positions
    map onto the cards round-robin (all onto the CPU without one); the
    default process group is attached when one is initialized with one
    rank per position."""
    n_cards = torch.cuda.device_count()
    validate_mesh_request(shape, axes,
                          num_devices=n_cards if check_devices else None)
    size = int(np.prod(shape)) if len(shape) else 1
    devs = [torch.device("cuda", i % n_cards) if n_cards
            else torch.device("cpu") for i in range(size)]
    grid = np.empty(size, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(tuple(int(d) for d in shape)), tuple(axes),
                _default_group(size))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
