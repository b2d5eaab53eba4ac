"""Measurements that `chip_smoke.py`, the scripts in `tools_torch/` and the
card's tests share: device time per call as torch.profiler (CUPTI) records
it, time per call with the host's work (CUDA events), and the relative L2
error that holds a bf16 kernel against its plain version.  Nothing here
runs when the module is imported."""
from __future__ import annotations


def device_us_by_name(prof, averages=None) -> dict[str, float]:
    """Device microseconds per kernel (or copy) name in a torch.profiler
    trace (or in its `key_averages()`, when the caller has them: they
    take seconds to build from a long trace).  Device-side events only: a
    CPU op's self device time repeats its kernels', and "Command Buffer
    Full" is a launch-queue stall, not device work."""
    from torch.autograd import DeviceType
    per_name: dict[str, float] = {}
    for e in (prof.key_averages() if averages is None else averages):
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith("Command Buffer Full"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            per_name[e.key] = per_name.get(e.key, 0.0) + dev_us
    return per_name


# profiler sessions `device_ms` reads before it gives up on one with
# device time
PROFILER_SESSIONS = 3
# sessions `device_ms` read and found empty in this process, by the name
# of the timed function: a report prints them, so a flaky yardstick shows
EMPTY_SESSIONS: dict[str, int] = {}


def device_ms(fn, iters: int = 40, warmup: int = 3) -> float:
    """Mean device milliseconds per call of `fn`: the summed durations of
    every kernel and copy it ran, as torch.profiler (CUPTI) records them.
    The host work of a call (argument checks, allocation, the launch)
    does not count, so a kernel shorter than its launch is timed right.
    The warm-up calls run under a profiler session of their own, which is
    discarded, so the session that is read is never the process's first.
    CUPTI now and then hands back a session with no device time on an
    H100, late in a long process: up to PROFILER_SESSIONS sessions are
    read, each empty one is counted in EMPTY_SESSIONS, and RuntimeError
    is raised when none holds device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(device_us_by_name(prof).values())
        if total_us > 0:
            return total_us / iters / 1e3
        name = getattr(fn, "__qualname__", repr(fn))
        EMPTY_SESSIONS[name] = EMPTY_SESSIONS.get(name, 0) + 1
    raise RuntimeError(
        f"the profiler recorded no device time in {PROFILER_SESSIONS} "
        f"sessions ({len(prof.key_averages())} event names, {iters} calls "
        f"of {getattr(fn, '__name__', fn)})")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls back to back,
    CUDA events around them: the host's work of a call counts wherever it
    is longer than the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(got, want) -> tuple[float, float]:
    """Relative L2 error of `got` against `want` over the whole tensor, and
    the largest over its last-axis rows (an attention output's (position,
    head) rows)."""
    g, w = got.float(), want.float()
    rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30)
    return float((g - w).norm() / w.norm()), float(rows.max())
