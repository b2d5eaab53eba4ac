"""What the benchmark reads from a torch.profiler trace of the window:
the device's busy time, the device operations that took most time, and
the idle gaps between them, each named by the operation the device waited
for (the host was preparing its launch)."""
from __future__ import annotations

TOP = 10            # entries of each breakdown list
NAME_CHARS = 120    # kernel names are long C++ templates: their head only


def device_events(prof) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of every operation that ran on the card,
    in start order.  "Command Buffer Full" is a launch-queue stall, not
    device work."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("Command Buffer Full"):
            continue
        out.append((e.start_ns(), e.end_ns(), name[:NAME_CHARS]))
    out.sort()
    return out


def summarize(events: list[tuple[int, int, str]]) -> dict:
    """busy_s (the union of the operations' intervals), device_ops (the
    operations that took most device time, by name) and idle_gaps (the
    time between operations, by the operation that ended the gap)."""
    busy_ns = 0
    by_op: dict[str, float] = {}
    by_gap: dict[str, float] = {}
    cur_start = cur_end = None
    for start, end, name in events:
        by_op[name] = by_op.get(name, 0.0) + (end - start) / 1e9
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_ns += cur_end - cur_start
            label = f"before {name}"
            by_gap[label] = by_gap.get(label, 0.0) + (start - cur_end) / 1e9
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_ns += cur_end - cur_start

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"busy_s": busy_ns / 1e9, "device_ops": top(by_op),
            "idle_gaps": top(by_gap), "events": len(events)}
