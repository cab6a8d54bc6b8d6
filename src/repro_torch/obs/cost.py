"""Per-plan cost profiles: the geometry a serve call runs at, the kernel
launches it makes, and on the card its device time.

A trace says where a query's milliseconds went on the host; a cost profile
says what one call of the program underneath did on the device: the lanes
× cap geometry the engine chose, how many times each hand-written kernel
launched (``kernels.ops.LAUNCHES`` read around the call) and, on a CUDA
store, the device milliseconds between CUDA events recorded around the
call while a sleep kernel holds the stream, so the events bracket device
work and not the host's launch gaps.

Profiles are plain JSON-ready dicts.  A field that cannot be had (device
time on the CPU, a call that synchronised while the stream was held)
is an ``*_error`` string instead: profiling never takes serving down.
"""

from __future__ import annotations

import time

import torch

__all__ = ["profile_call"]

# sleep-kernel cycles per host second of the call it holds the stream for
# (about twice the H100's clock, so the hold outlasts the enqueue)
_SLEEP_CYCLES_PER_S = 4e9


def profile_call(call, geometry: dict, device: torch.device) -> dict:
    """Profile one ``call()`` on ``device``.

    ``call`` must not synchronise with the device (``Plan.submit``-style
    dispatch): its launches are enqueued behind a sleep kernel.  It runs
    twice: once to warm up and size the sleep, once measured.  Launch
    counts are read around the measured call only; they count every
    launch in the process meanwhile.
    """
    from repro_torch.kernels import ops

    out: dict = {"geometry": dict(geometry)}
    if device.type != "cuda":
        before = dict(ops.LAUNCHES)
        call()
        out["launches"] = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        out["device_ms_error"] = "no CUDA events on the cpu"
        return out
    with torch.cuda.device(device):
        call()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        call()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = dict(ops.LAUNCHES)
        torch.cuda._sleep(int(_SLEEP_CYCLES_PER_S * max(host_s, 1e-4)))
        start.record()
        call()
        end.record()
        held = not start.query()
        torch.cuda.synchronize(device)
        out["launches"] = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        if held:
            out["device_ms"] = start.elapsed_time(end)
        else:
            out["device_ms_error"] = (
                "the sleep kernel ended before the call was enqueued; "
                "the events would include host gaps"
            )
    return out
