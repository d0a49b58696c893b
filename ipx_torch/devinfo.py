"""What the measuring scripts share: the card's name and power limit, and a
CUDA-event timer."""
from __future__ import annotations

import subprocess

import torch


def nvidia_smi_line() -> str:
    """First line of ``nvidia-smi --query-gpu=name,power.limit``: every
    number taken on a card is reported beside it (a card set below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warm: int = 2, queued: bool = False,
            setup=None) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls after ``warm``
    warm-up calls, between two CUDA events on the current stream.  With
    ``queued`` the device first spins for about 25 ms, so the calls are all
    enqueued before the first runs: the time is then the kernels' back to
    back, not the host's time to launch them (which is what a kernel of a
    few tens of microseconds would otherwise show).  With ``setup`` each
    call is preceded by ``setup()`` (for ``fn`` that works in place, a fresh
    copy of its input), outside the timed spans: a pair of events a call."""
    if setup is not None:
        spans = []
        for i in range(warm + reps):
            setup()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            if i >= warm:
                spans.append((t0, t1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / reps
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
