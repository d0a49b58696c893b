"""``ipx_torch.solve`` in a closed loop: one caller, one fresh LP of the
configuration's shape a call, made on the host in float64
(``gen_host.instance``) and handed over as numpy arrays, as a single-LP
user calls it, with the configuration's options and ``solve``'s default
presolve.  In the traced run the program's own spans are recorded around
each call (``program_spans``)."""
from __future__ import annotations

from lpbench import gen_host, program_spans
from lpbench.harness import WARM_UP_CALL


def inputs(cfg: dict, mix: dict, seed: int, call: int, device) -> dict:
    if mix["lps_per_call"] != 1:
        raise ValueError("solve takes one LP a call")
    return gen_host.batch_of_one(cfg, seed, call)


def call(program, inp: dict, opts, device) -> list:
    c, A, b = (inp[k][0].numpy() for k in ("c", "A", "b"))
    with program_spans.recording(program):
        return [program.solve(c, A, b, options=opts, device=device)]


def warm_up(program, cfg: dict, mix: dict, opts, device, seed: int) -> None:
    program_spans.SUMMARIES.clear()
    call(program, inputs(cfg, mix, seed, WARM_UP_CALL, device), opts, device)
