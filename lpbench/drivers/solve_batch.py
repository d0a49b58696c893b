"""``ipx_torch.solve_batch`` in a closed loop: one caller, a fresh batch of
``lps_per_call`` LPs of the configuration's shape a call."""
from __future__ import annotations

from lpbench import gen
from lpbench.harness import WARM_UP_CALL


def _batch(cfg: dict, lps: int, seed: int, call: int, device) -> dict:
    if lps > cfg["batch"]:
        raise ValueError(f"{lps} LPs a call; the configuration holds at "
                         f"most {cfg['batch']}")
    gen_ = gen.generator(seed, call, device)
    return gen.batch(lps, cfg["m"], cfg["n"], gen_, cfg["a_dtype"], device)


def inputs(cfg: dict, mix: dict, seed: int, call: int, device) -> dict:
    return _batch(cfg, mix["lps_per_call"], seed, call, device)


def call(program, inp: dict, opts, device) -> list:
    lp = program.LP(c=inp["c"], A=inp["A"], b=inp["b"],
                    obj_offset=inp["obj_offset"])
    return program.solve_batch(lp, options=opts, device=device)


def warm_up(program, cfg: dict, mix: dict, opts, device, seed: int) -> None:
    call(program, _batch(cfg, mix["warmup"]["lps"], seed, WARM_UP_CALL,
                         device), opts, device)
