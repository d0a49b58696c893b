"""``ipx_torch.solve_large`` in a closed loop: one caller, one fresh LP of
the configuration's shape a call, p = 1."""
from __future__ import annotations

from lpbench import gen
from lpbench.harness import WARM_UP_CALL


def _lp(m: int, n: int, a_dtype: str, seed: int, call: int, device) -> dict:
    return gen.large(m, n, gen.generator(seed, call, device), a_dtype, device)


def inputs(cfg: dict, mix: dict, seed: int, call: int, device) -> dict:
    if mix["lps_per_call"] != 1:
        raise ValueError("solve_large takes one LP a call")
    return _lp(cfg["m"], cfg["n"], cfg["a_dtype"], seed, call, device)


def call(program, inp: dict, opts, device) -> list:
    return [program.solve_large(inp["c"][0], inp["A"][0], inp["b"][0],
                                options=opts, device=device)]


def warm_up(program, cfg: dict, mix: dict, opts, device, seed: int) -> None:
    w = mix["warmup"]
    call(program, _lp(w["m"], w["n"], cfg["a_dtype"], seed, WARM_UP_CALL,
                      device), opts, device)
