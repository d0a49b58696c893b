"""What the probes that measure any checkout (``kernel_times.py``,
``assembly_error.py``) take from this tree rather than from the checkout
measured: the timer, so that two checkouts are timed by the same code, the
reference of rows 5's and 7's start tiles in ``chip_smoke.py``, and row 9's
panel launches and row 10's accumulation and row-panel launches for a kernel
module that predates ``_right_panel``, ``_lt_accumulate`` and
``_lt_row_panel``.  Import it after
the checkout's root is first on ``sys.path``."""
import importlib.util
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


devinfo = _load("_devinfo_of_this_tree", HERE / "ipx_torch" / "devinfo.py")


def chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, over the checkout's
    ``ipx_torch`` (its module-level imports find the one already loaded)."""
    return _load("_chip_smoke_of_this_tree", HERE / "chip_smoke.py")


def right_panel(pk):
    """``pk._right_panel`` (panel k's TRSM and trailing update of
    ``cholesky_batched``, in place), or for a kernel module without it the
    same two launches through its C entry points, raising if one fails."""
    fn = getattr(pk, "_right_panel", None)
    if fn is not None:
        return fn
    trsm = pk._entry("cholesky_right", "ipx_right_trsm",
                     [pk._P, pk._P, pk._I, pk._I, pk._I, pk._P])
    update = pk._entry("cholesky_right", "ipx_right_update",
                       [pk._P, pk._I, pk._I, pk._I, pk._P])

    def panel(T, W, k):
        B, m = T.shape[0], T.shape[1]
        st = torch.cuda.current_stream().cuda_stream
        if trsm(T.data_ptr(), W.data_ptr(), B, m, k, st) != 0 \
                or update(T.data_ptr(), B, m, k, st) != 0:
            raise RuntimeError(f"cholesky_right: launch failed at k={k}")

    return panel


def lt_steps(pk):
    """``(pk._lt_accumulate, pk._lt_row_panel)`` (panel k's accumulation and
    row panel of ``factor_lt_batched``, one launch each), or for a kernel
    module without them the same launches through its C entry points,
    raising if one fails."""
    if hasattr(pk, "_lt_accumulate"):
        return pk._lt_accumulate, pk._lt_row_panel
    args = [pk._P, pk._P, pk._P, pk._I, pk._I, pk._I, pk._P]
    accum = pk._entry("factor_panels", "ipx_accum_panel_lt", args)
    rows = pk._entry("factor_panels", "ipx_lt_rows", args)

    def accumulate(M, LT, C, k):
        if accum(M.data_ptr(), LT.data_ptr(), C.data_ptr(), M.shape[0],
                 M.shape[1], k, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"ipx_accum_panel_lt: launch failed at k={k}")

    def row_panel(W, C, LT, k):
        if rows(W.data_ptr(), C.data_ptr(), LT.data_ptr(), LT.shape[0],
                LT.shape[1], k, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"ipx_lt_rows: launch failed at k={k}")

    return accumulate, row_panel
