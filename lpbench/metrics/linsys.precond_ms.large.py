"""Synchronised wall time of one call of
``ipx_torch.linsys.schur._precond`` (the Schur preconditioner's two sweeps
of W-substitutions), ms on average."""


def read(records: dict):
    span = (records.get("spans") or {}).get("linsys.precond")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["seconds"] / span["calls"]
