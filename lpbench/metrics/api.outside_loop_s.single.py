"""A call's wall time less the synchronised time inside
``ipx_torch.ipm.batched.run_batch``: the host re-check, the gathers of the
rescue ladder and the rest of ``api``, seconds a call."""
from lpbench.metrics._read import outside_loop_s as read  # noqa: F401
