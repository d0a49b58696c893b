"""Lane compaction in ``ipx_torch.ipm.batched.run_batch``: once at most half
the lanes stepped still run, the loop steps those alone.

A batch of mixed difficulty (easy lanes, badly scaled ones, one degenerate,
one capped at ``max_iter``), built as ``tests/test_batched.py`` builds its
frozen-lanes batch, runs compacted and lock-step (the shrink rule patched to
never shrink): the same status and iteration count per lane, the iterates
equal to 1e-12 relative in float64, the caller's width and lane order.  The
counters against a model of the rule on the lock-step run's counts; B = 1
never shrinks; ``obs.debug_mode`` names a narrowed lane by the caller's
index.  On a card, the fused route at the widths 1, 3, 17 and 100."""
import dataclasses

import pytest
import torch

import ipx_torch
from ipx_torch import obs
from ipx_torch.ipm import batched, mehrotra
from ipx_torch.problem.generate import random_feasible_lp

torch.set_num_threads(1)

M, N, B = 24, 48, 12
FIELDS = ("x", "y", "s", "best_x", "best_y", "best_s", "best_merit",
          "mu", "rel_gap", "trace")


def _mixed_lp():
    gs = [random_feasible_lp(M, N, seed=40 + i,
                             scale_spread=2.0 if i % 4 == 3 else 0.0,
                             support=M // 2 if i == 10 else None)
          for i in range(B)]
    return batched.stack_lps([ipx_torch.make_lp(g.c, g.A, g.b, device="cpu",
                                                dtype=torch.float64)
                              for g in gs])


def _lock_step(monkeypatch, lp, opts, state0=None):
    with monkeypatch.context() as mp:
        mp.setattr(batched, "_narrows", lambda n_live, width: False)
        return batched.run_batch(lp, opts, state0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (1 + b.abs().max()))


def _shrinks_and_lane_steps(its, width):
    """The rule's counters from each lane's iteration count in a lock-step
    run of ``refactor_period = 1`` where every lane starts RUNNING at 0."""
    shrinks = lane_steps = 0
    for k in range(max(its)):
        live = sum(i > k for i in its)
        if 2 * live <= width:
            shrinks, width = shrinks + 1, live
        lane_steps += width
    return shrinks, lane_steps


# at the cap of 10 lane 7 ends MAX_ITER; refactor_period = 2 takes more
# steps, and its lanes end apart only under a cap of 16
@pytest.mark.parametrize("period,cap", [(1, 10), (2, 16)])
def test_compacted_matches_lock_step(monkeypatch, period, cap):
    lp = _mixed_lp()
    opts = ipx_torch.SolverOptions(dtype="float64", max_iter=cap,
                                   refactor_period=period)
    widths = []         # of each step
    step = mehrotra.mehrotra_step

    def counted(lp, state, *a, **kw):
        widths.append(state.x.shape[0])
        return step(lp, state, *a, **kw)
    with monkeypatch.context() as mp, obs.tracing() as t:
        mp.setattr(mehrotra, "mehrotra_step", counted)
        got = batched.run_batch(lp, opts)
    ref = _lock_step(monkeypatch, lp, opts)
    shrinks = sum(a != b for a, b in zip(widths, widths[1:]))
    assert t.summary()["counters"] == {"ipm.compact.shrinks": shrinks,
                                       "ipm.lane_steps": sum(widths)}
    assert shrinks >= 1 and widths[0] == B
    assert got.x.shape == ref.x.shape == (B, N)
    assert got.status.tolist() == ref.status.tolist()
    assert got.it.tolist() == ref.it.tolist()
    assert len(set(got.it.tolist())) > 2
    for f in FIELDS:
        assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-12, f
    # lane order: each OPTIMAL lane's answer is its own LP's
    done = got.status == int(ipx_torch.Status.OPTIMAL)
    rp = torch.einsum("bmn,bn->bm", lp.A, got.x) - lp.b
    rp_rel = rp.abs().amax(-1) / (1 + lp.b.abs().amax(-1))
    assert int(done.sum()) >= B - 1
    assert float(rp_rel[done].max()) <= opts.tol_feas


def test_counters_on_the_mixed_batch(monkeypatch):
    lp = _mixed_lp()
    opts = ipx_torch.SolverOptions(dtype="float64", max_iter=10)
    with obs.tracing() as t:
        batched.run_batch(lp, opts)
    ref = _lock_step(monkeypatch, lp, opts)
    shrinks, lane_steps = _shrinks_and_lane_steps(ref.it.tolist(), B)
    counters = t.summary()["counters"]
    assert (counters["ipm.compact.shrinks"], counters["ipm.lane_steps"]) \
        == (shrinks, lane_steps)
    assert lane_steps < B * max(ref.it.tolist())


def test_one_lane_never_shrinks():
    g = random_feasible_lp(M, N, seed=3)
    lp = ipx_torch.make_lp(g.c, g.A, g.b, device="cpu", dtype=torch.float64)
    with obs.tracing() as t:
        st = batched.run_batch(batched.stack_lps([lp]),
                               ipx_torch.SolverOptions(dtype="float64"))
    counters = t.summary()["counters"]
    assert counters["ipm.compact.shrinks"] == 0
    assert counters["ipm.lane_steps"] == int(st.it[0]) > 0
    assert "ipm.compact" not in t.summary()["spans"]


def test_debug_mode_names_the_callers_lane():
    """Lanes 0, 1 and 3 enter ended, lane 2 (a zeroed row of A) running: the
    batch narrows to lane 2 before the first step, whose direction is not
    finite; the message names lane 2."""
    gs = [random_feasible_lp(8, 16, seed=i) for i in range(4)]
    lps = [ipx_torch.make_lp(g.c, g.A, g.b, device="cpu") for g in gs]
    A = gs[2].A.copy()
    A[2] = 0.0
    lps[2] = ipx_torch.make_lp(gs[2].c, A, gs[2].b, device="cpu")
    lp = batched.stack_lps(lps)
    opts = ipx_torch.SolverOptions()
    st0, _ = batched.batch_starting_state(lp, opts)
    ended = int(ipx_torch.Status.OPTIMAL)
    st0 = dataclasses.replace(st0, status=torch.tensor(
        [ended, ended, 0, ended], dtype=torch.int32))
    with obs.tracing() as t:
        with pytest.raises(FloatingPointError,
                           match=r"^iteration 0, lane 2: non-finite dx$"):
            with obs.debug_mode():
                batched.run_batch(lp, opts, st0)
    assert t.summary()["spans"]["ipm.compact"]["calls"] == 1


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none (decided in the
    test, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")


@pytest.mark.parametrize("width", [1, 3, 17, 100])
def test_fused_route_at_narrow_widths(card, monkeypatch, width):
    """``throughput(a_storage="bfloat16")`` on the card: a batch of 200
    whose first ``width`` lanes enter running narrows to them before its
    first step, and narrows on as they end; every lane's status and
    iteration count as lock-step, x within 1e-5 relative."""
    from ipx_torch.problem.generate import random_feasible_batch_device
    gen = torch.Generator(device="cuda").manual_seed(7)
    gb = random_feasible_batch_device(200, 256, 512, gen,
                                      a_storage="bfloat16")
    opts = ipx_torch.SolverOptions.throughput(a_storage="bfloat16")
    lp = gb.lp.with_a_storage(opts)
    st0, _ = batched.batch_starting_state(lp, opts)
    status = torch.full_like(st0.status, int(ipx_torch.Status.OPTIMAL))
    status[:width] = 0
    st0 = dataclasses.replace(st0, status=status)
    with obs.tracing() as t:
        got = batched.run_batch(lp, opts, st0)
    ref = _lock_step(monkeypatch, lp, opts, st0)
    assert t.summary()["counters"]["ipm.compact.shrinks"] >= 1
    assert got.status.tolist() == ref.status.tolist()
    assert got.it.tolist() == ref.it.tolist()
    assert _rel(got.x, ref.x) <= 1e-5
