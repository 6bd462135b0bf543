"""The generic-cell U(1) abelian engine's training path: the port's implicit
gradient and its training entry point on the CPU.

The state, chi and the context are those of tests/test_torch_abelian_generic.py
(a random U(1) 2-site bipartite state, chi=9; the loss's context from 30
dynamic sweeps stopping at conv_tol 1e-10), in a file of its own so that the
two files run side by side.  Tolerances: the frozen sweep's elementwise fixed
point, dist2 <= conv_tol^2; the implicit gradient against central
differences, 1e-6 relative (see the test for the readings); the training
entry point's losses finite and not rising.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_abelian_generic import (J2, bipartite_sites, fix_svd_signs_last_tied,  # noqa: F401
                                        max_block_diff, one_thread, states, train)
from tpeps.ipeps.ipeps_abelian import IPEPS_ABELIAN as J_IPEPS_ABELIAN
from tpeps.sym import io as j_io
from tpeps_torch.ctm.generic_abelian import frozen
from tpeps_torch.ipeps.ipeps_abelian import bipartite
from tpeps_torch.sym import io as t_io


def test_frozen_sweep_reaches_elementwise_fixed_point(train):
    """From the converged dynamic context the frozen sweep reaches an
    elementwise fixed point (dist2 below conv_tol^2, R = 1; measured 5.7e-21
    after 11 sweeps), and a second run builds no plan."""
    from tpeps_torch.sym.tensor import plan_cache_stats

    st, ctx, keeps = train[:3]
    _, n, d2 = frozen.run_frozen_generic(st, ctx, keeps, max_iter=30, conv_tol=1e-10)
    misses = plan_cache_stats()["misses"]
    _, n2, _ = frozen.run_frozen_generic(st, ctx, keeps, max_iter=30, conv_tol=1e-10)
    assert n == n2 < 30 and d2 <= 1e-20 and plan_cache_stats()["misses"] == misses


@pytest.fixture(scope="module")
def implicit_grad(train):
    """The loss's implicit gradient at the context's sites, and its stats."""
    _, _, _, p0, loss_fn, stats, ctx = train
    p = {c: v.clone().requires_grad_() for c, v in p0.items()}
    loss = loss_fn(p, ctx)
    return float(loss.detach()), torch.autograd.grad(loss, list(p.values())), stats[-1]


def test_gradient_matches_central_differences(train, implicit_grad):
    """The implicit gradient of ``optimize_generic_abelian``'s loss against
    central differences of the same loss (h = 1e-5) along three random
    directions: the error relative to each difference, at most 1e-6 where the
    directional derivative is at least 1e-3 of |g| |v| and, where it is
    smaller (the difference's own rounding, ~5e-9 absolute, then dominates),
    at most 1e-6 |g| |v|.  Measured: 1.4e-8 and 2.6e-8 relative on the two
    large directional derivatives (0.06), 4e-9 absolute on the small one
    (7.7e-4, |g| |v| 0.3)."""
    _, _, _, p0, loss_fn, _, ctx = train
    _, g, st = implicit_grad
    assert st["adjoint_iters"] > 0 and not st["adjoint_diverged"] and st["forward_sweeps"] < 30
    gen = torch.Generator().manual_seed(1)
    h = 1e-5
    gnorm = float(torch.sqrt(sum((x ** 2).sum() for x in g)))
    for _ in range(3):
        v = {c: torch.randn(x.shape, generator=gen, dtype=torch.float64) for c, x in p0.items()}
        with torch.no_grad():
            fd = (float(loss_fn({c: p0[c] + h * v[c] for c in p0}, ctx))
                  - float(loss_fn({c: p0[c] - h * v[c] for c in p0}, ctx))) / (2 * h)
        gv = sum(float(gi @ v[c]) for gi, c in zip(g, p0))
        scale = gnorm * float(torch.sqrt(sum((x ** 2).sum() for x in v.values())))
        ref = abs(fd) if abs(fd) >= 1e-3 * scale else scale
        assert abs(gv - fd) <= 1e-6 * ref, (gv, fd, scale)


def test_pivot_rule_does_not_reach_gradient(train, implicit_grad):
    """The sign fixing's choice among tied pivots sets the environment's
    gauge (the last of the tied entries instead of the first changes one
    frozen move's C by 0.70 here) but not the loss or its implicit gradient:
    1e-12 and 1e-8 relative (read 0 and 0, sign flips being exact)."""
    from tpeps_torch.sym import frozen as s_frozen

    st, env, keeps, p0, loss_fn, stats, ctx = train
    e0, g0, _ = implicit_grad
    a = frozen.ctm_move_frozen((0, -1), st, env, keeps)
    p = {c: v.clone().requires_grad_() for c, v in p0.items()}
    with mock.patch.object(s_frozen, "fix_svd_signs", fix_svd_signs_last_tied):
        b = frozen.ctm_move_frozen((0, -1), st, env, keeps)
        loss = loss_fn(p, ctx)
        g = torch.autograd.grad(loss, list(p.values()))
    assert max(float((a.C[k].data - b.C[k].data).abs().max()) for k in a.C) > 0.1
    assert stats[-1]["adjoint_iters"] > 0 and not stats[-1]["adjoint_diverged"]
    g0, g = torch.cat([x.reshape(-1) for x in g0]), torch.cat([x.reshape(-1) for x in g])
    assert abs(float(loss.detach()) - e0) <= 1e-12
    assert float((g - g0).norm()) <= 1e-8 * float(g0.norm()), float((g - g0).norm() / g0.norm())


def test_optim_entry_point_two_epochs(tmp_path):
    """Two L-BFGS epochs of the training entry point on the CPU (backtracking
    line search, 4 sweeps per context and frozen fixed point) on the D=2
    state of the same construction (aux {0:1, 1:1}, chi=4; four gradients of
    ~27 adjoint iterations make D=3 cost 85 s here): the losses finite and not
    rising, every gradient's adjoint converged, the best state written and
    read back by both packages."""
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1 import main

    jst = J_IPEPS_ABELIAN("U1", bipartite_sites(0, {0: 1, 1: 1}), vertexToSite=bipartite, lX=2,
                          lY=1)
    path = str(tmp_path / "state.json")
    j_io.write_ipeps_abelian(jst, path)
    stats = []
    e, history = main(["--instate", path, "--chi", "4", "--j2", str(J2), "--opt_max_iter",
                       "2", "--OPTARGS_line_search", "backtracking", "--CTMARGS_ctm_max_iter",
                       "4", "--instate_noise", "0.05", "--seed", "7", "--out_prefix",
                       str(tmp_path / "run"), "--GLOBALARGS_device", "cpu"], grad_stats=stats)
    losses = history["loss"]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] <= losses[0], losses
    assert np.isfinite(e) and stats and all(not s["adjoint_diverged"] for s in stats)
    out = str(tmp_path / "run_state.json")
    jb, tb = j_io.read_ipeps_abelian(out), t_io.read_ipeps_abelian(out)
    for c in jb.sites:
        assert max_block_diff(jb.sites[c], tb.sites[c]) == 0.0
