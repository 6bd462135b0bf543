"""Framework error types, as tpeps/errors.py has them (reference ctm/generic/env.py:10,
yastn fixed_pt NoFixedPointError).

Raised by host-driven convergence loops / loss closures and caught by
the optimization driver's recovery logic
(reference optim/ad_optim_lbfgs_mod.py:306-327).
"""

from __future__ import annotations


class NoFixedPointError(RuntimeError):
    """CTMRG failed to reach a fixed point (non-convergence or a
    non-finite environment).  The driver recovers by perturbing the
    state with noise and rebuilding the optimizer."""

    def __init__(self, message="CTMRG did not converge", **data):
        super().__init__(message)
        self.message = message
        self.data = data


class EnvError(RuntimeError):
    """The energy is more sensitive to the environment approximation
    than the optimizer's progress scale (reference env.py:10,
    opt_args.env_sens_scale) — the driver may regauge and rebuild."""

    def __init__(self, message="environment sensitivity above threshold", **data):
        super().__init__(message)
        self.message = message
        self.data = data
