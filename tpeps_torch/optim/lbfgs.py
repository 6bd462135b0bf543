"""Modified L-BFGS with two-closure line search (a copy of
tpeps/optim/lbfgs.py: host-side numpy, no torch).

Counterpart of reference optim/lbfgs_modified.py:84-407 (``LBFGS_MOD``
with ``step_2c``): the optimizer consumes

* an AD closure returning ``(loss, grad)`` — heavy (differentiated
  CTMRG), and
* an optional derivative-free line-search closure returning only the
  loss — cheap (no-grad CTMRG, possibly with a cheaper SVD method;
  reference OPTARGS_line_search_svd_method).

The optimizer itself is host-side numpy on flat float64 vectors — line
search is inherently sequential and the heavy lifting (loss/grad) runs
on the device.  Complex parameters are handled by the caller (split into
real/imag parts; see :mod:`tpeps_torch.optim.driver`).

Line searches: strong Wolfe (cubic interpolation/zoom, the standard
algorithm also used by torch's ``_strong_wolfe``) and Armijo
backtracking (reference lbfgs_modified.py:13-82).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Cubic-interpolation minimizer of a 1-D function on [x1, x2]."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1**2 - g1 * g2
    if d2_square >= 0:
        d2 = np.sqrt(d2_square)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def strong_wolfe(
    fdf, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, tolerance_change=1e-9, max_ls=25
):
    """Strong-Wolfe line search.

    :param fdf: callable ``(x, t, d) -> (f, g)`` evaluating loss and
        directional data at ``x + t*d``
    :return: ``(f_new, g_new, t, n_evals)``
    """
    d_norm = np.abs(d).max()
    g = g.copy()
    f_new, g_new = fdf(x, t, d)
    ls_func_evals = 1
    gtd_new = float(np.dot(g_new, d))

    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.copy()]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket = [t]
            bracket_f = [f_new]
            bracket_g = [g_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.copy()]
            bracket_gtd = [gtd_prev, gtd_new]
            break

        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(
            t_prev, f_prev, gtd_prev, t, f_new, gtd_new, bounds=(min_step, max_step)
        )
        t_prev = tmp
        f_prev = f_new
        g_prev = g_new.copy()
        gtd_prev = gtd_new
        f_new, g_new = fdf(x, t, d)
        ls_func_evals += 1
        gtd_new = float(np.dot(g_new, d))
        ls_iter += 1

    if ls_iter == max_ls:
        bracket = [0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]
        bracket_gtd = [gtd, gtd_new]

    # zoom phase
    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(
            bracket[0], bracket_f[0], bracket_gtd[0],
            bracket[1], bracket_f[1], bracket_gtd[1],
        )
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                t = max(bracket) - eps if abs(t - max(bracket)) < abs(t - min(bracket)) else min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False

        f_new, g_new = fdf(x, t, d)
        ls_func_evals += 1
        gtd_new = float(np.dot(g_new, d))
        ls_iter += 1

        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new.copy()
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.copy()
            bracket_gtd[low_pos] = gtd_new

    t = bracket[low_pos] if len(bracket) > 1 else bracket[0]
    f_new = bracket_f[low_pos] if len(bracket_f) > 1 else bracket_f[0]
    g_new = bracket_g[low_pos] if len(bracket_g) > 1 else bracket_g[0]
    return f_new, g_new, t, ls_func_evals


def backtracking(f_at, t, d, f, gtd, c1=1e-4, tau=0.5, max_ls=25):
    """Armijo backtracking on a derivative-free closure
    (reference lbfgs_modified.py:13-82, scipy's ``_scalar_search_armijo``).

    :param f_at: callable ``t -> loss`` at ``x + t*d``
    :return: ``(f_new, t, n_evals)`` (t=0 with original f on failure)
    """
    n_evals = 0
    while n_evals < max_ls:
        f_new = f_at(t)
        n_evals += 1
        if f_new <= f + c1 * t * gtd:
            return f_new, t, n_evals
        t = tau * t
    return f, 0.0, n_evals


class LBFGS:
    """L-BFGS with history, tolerances and two-closure stepping matching
    reference optim/lbfgs_modified.py:84-334 semantics."""

    def __init__(
        self,
        n_params: int,
        lr: float = 1.0,
        max_iter: int = 1,
        history_size: int = 100,
        tolerance_grad: float = 1e-5,
        tolerance_change: float = 1e-9,
        line_search_fn: str | None = "strong_wolfe",
    ):
        self.lr = lr
        self.max_iter = max_iter
        self.history_size = history_size
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.line_search_fn = line_search_fn
        self.old_dirs: deque = deque(maxlen=history_size)
        self.old_stps: deque = deque(maxlen=history_size)
        self.ro: deque = deque(maxlen=history_size)
        self.H_diag = 1.0
        self.prev_flat_grad = None
        self.n_iter = 0
        self.t = lr

    def state_dict(self):
        return {
            "old_dirs": list(self.old_dirs),
            "old_stps": list(self.old_stps),
            "ro": list(self.ro),
            "H_diag": self.H_diag,
            "prev_flat_grad": self.prev_flat_grad,
            "n_iter": self.n_iter,
        }

    def load_state_dict(self, sd, history_size=None):
        hs = history_size or self.history_size
        self.old_dirs = deque(sd["old_dirs"], maxlen=hs)
        self.old_stps = deque(sd["old_stps"], maxlen=hs)
        self.ro = deque(sd["ro"], maxlen=hs)
        self.H_diag = sd["H_diag"]
        self.prev_flat_grad = sd["prev_flat_grad"]
        self.n_iter = sd["n_iter"]

    def _direction(self, flat_grad):
        """Two-loop recursion for d = -H grad."""
        if self.n_iter == 1 or not self.old_dirs:
            return -flat_grad
        num_old = len(self.old_dirs)
        al = np.zeros(num_old)
        q = -flat_grad.copy()
        for i in range(num_old - 1, -1, -1):
            al[i] = float(np.dot(self.old_stps[i], q)) * self.ro[i]
            q -= al[i] * self.old_dirs[i]
        d = q * self.H_diag
        for i in range(num_old):
            be_i = float(np.dot(self.old_dirs[i], d)) * self.ro[i]
            d += (al[i] - be_i) * self.old_stps[i]
        return d

    def step_2c(self, x0: np.ndarray, closure, closure_linesearch=None):
        """One optimization epoch (up to ``max_iter`` L-BFGS iterations).

        :param x0: current flat parameters
        :param closure: ``x -> (loss, grad)`` with AD
        :param closure_linesearch: optional ``x -> loss`` without AD for
            the backtracking line search (reference step_2c two-closure
            structure, lbfgs_modified.py:154-334)
        :return: ``(x, loss, grad, info)``
        """
        x = np.asarray(x0, dtype=np.float64).copy()
        loss, flat_grad = closure(x)
        info = {"ls_evals": [], "alpha": []}
        if np.abs(flat_grad).max() <= self.tolerance_grad:
            return x, loss, flat_grad, info

        for _ in range(self.max_iter):
            self.n_iter += 1
            d = self._direction(flat_grad)
            gtd = float(np.dot(flat_grad, d))
            if gtd > -self.tolerance_change:
                break

            t = self.lr if self.n_iter > 1 else min(1.0, 1.0 / np.abs(flat_grad).sum()) * self.lr

            if self.line_search_fn == "strong_wolfe":
                def fdf(x_, t_, d_):
                    return closure(x_ + t_ * d_)
                f_new, g_new, t, n_evals = strong_wolfe(
                    fdf, x, t, d, loss, flat_grad, gtd,
                    tolerance_change=self.tolerance_change,
                )
                x = x + t * d
                prev_grad = flat_grad
                loss, flat_grad = f_new, np.asarray(g_new)
            elif self.line_search_fn == "backtracking":
                assert closure_linesearch is not None, "backtracking requires a line-search closure"
                f_new, t, n_evals = backtracking(
                    lambda t_: closure_linesearch(x + t_ * d), t, d, loss, gtd
                )
                if t == 0.0:
                    info["ls_failed"] = True
                    break
                x = x + t * d
                prev_grad = flat_grad
                loss, flat_grad = closure(x)
                n_evals += 1
            else:
                x = x + t * d
                prev_grad = flat_grad
                loss, flat_grad = closure(x)
                n_evals = 1

            info["ls_evals"].append(n_evals)
            info["alpha"].append(t)

            # curvature update for the next iteration
            y = flat_grad - prev_grad
            s = t * d
            ys = float(np.dot(y, s))
            if ys > 1e-10:
                self.old_dirs.append(y)
                self.old_stps.append(s)
                self.ro.append(1.0 / ys)
                self.H_diag = ys / float(np.dot(y, y))

            if np.abs(flat_grad).max() <= self.tolerance_grad:
                break
            if np.abs(t * d).max() <= self.tolerance_change:
                break

        self.prev_flat_grad = flat_grad
        return x, loss, flat_grad, info
