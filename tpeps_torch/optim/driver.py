"""Optimization driver (counterpart of tpeps/optim/driver.py, reference
optim/ad_optim_lbfgs_mod.py:132-357).

``optimize_state`` runs the epoch loop:

* per epoch: checkpoint (pickle) -> L-BFGS ``step_2c`` with an autograd
  closure (``torch.autograd.grad`` of the loss, on the parameters' device)
  and an optional no-grad line-search closure,
* best-so-far state handed to ``best_state_writer`` whenever the loss
  improves,
* JSON-line metric logging (loss, grad norms, timings),
* termination on loss/grad/step tolerances,
* recovery from :class:`~tpeps_torch.errors.NoFixedPointError` (noise and a
  fresh optimizer) and :class:`~tpeps_torch.errors.EnvError` (optional
  regauge and a fresh optimizer).

Parameters are a tensor or a dict of tensors on one device; complex
tensors are split into real and imaginary parts, so the host-side L-BFGS
sees one flat float64 numpy vector.
"""

from __future__ import annotations

import json
import logging
import pickle
import time

import numpy as np
import torch

from ..errors import EnvError, NoFixedPointError
from .lbfgs import LBFGS

log = logging.getLogger(__name__)


class _Flat:
    """Map between the parameters (a tensor or a dict of tensors) and a flat
    float64 numpy vector."""

    def __init__(self, params):
        self.is_dict = isinstance(params, dict)
        self.keys = list(params) if self.is_dict else [None]
        self.protos = list(params.values()) if self.is_dict else [params]
        self.sizes = [p.numel() * (2 if p.is_complex() else 1) for p in self.protos]

    def leaves(self, params):
        return list(params.values()) if self.is_dict else [params]

    def ravel(self, tensors) -> np.ndarray:
        parts = [(torch.view_as_real(t) if t.is_complex() else t).detach().reshape(-1)
                 for t in tensors]
        return torch.cat(parts).to(torch.float64).cpu().numpy()

    def unravel(self, x: np.ndarray, requires_grad: bool = False):
        leaves, off = [], 0
        for p, n in zip(self.protos, self.sizes):
            chunk = torch.tensor(x[off:off + n], dtype=torch.float64, device=p.device)
            off += n
            if p.is_complex():
                t = torch.view_as_complex(chunk.to(p.real.dtype).reshape(*p.shape, 2).contiguous())
            else:
                t = chunk.to(p.dtype).reshape(p.shape)
            leaves.append(t.requires_grad_(requires_grad))
        return dict(zip(self.keys, leaves)) if self.is_dict else leaves[0]


def optimize_state(
    params,
    loss_fn,
    *,
    cfg,
    obs_fn=None,
    post_proc=None,
    loss_fn_linesearch=None,
    loss_ctx_fn=None,
    checkpoint_file=None,
    best_state_writer=None,
    opt_resume=None,
    regauge_fn=None,
    status_ctx=None,
    max_recoveries: int = 3,
):
    """Epoch loop of L-BFGS optimization.

    :param params: a tensor or a dict of tensors (the variational parameters)
    :param loss_fn: differentiable ``params -> loss`` (scalar tensor), or
        ``(params, ctx) -> loss`` when ``loss_ctx_fn`` is given
    :param cfg: :class:`tpeps_torch.config.Config`
    :param loss_fn_linesearch: optional cheaper no-grad ``params -> loss``
    :param loss_ctx_fn: optional ``params -> ctx`` evaluated once per epoch
        outside autograd (e.g. a converged environment to reuse)
    :param best_state_writer: callable ``(params, loss)`` invoked when the
        loss improves (e.g. writes the ``_state.json``)
    :param opt_resume: checkpoint path to resume from
    :param regauge_fn: optional ``params -> params`` applied on
        :class:`~tpeps_torch.errors.EnvError` before rebuilding the optimizer
    :param status_ctx: optional dict the caller's closures may mutate;
        ``status_ctx["STATUS"] == "ENV_ANTIVAR"`` terminates with an error
    :param max_recoveries: give up after this many *consecutive*
        noise-restart/regauge recoveries
    :return: ``(best_params, history)``
    """
    opt_args = cfg.opt
    flat = _Flat(params)
    x0 = flat.ravel(flat.leaves(params))

    def to_params(x):
        return flat.unravel(x)

    t_closure = {"grad": 0.0, "ls": 0.0}
    current_ctx = [None]

    def closure(x):
        t0 = time.perf_counter()
        p = flat.unravel(x, requires_grad=True)
        loss = loss_fn(p) if loss_ctx_fn is None else loss_fn(p, current_ctx[0])
        grads = torch.autograd.grad(loss, flat.leaves(p))
        val = float(loss.detach())
        gflat = flat.ravel(grads)
        t_closure["grad"] += time.perf_counter() - t0
        return val, gflat

    closure_ls = None
    if loss_fn_linesearch is not None:

        def closure_ls(x):
            t0 = time.perf_counter()
            with torch.no_grad():
                val = float(loss_fn_linesearch(to_params(x)))
            t_closure["ls"] += time.perf_counter() - t0
            return val

    line_search = {"default": "strong_wolfe", "strong_wolfe": "strong_wolfe",
                   "backtracking": "backtracking", "none": None}[opt_args.line_search]

    def make_optimizer():
        """Fresh optimizer (also used to clear the L-BFGS history on recovery)."""
        if getattr(opt_args, "opt_type", "LBFGS").upper() == "SGD":
            raise NotImplementedError("opt_type SGD is not ported to tpeps_torch yet")
        return LBFGS(
            n_params=x0.size,
            lr=opt_args.lr,
            max_iter=opt_args.max_iter_per_epoch,
            history_size=opt_args.history_size,
            tolerance_grad=opt_args.tolerance_grad,
            tolerance_change=opt_args.tolerance_change,
            line_search_fn=line_search,
        )

    opt = make_optimizer()

    epoch0 = 0
    if opt_resume:
        with open(opt_resume, "rb") as f:
            ckpt = pickle.load(f)
        x0 = np.asarray(ckpt["x"], dtype=np.float64)
        opt.load_state_dict(ckpt["optimizer"], history_size=opt_args.history_size)
        epoch0 = ckpt["epoch"] + 1
        log.info(f"resumed from {opt_resume} at epoch {epoch0}")

    x = x0
    best_loss = np.inf
    history = {"loss": [], "grad_norm": [], "t_grad": [], "t_ls": [], "alpha": [],
               "recoveries": []}
    prev_loss = None
    n_consec_recoveries = 0
    noise_rng = np.random.RandomState(cfg.main.seed + 7919)

    for epoch in range(epoch0, cfg.main.opt_max_iter):
        if checkpoint_file:
            with open(checkpoint_file, "wb") as f:
                pickle.dump({"epoch": epoch, "x": x, "optimizer": opt.state_dict(),
                             "loss": best_loss}, f)

        t_closure["grad"] = t_closure["ls"] = 0.0
        if loss_ctx_fn is not None:
            with torch.no_grad():
                current_ctx[0] = loss_ctx_fn(to_params(x))
        t0 = time.perf_counter()
        try:
            x, loss, grad, info = opt.step_2c(x, closure, closure_ls)
        except NoFixedPointError as e:
            # recovery: perturb the state with noise, rebuild the optimizer
            # (clears the L-BFGS history) and retry
            n_consec_recoveries += 1
            if n_consec_recoveries > max_recoveries:
                raise
            log.info(f"{e.message} — adding noise 0.1 and restarting optimizer "
                     f"(recovery {n_consec_recoveries}/{max_recoveries})")
            scale = 0.1 * max(float(np.abs(x).max()), 1e-30)
            x = x + scale * (noise_rng.rand(x.size) - 0.5)
            opt = make_optimizer()
            history["recoveries"].append({"epoch": epoch, "kind": "noise"})
            prev_loss = None
            continue
        except EnvError as e:
            n_consec_recoveries += 1
            if n_consec_recoveries > max_recoveries:
                raise
            log.info(f"{e.message} — "
                     + ("regauging and " if regauge_fn else "")
                     + "restarting optimizer")
            if regauge_fn is not None:
                with torch.no_grad():
                    x = flat.ravel(flat.leaves(regauge_fn(to_params(x))))
            opt = make_optimizer()
            history["recoveries"].append({"epoch": epoch, "kind": "regauge"})
            prev_loss = None
            continue
        n_consec_recoveries = 0
        t_epoch = time.perf_counter() - t0

        if status_ctx is not None and status_ctx.get("STATUS") == "ENV_ANTIVAR":
            raise RuntimeError(
                "Over-optimized environment (ENV_ANTIVAR): the loss is more "
                "sensitive to the environment approximation than to the state")

        history["loss"].append(loss)
        history["grad_norm"].append(float(np.linalg.norm(grad)))
        history["t_grad"].append(t_closure["grad"])
        history["t_ls"].append(t_closure["ls"])
        history["alpha"].extend(info.get("alpha", []))

        if opt_args.opt_logging:
            log_entry = {
                "epoch": epoch, "loss": loss,
                "t_epoch": t_epoch, "t_grad": t_closure["grad"], "t_ls": t_closure["ls"],
                "ls_evals": info.get("ls_evals", []), "alpha": info.get("alpha", []),
            }
            if opt_args.opt_log_grad:
                log_entry["grad_l2"] = float(np.linalg.norm(grad))
                log_entry["grad_max"] = float(np.abs(grad).max())
            log.info(json.dumps(log_entry))

        if loss < best_loss:
            best_loss = loss
            if best_state_writer is not None:
                best_state_writer(to_params(x), loss)

        if obs_fn is not None:
            obs_fn(to_params(x), {"epoch": epoch, "loss": loss, "history": history})
        if post_proc is not None:
            new_params = post_proc(to_params(x), {"epoch": epoch, "loss": loss})
            if new_params is not None:
                x = flat.ravel(flat.leaves(new_params))

        gmax = float(np.abs(grad).max())
        if gmax < opt_args.tolerance_grad:
            log.info(f"converged: max|grad| {gmax} < {opt_args.tolerance_grad}")
            break
        if prev_loss is not None and abs(loss - prev_loss) < opt_args.tolerance_change:
            log.info(f"converged: |dloss| < {opt_args.tolerance_change}")
            break
        prev_loss = loss

    return to_params(x), history
