"""Arnoldi / Lanczos partial eigensolvers on a matvec of torch ops
(counterpart of tpeps/linalg/arnoldi.py).

The m Krylov steps are a host loop of torch operations on the start
vector's device: each step is one matvec and a modified Gram-Schmidt sweep
in the JAX package's order (the vectors 0..j, one dot and one update each).
Nothing in the loop reads a value to the host: the Hessenberg matrix ``H``
stays on the device and is copied once at the end, and only its m x m
eigenproblem is solved on the host with numpy, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_start(size: int, like, seed: int = 1234):
    """A start vector uniform in [-0.5, 0.5) from ``np.random.RandomState(seed)``
    on ``like``'s device and dtype: a structured start can be orthogonal to
    symmetry-odd eigenvectors and skip levels."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.rand(size) - 0.5, device=like.device).to(like.dtype)


def _arnoldi_factorization(matvec, v0, m: int):
    """m-step Arnoldi: returns ``(V[m+1, n], H[m+1, m])`` on ``v0``'s device."""
    n = v0.shape[0]
    V = torch.zeros((m + 1, n), dtype=v0.dtype, device=v0.device)
    H = torch.zeros((m + 1, m), dtype=v0.dtype, device=v0.device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    for j in range(m):
        w = matvec(V[j])
        # modified Gram-Schmidt against the vectors so far, in order
        for i in range(j + 1):
            h = torch.vdot(V[i], w)
            w = w - h * V[i]
            H[i, j] = h
        beta = torch.linalg.vector_norm(w)
        H[j + 1, j] = beta.to(H.dtype)
        V[j + 1] = torch.where(beta > 1e-300, w / beta, w)
    return V, H


def _krylov(matvec, v0, k: int, m: int | None):
    m = m or max(2 * k + 10, 30)
    m = min(m, v0.shape[0])
    V, H = _arnoldi_factorization(matvec, v0, m)
    return V, H[:m, :m].cpu().numpy(), m


@torch.no_grad()
def arnoldi_eigs(matvec, v0, k: int, m: int | None = None):
    """Leading-``|lambda|`` eigenvalues (possibly complex) of a linear map.

    :param matvec: ``v -> A v`` on 1-D tensors
    :param v0: start vector (its device runs the Krylov loop)
    :param k: number of eigenvalues
    :param m: Krylov dimension (default ``max(2k+10, 30)``)
    :return: numpy complex eigenvalues sorted by descending magnitude, (k,)
    """
    _, Hm, _ = _krylov(matvec, v0, k, m)
    w = np.linalg.eigvals(Hm)
    order = np.argsort(-np.abs(w))
    return w[order][:k]


@torch.no_grad()
def arnoldi_eigs_vecs(matvec, v0, k: int, m: int | None = None):
    """Leading eigenpairs: like :func:`arnoldi_eigs`, with the Ritz vectors
    (columns, unit 2-norm) for the fixed-point corner method.

    :return: ``(w[k], X[n, k])`` numpy complex, sorted by descending |w|
    """
    V, Hm, m = _krylov(matvec, v0, k, m)
    w, Y = np.linalg.eig(Hm)
    order = np.argsort(-np.abs(w))
    w, Y = w[order][:k], Y[:, order][:, :k]
    X = V[:m].cpu().numpy().T @ Y
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    return w, X


@torch.no_grad()
def lanczos_eigsh(matvec, v0, k: int, m: int | None = None):
    """Leading eigenvalues of a hermitian map through the same factorization."""
    _, Hm, _ = _krylov(matvec, v0, k, m)
    Hm = 0.5 * (Hm + Hm.conj().T)
    w = np.linalg.eigvalsh(Hm)
    order = np.argsort(-np.abs(w))
    return w[order][:k]
