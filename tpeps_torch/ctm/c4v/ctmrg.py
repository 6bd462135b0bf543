"""Reference-layout C4v pieces needed by the RDMs (counterpart of
``_ct_tl`` and ``open_c2x2_sl`` in tpeps/ctm/c4v/ctmrg.py).

These are large fused-dimension matrix products and stay ``torch.matmul``
(cuBLAS on the card).  The reference-layout move, ``run_fixed_point`` and
the implicit adjoint come with later slices of the port.
"""

from __future__ import annotations


def _ct_tl(a, C, T):
    """Shared C-Ttop-Tleft prefix as ``q[(j,m,v,i), (u,l)]`` ready for the
    ket-layer matmul."""
    chi = C.shape[0]
    D = a.shape[1]
    # ct[x, (u,v,i)] = C[x,y] Ttop[y,(u,v,i)]; top T stored [i,y,u,v]
    Tt = T.reshape(chi, chi, D, D).permute(1, 2, 3, 0).reshape(chi, D * D * chi)
    ct = C @ Tt
    # q[(j,l,m),(u,v,i)] = Tl[x,(j,l,m)]^T ct[x,(u,v,i)]
    Tl = T.reshape(chi, chi * D * D)
    q = Tl.transpose(0, 1) @ ct
    q = q.reshape(chi, D, D, D, D, chi)  # j,l,m,u,v,i
    return q.permute(0, 2, 4, 5, 3, 1).reshape(chi * D * D * chi, D * D)


def open_c2x2_sl(a, C, T):
    """Enlarged upper-left corner with open physical indices:
    ``[(down-chi, dk, db), (right-chi, rk, rb), s, s']`` with ``s`` from the
    ket (non-conjugated) layer."""
    chi = C.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    q = _ct_tl(a, C, T)
    a_k = a.permute(1, 2, 0, 3, 4).reshape(D * D, d * D * D)
    q = q @ a_k
    # bra layer keeping both physical indices open: contract (m,v) only
    q = q.reshape(chi, D, D, chi, d, D, D)  # j,m,v,i,s,e,r
    q = q.permute(0, 3, 4, 5, 6, 1, 2).reshape(chi * chi * d * D * D, D * D)
    a_b = a.conj().permute(2, 1, 0, 3, 4).reshape(D * D, d * D * D)
    q = q @ a_b  # [(j,i,s,e,r),(z,f,g)]
    q = q.reshape(chi, chi, d, D, D, d, D, D)  # j,i,s,e,r,z,f,g
    return q.permute(0, 3, 6, 1, 4, 7, 2, 5).reshape(chi * D * D, chi * D * D, d, d)
