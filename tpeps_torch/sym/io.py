"""JSON (de)serialization of abelian block-sparse iPEPS (the port's own copy
of the abelian-format part of tpeps/sym/io.py): per-site ``blocks``, each
with per-leg ``charges``, ``dims`` and sparse ``entries`` ("i j .. value" or
"i j .. re im").  Files written by either package read back bit-identical
in the other.  The YASTN and PepsAD readers are not ported yet."""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np
import torch

from ..ipeps.ipeps_abelian import IPEPS_ABELIAN
from .tensor import AbelianTensor, leg

_SYM_OF = {"U(1)": "U1", "U1": "U1", "Z2": "Z2", "U(1)xU(1)": "U1xU1", "U1xU1": "U1xU1"}
_SYM_TO_JSON = {"U1": "U(1)", "Z2": "Z2", "U1xU1": "U(1)xU(1)"}


def _charge(nsym, raw):
    """JSON charge list -> python charge (int for nsym=1, tuple else)."""
    if nsym == 1:
        return int(raw[0]) if isinstance(raw, (list, tuple)) else int(raw)
    return tuple(int(x) for x in raw)


def read_abelian_tensor(json_t, device="cpu") -> AbelianTensor:
    """Parse one serialized abelian tensor (format "abelian")."""
    assert json_t.get("format", "abelian") == "abelian"
    nsym = int(json_t.get("nsym", 1))
    sym_key = json_t["symmetry"]
    if isinstance(sym_key, (list, tuple)):
        sym_key = "x".join(sym_key)
    sym = _SYM_OF[sym_key]
    rank = int(json_t["rank"])
    signature = tuple(int(s) for s in json_t["signature"])
    n = _charge(nsym, json_t.get("n", [0] * nsym))
    cplx = "complex" in json_t.get("dtype", "float64")
    leg_dims = [dict() for _ in range(rank)]
    blocks = {}
    for b in json_t["blocks"]:
        if nsym == 1:
            qs = tuple(int(c) for c in b["charges"])
        else:
            cs = [int(c) for c in b["charges"]]
            qs = tuple(tuple(cs[i * nsym:(i + 1) * nsym]) for i in range(rank))
        dims = tuple(int(d) for d in b["dims"])
        for i, (q, d) in enumerate(zip(qs, dims)):
            prev = leg_dims[i].setdefault(q, d)
            assert prev == d, f"inconsistent dim for leg {i} charge {q}"
        arr = np.zeros(dims, dtype=np.complex128 if cplx else np.float64)
        is_cplx = "complex" in b.get("dtype", json_t.get("dtype", "float64"))
        for entry in b["entries"]:
            tok = entry.split()
            idx = tuple(int(x) for x in tok[:rank])
            arr[idx] = (float(tok[rank]) + 1j * float(tok[rank + 1])) if is_cplx else float(tok[rank])
        blocks[qs] = torch.from_numpy(arr)
    legs = tuple(leg(ld) for ld in leg_dims)
    return AbelianTensor(sym, signature, legs, n, blocks,
                         torch.complex128 if cplx else torch.float64, device=device)


def serialize_abelian_tensor(t: AbelianTensor) -> dict:
    """Inverse of :func:`read_abelian_tensor` (the reference format)."""
    nsym = 2 if t.sym == "U1xU1" else 1
    dtype_str = "complex128" if t.dtype == torch.complex128 else "float64"
    out = {
        "format": "abelian",
        "nsym": nsym,
        "symmetry": _SYM_TO_JSON[t.sym],
        "rank": t.ndim,
        "signature": list(t.signature),
        "n": list(t.n) if isinstance(t.n, tuple) else [t.n],
        "isdiag": False,
        "dtype": dtype_str,
        "blocks": [],
    }
    for qs, b in sorted(t.numpy_blocks().items(), key=lambda kv: str(kv[0])):
        charges = [int(q) for q in qs] if nsym == 1 else [int(x) for q in qs for x in q]
        entries = []
        for idx in np.ndindex(*b.shape):
            v = b[idx]
            pre = " ".join(str(i) for i in idx)
            if "complex" in dtype_str:
                entries.append(f"{pre} {float(v.real)!r} {float(v.imag)!r}")
            else:
                entries.append(f"{pre} {float(v)!r}")
        out["blocks"].append({"dtype": dtype_str, "dims": list(b.shape),
                              "numEntries": len(entries), "entries": entries,
                              "charges": charges})
    return out


def read_ipeps_abelian(path, vertexToSite=None, device="cpu") -> IPEPS_ABELIAN:
    """Read an abelian iPEPS state JSON onto ``device``."""
    with open(path) as f:
        raw = json.load(f)
    coord_of = {m["siteId"]: (int(m["x"]), int(m["y"])) for m in raw["map"]}
    sites = OrderedDict()
    for jt in raw["sites"]:
        sites[coord_of[jt["siteId"]]] = read_abelian_tensor(jt, device)
    sym = next(iter(sites.values())).sym
    return IPEPS_ABELIAN(sym, sites, vertexToSite=vertexToSite, lX=int(raw["lX"]),
                         lY=int(raw["lY"]))


def read_ipeps_abelian_c4v(path, device="cpu"):
    """Read a 1-site C4v abelian state, normalized to the generic bond
    convention (signature (-1,-1,-1,1,1)) by flipping (phys, u, l)."""
    st = read_ipeps_abelian(path, device=device)
    a = next(iter(st.sites.values()))
    if a.signature == (1, 1, 1, 1, 1):
        a = a.flip_charges((0, 1, 2))
    elif a.signature == (-1, -1, -1, -1, -1):
        a = a.flip_charges((3, 4))
    assert a.signature == (-1, -1, -1, 1, 1), a.signature
    return IPEPS_ABELIAN(st.sym, {(0, 0): a}, lX=1, lY=1)


def c4v_to_bipartite(state) -> IPEPS_ABELIAN:
    """The explicit bipartite Neel state [[A,B],[B,A]] of a normalized 1-site
    C4v U(1) state: B = phase * charge-conjugate(A), the phase -1 on the
    physical charge +1 component."""
    A0 = state.site((0, 0))
    assert A0.signature == (-1, -1, -1, 1, 1)
    A1 = A0.charge_conjugate()
    A1 = A1.copy_with({qs: (-b if qs[0] == 1 else b) for qs, b in A1.blocks.items()})
    return IPEPS_ABELIAN(state.sym, {(0, 0): A0, (1, 0): A1},
                         vertexToSite=lambda x: ((x[0] + x[1]) % 2, 0), lX=2, lY=2)


def write_ipeps_abelian(state: IPEPS_ABELIAN, path) -> None:
    """Write in the reference's abelian format (round-trips with
    :func:`read_ipeps_abelian` and with the JAX package's reader)."""
    site_ids, mp, sites = [], [], []
    for i, (coord, t) in enumerate(state.sites.items()):
        sid = f"A{i}"
        site_ids.append(sid)
        mp.append({"siteId": sid, "x": coord[0], "y": coord[1]})
        jt = serialize_abelian_tensor(t)
        jt["siteId"] = sid
        sites.append(jt)
    out = {"lX": state.lX, "lY": state.lY, "sites": sites, "siteIds": site_ids, "map": mp}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
