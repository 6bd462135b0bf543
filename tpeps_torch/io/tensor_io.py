"""JSON tensor (de)serialization, interchange-compatible with peps-torch
(a numpy-only copy of tpeps/io/tensor_io.py).

Reads/writes the reference's ``_state.json`` formats so states optimized
by either framework are interchangeable (reference ipeps/tensor_io.py:
37-343).  Two bare-tensor formats exist:

* "legacy": sparse list of ``"i0 i1 ... re [im]"`` entry strings with
  ``dims``/``dtype`` (or older ``physDim``/``auxDim``) metadata
  (reference tensor_io.py:60-93),
* "1D": dense 1-D array of stringified elements + ``dims``
  (reference tensor_io.py:45-58).

Everything here is host-side numpy; callers convert to tensors.
"""

from __future__ import annotations

from itertools import product

import numpy as np


def read_bare_json_tensor_np(json_obj) -> np.ndarray:
    """Read the "1D" dense format (reference tensor_io.py:45-58)."""
    dtype_str = json_obj["dtype"].lower()
    assert dtype_str in ("float64", "complex128"), "Invalid dtype " + dtype_str
    dims = json_obj["dims"]
    raw = np.asarray(json_obj["data"], dtype=np.complex128 if "complex" in dtype_str else np.float64)
    return raw.reshape(dims)


def read_bare_json_tensor_np_legacy(json_obj) -> np.ndarray:
    """Read the legacy sparse-entries format (reference tensor_io.py:60-93)."""
    t = json_obj
    dtype_str = t.get("dtype", "float64").lower()
    assert dtype_str in ("float64", "complex128"), "Invalid dtype " + dtype_str

    if "dims" in t:
        dims = t["dims"]
    else:
        dims = [t["physDim"]] + [t["auxDim"]] * 4

    X = np.zeros(dims, dtype=dtype_str)
    if dtype_str == "complex128":
        for entry in t["entries"]:
            l = entry.split()
            X[tuple(int(i) for i in l[:-2])] = float(l[-2]) + 1.0j * float(l[-1])
    else:
        for entry in t["entries"]:
            l = entry.split()
            k = 1 if len(l) == len(dims) + 1 else 2
            X[tuple(int(i) for i in l[:-k])] += float(l[-k])
    return X


def read_json_tensor(json_obj) -> np.ndarray:
    """Dispatch on the "format" key (reference ipeps/ipeps.py:397-402)."""
    if json_obj.get("format") == "1D":
        return read_bare_json_tensor_np(json_obj)
    return read_bare_json_tensor_np_legacy(json_obj)


def serialize_bare_tensor_legacy(t: np.ndarray, tol: float = 1.0e-14) -> dict:
    """Write the legacy sparse-entries format (reference tensor_io.py:251-289)."""
    t = np.asarray(t)
    is_complex = np.iscomplexobj(t)
    json_tensor = {
        "dtype": "complex128" if is_complex else "float64",
        "dims": list(t.shape),
    }
    entries = []
    for idx in product(*(range(d) for d in t.shape)):
        v = t[idx]
        if abs(v) > tol:
            if is_complex:
                entries.append(" ".join(str(i) for i in idx) + f" {v.real:.18e} {v.imag:.18e}")
            else:
                entries.append(" ".join(str(i) for i in idx) + f" {float(v):.18e}")
    json_tensor["numEntries"] = len(entries)
    json_tensor["entries"] = entries
    return json_tensor


def serialize_bare_tensor_np(t: np.ndarray) -> dict:
    """Write the "1D" dense format (reference tensor_io.py:291-310)."""
    t = np.asarray(t)
    json_tensor = {
        "format": "1D",
        "dtype": "complex128" if np.iscomplexobj(t) else "float64",
        "dims": list(t.shape),
        "data": [str(v) for v in t.ravel()],
    }
    return json_tensor
