"""K7 Ozaki kernels (``csrc/ozaki.cu``) and their twins: the int8 digit split
of a float64 matrix and the exact int8 digit-product GEMM with its float64 /
float32 recombination (counterparts of ``_split_int8`` and ``_accumulate``
in tpeps/linalg/ozaki.py).

Digit planes are int8 tensors ``(s, rows, kp)``: the rows of a left operand
``A (m, k)`` (``axis=1``), or the columns of a right operand ``B (k, n)``
(``axis=0``, so B's planes are stored transposed), over the contracted index
padded with zero digits to ``kp``, a multiple of 32.  The exponents ``e``
are float64 powers of two, one per row.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import LAUNCHES, require_contiguous, route, stream_of
from .build import library

KP_ALIGN = 32  # the int8 wgmma's k depth; the planes' k is padded to it
TAIL_BITS = 42  # digit groups with total * w >= 42 recombine in float32
MAX_SLICES = 8  # the kernel's group sums per output: totals 2 .. MAX_SLICES + 1
# launches of ozaki_gemm by (s, m, kp, n) and of ozaki_split by (axis, rows, k),
# counted beside LAUNCHES["ozaki_gemm"] and LAUNCHES["ozaki_split"] for eager
# calls (a CUDA graph's capture counts here once, its replays not)
SHAPE_LAUNCHES: collections.Counter = collections.Counter()
SPLIT_LAUNCHES: collections.Counter = collections.Counter()


def padded_k(k: int) -> int:
    return -(-k // KP_ALIGN) * KP_ALIGN


def _check_sw(name: str, s: int, w: int) -> None:
    if not 1 <= w <= 7:
        raise ValueError(f"{name}: word_bits={w} must be in [1, 7] (int8 digits)")
    if s < 1:
        raise ValueError(f"{name}: slices={s} must be positive")


def ozaki_split_twin(X, s: int, w: int, axis: int):
    """``_split_int8`` line by line in torch ops, with the kernel's layout."""
    mx = X.abs().amax(dim=axis, keepdim=True)
    mx = torch.where(mx == 0.0, torch.ones_like(mx), mx)
    ex = torch.floor(torch.log2(mx)) + 1.0
    e = torch.exp2(ex)
    R = X * torch.exp2(-ex)
    neg = R < 0.0
    P = R.abs()
    dpw = max(1, 28 // w)  # digits per int32 word
    wb = dpw * w  # bits per word (< 31 keeps the truncation exact)
    word_scale = float(2.0**wb)
    sgn = torch.where(neg, -1, 1).to(torch.int8)
    mask = (1 << w) - 1
    chunks = []
    rem = P
    while len(chunks) < s:
        y = rem * word_scale  # exact power-of-two shift
        u = y.to(torch.int32)  # truncation; y in [0, 2^wb)
        rem = y - u.to(torch.float64)  # exact fractional tail
        for j in range(dpw):
            if len(chunks) == s:
                break
            d = (u >> (wb - (j + 1) * w)) & mask
            chunks.append(d.to(torch.int8) * sgn)
    planes = torch.stack(chunks)
    if axis == 0:
        planes = planes.transpose(1, 2)
    k = planes.shape[-1]
    planes = torch.nn.functional.pad(planes, (0, padded_k(k) - k)).contiguous()
    return planes, e.reshape(-1)


def ozaki_split(X, s: int = 8, w: int = 7, axis: int = 1):
    """Digit planes ``(s, rows, kp)`` int8 and exponents ``(rows,)`` float64 of
    a float64 matrix: its rows (``axis=1``, ``X`` is ``(m, k)``) or its
    columns (``axis=0``, ``X`` is ``(k, n)``)."""
    if X.dim() != 2 or X.dtype != torch.float64:
        raise TypeError(f"ozaki_split: a 2-D float64 matrix expected, got {X.dtype} "
                        f"{tuple(X.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"ozaki_split: axis={axis} must be 0 or 1")
    _check_sw("ozaki_split", s, w)
    if not route("ozaki_split", X, check_dtype=False):
        return ozaki_split_twin(X, s, w, axis)
    require_contiguous("ozaki_split", X=X)
    lib = library()
    if s > lib.cdll.tpeps_ozaki_max_slices():
        raise ValueError(f"ozaki_split: the kernel takes at most "
                         f"{lib.cdll.tpeps_ozaki_max_slices()} slices, got {s}")
    k, rows = X.shape[axis], X.shape[1 - axis]
    kp = padded_k(k)
    planes = torch.empty((s, rows, kp), dtype=torch.int8, device=X.device)
    e = torch.empty(rows, dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        err = lib.cdll.tpeps_ozaki_split(X.data_ptr(), planes.data_ptr(), e.data_ptr(), rows, k,
                                          kp, s, w, axis, stream_of(X))
    lib.check(err, "ozaki_split")
    LAUNCHES["ozaki_split"] += 1
    SPLIT_LAUNCHES[axis, rows, k] += 1
    return planes, e


def _wrap_int32(x):
    """int64 -> int32 modulo 2^32, as an int32 accumulator wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def ozaki_gemm_twin(Ap, ea, Bp, eb, w: int):
    """``_accumulate`` line by line: each digit-pair product formed as
    ``Ac.double() @ Bc.double().T`` (exact while |sums| < 2^53) and taken to
    int32, the group sums wrapped as int32 sums wrap, then the same
    recombination."""
    s = Ap.shape[0]
    A64 = [a.double() for a in Ap]
    B64 = [b.double() for b in Bp]
    m, n = Ap.shape[1], Bp.shape[1]
    out = torch.zeros((m, n), dtype=torch.float64, device=Ap.device)
    tail32 = None
    t_prev = None
    # accumulate cheapest-first so the final adds land on the big terms
    for total in range(s + 1, 1, -1):
        acc = None
        for p in range(1, s + 1):
            q = total - p
            if q < 1 or q > s:
                continue
            prod = (A64[p - 1] @ B64[q - 1].T).to(torch.int64)
            acc = prod if acc is None else acc + prod
        acc32 = _wrap_int32(acc)
        if total * w >= TAIL_BITS:
            if tail32 is None:
                tail32 = acc32.to(torch.float32)
            else:
                tail32 = tail32 * float(2.0 ** ((total - t_prev) * w)) + acc32.to(torch.float32)
            t_prev = total
        else:
            out = out + acc32.to(torch.float64) * float(2.0 ** (-total * w))
    if tail32 is not None:
        out = out + tail32.to(torch.float64) * float(2.0 ** (-t_prev * w))
    return out * ea[:, None] * eb[None, :]


def recombination_table(s: int, w: int):
    """``_accumulate``'s recombination steps as the kernel reads them, per
    group ``g = total - 2``: ``kind[g]`` (0 absent, 1 float64 group, 2 first
    float32 tail group, 3 tail group), ``scale[g] = 2^(-total w)`` (kind 1),
    ``factor[g] = 2^((total - t_prev) w)`` (kind 3) and the tail's final
    scale ``2^(-t_prev w)`` (0.0 without a tail), the same Python floats as
    :func:`ozaki_gemm_twin` multiplies by."""
    if not 1 <= s <= MAX_SLICES:
        raise ValueError(f"recombination_table: slices={s} must be in [1, {MAX_SLICES}]")
    kind, scale, factor = [0] * MAX_SLICES, [0.0] * MAX_SLICES, [0.0] * MAX_SLICES
    t_prev = None
    for total in range(s + 1, 1, -1):
        g = total - 2
        if total * w >= TAIL_BITS:
            if t_prev is None:
                kind[g] = 2
            else:
                kind[g], factor[g] = 3, float(2.0 ** ((total - t_prev) * w))
            t_prev = total
        else:
            kind[g], scale[g] = 1, float(2.0 ** (-total * w))
    tail_scale = float(2.0 ** (-t_prev * w)) if t_prev is not None else 0.0
    return kind, scale, factor, tail_scale


@functools.lru_cache(maxsize=64)
def _table_c(s: int, w: int):
    """:func:`recombination_table` as the C arrays the launcher reads."""
    kind, scale, factor, tail_scale = recombination_table(s, w)
    return ((ctypes.c_int * MAX_SLICES)(*kind),
            (ctypes.c_double * (2 * MAX_SLICES + 1))(*scale, *factor, tail_scale))


def ozaki_gemm(Ap, ea, Bp, eb, w: int = 7):
    """``A @ B`` (m, n) float64 from A's digit planes ``(s, m, kp)`` and B's
    ``(s, n, kp)`` (as :func:`ozaki_split` writes them) and their exponents."""
    if (Ap.dim() != 3 or Bp.dim() != 3 or Ap.shape[0] != Bp.shape[0]
            or Ap.shape[2] != Bp.shape[2] or Ap.shape[2] % KP_ALIGN):
        raise ValueError(f"ozaki_gemm: planes {tuple(Ap.shape)} and {tuple(Bp.shape)} do not "
                         f"match (s, rows, kp) with kp a multiple of {KP_ALIGN}")
    if Ap.dtype != torch.int8 or Bp.dtype != torch.int8:
        raise TypeError("ozaki_gemm: digit planes must be int8")
    if ea.shape != (Ap.shape[1],) or eb.shape != (Bp.shape[1],) or ea.dtype != torch.float64 \
            or eb.dtype != torch.float64:
        raise ValueError("ozaki_gemm: exponents must be float64 vectors, one per row")
    s = Ap.shape[0]
    _check_sw("ozaki_gemm", s, w)
    if not route("ozaki_gemm", Ap, ea, Bp, eb, check_dtype=False):
        return ozaki_gemm_twin(Ap, ea, Bp, eb, w)
    require_contiguous("ozaki_gemm", Ap=Ap, ea=ea, Bp=Bp, eb=eb)
    kind_c, coef_c = _table_c(s, w)
    m, n, kp = Ap.shape[1], Bp.shape[1], Ap.shape[2]
    C = torch.empty((m, n), dtype=torch.float64, device=Ap.device)
    if m == 0 or n == 0:
        return C
    lib = library()
    with torch.cuda.device(Ap.device):
        err = lib.cdll.tpeps_ozaki_gemm(Ap.data_ptr(), ea.data_ptr(), Bp.data_ptr(),
                                         eb.data_ptr(), C.data_ptr(), m, n, kp, s, w, kind_c,
                                         coef_c, stream_of(Ap))
    lib.check(err, "ozaki_gemm")
    LAUNCHES["ozaki_gemm"] += 1
    SHAPE_LAUNCHES[s, m, kp, n] += 1
    return C
