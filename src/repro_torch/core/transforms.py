"""Cook-Toom / Winograd transform-matrix generation.

Generates exact (rational-arithmetic) transform matrices for the minimal
bilinear algorithm F(m, r): m correlation outputs of an r-tap filter over an
n = m + r - 1 input window, using n multiplications instead of m * r.

Construction (transposition principle, cf. Blahut ch. 5 / Barabasz et al.):

  Linear convolution of a (len m) and b (len r) via evaluation-interpolation at
  n points (n-1 finite + the point at infinity) is

      c = V^{-1} [(E_m a) . (E_r b)]

  where E_k is the n x k Vandermonde evaluation matrix (infinity row selects
  the leading coefficient) and V = E_n. Correlation is the transpose of
  convolution-by-the-filter, which yields

      y = A^T [(G g) . (B^T d)]

  with  A^T = E_m^T  (m x n),   G = E_r  (n x r),   B^T = V^{-T}  (n x n).

All arithmetic is done in exact fractions; the float matrices returned are the
correctly rounded values. The identity is verified numerically in tests for
every variant used by the system (no hand-copied literature matrices).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import NamedTuple, Sequence

import numpy as np

# Interpolation points, in the order they are consumed. Chosen per the
# Toom-Cook error-analysis literature (small symmetric rationals) to keep the
# fp32 error of the large variants acceptable.
_POINTS: Sequence[Fraction] = tuple(
    Fraction(p)
    for p in (0, 1, -1, 2, -2, Fraction(1, 2), Fraction(-1, 2), 4, -4,
              Fraction(1, 4), Fraction(-1, 4), 8, -8)
)


class CookToom(NamedTuple):
    """Transform set for F(m, r).

    The matrices are stored as nested tuples so the whole object is hashable
    (plan specs hold it and are compared by value); the .AT / .G / .BT
    properties expose them as float64 numpy arrays.
    """

    m: int            # outputs per tile
    r: int            # filter taps
    t: int            # input tile size  (= m + r - 1)
    at_rows: tuple    # (m, t) output (inverse) transform -- paper's Z^T
    g_rows: tuple     # (t, r) filter transform           -- paper's W
    bt_rows: tuple    # (t, t) input transform            -- paper's X^T

    @property
    def AT(self) -> np.ndarray:
        return np.array(self.at_rows, dtype=np.float64)

    @property
    def G(self) -> np.ndarray:
        return np.array(self.g_rows, dtype=np.float64)

    @property
    def BT(self) -> np.ndarray:
        return np.array(self.bt_rows, dtype=np.float64)

    @property
    def mult_reduction_1d(self) -> float:
        """Theoretical multiplication reduction for the 1D algorithm."""
        return (self.m * self.r) / self.t

    @property
    def mult_reduction_2d(self) -> float:
        """Theoretical multiplication reduction for the nested 2D algorithm."""
        return (self.m * self.r) ** 2 / self.t**2


def _vandermonde(points: Sequence[Fraction], cols: int) -> list[list[Fraction]]:
    """(len(points)+1) x cols evaluation matrix; final row = point at infinity."""
    rows = [[p**j for j in range(cols)] for p in points]
    rows.append([Fraction(0)] * (cols - 1) + [Fraction(1)])
    return rows


def _invert(mat: list[list[Fraction]]) -> list[list[Fraction]]:
    """Exact Gauss-Jordan inverse over the rationals."""
    n = len(mat)
    a = [row[:] + [Fraction(int(i == j)) for j in range(n)]
         for i, row in enumerate(mat)]
    for col in range(n):
        piv = next(i for i in range(col, n) if a[i][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = Fraction(1) / a[col][col]
        a[col] = [v * inv for v in a[col]]
        for i in range(n):
            if i != col and a[i][col] != 0:
                f = a[i][col]
                a[i] = [vi - f * vc for vi, vc in zip(a[i], a[col])]
    return [row[n:] for row in a]


def _to_rows(mat: list[list[Fraction]]) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in mat)


@functools.lru_cache(maxsize=None)
def cook_toom(m: int, r: int) -> CookToom:
    """Build the F(m, r) transform set.

    Args:
      m: outputs per tile (>= 1).
      r: filter taps (>= 1).
    """
    if m < 1 or r < 1:
        raise ValueError(f"F({m}, {r}): m and r must be >= 1")
    t = m + r - 1
    if t - 1 > len(_POINTS):
        raise ValueError(f"F({m}, {r}) needs {t - 1} finite points; "
                         f"only {len(_POINTS)} configured")
    pts = _POINTS[: t - 1]
    E_m = _vandermonde(pts, m)           # n x m
    E_r = _vandermonde(pts, r)           # n x r
    V = _vandermonde(pts, t)             # n x n
    V_inv = _invert(V)
    # B^T = V^{-T}
    BT = [[V_inv[j][i] for j in range(t)] for i in range(t)]
    AT = [[E_m[j][i] for j in range(t)] for i in range(m)]   # E_m^T
    return CookToom(m=m, r=r, t=t, at_rows=_to_rows(AT), g_rows=_to_rows(E_r),
                    bt_rows=_to_rows(BT))


@functools.lru_cache(maxsize=None)
def scaled_cook_toom(m: int, r: int) -> CookToom:
    """F(m, r) with per-evaluation-point row scaling (Barabasz et al.).

    Large variants such as F(6, 3) mix very small and very large entries in
    B^T, so the fp32 input transform loses relative precision on the rows
    with large dynamic range. Scaling each B^T row p by the power of two
    nearest its max-abs entry -- and compensating exactly by the inverse
    scale on the matching G row -- leaves the bilinear identity unchanged
    (the pointwise product (G g)_p * (B^T d)_p is scale-invariant) while
    equalizing row magnitudes. Power-of-two scales only shift the exponent,
    so the stored matrices stay correctly rounded and the compensation is
    bit-exact in floating point.
    """
    base = cook_toom(m, r)
    bt, g = [list(r_) for r_ in base.bt_rows], [list(r_) for r_ in base.g_rows]
    for p in range(base.t):
        amax = max(abs(v) for v in bt[p])
        if amax == 0:
            continue
        s = 2.0 ** round(math.log2(amax))
        bt[p] = [v / s for v in bt[p]]
        g[p] = [v * s for v in g[p]]
    return CookToom(m=base.m, r=base.r, t=base.t, at_rows=base.at_rows,
                    g_rows=tuple(tuple(row) for row in g),
                    bt_rows=tuple(tuple(row) for row in bt))


#: fp32 relative-error budget (max-norm, vs a float64 direct oracle) the
#: scaled F(6, 3) executor must hold, including on adversarial
#: large-magnitude filters.
F63_FP32_ERROR_BUDGET = 5e-4


def transform_filter_1d(ct: CookToom, g: np.ndarray) -> np.ndarray:
    """(r, ...) -> (t, ...): G @ g along the leading axis."""
    return np.tensordot(ct.G, g, axes=(1, 0))


def correlate_1d_reference(ct: CookToom, d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Direct F(m, r) on one tile: y = A^T [(G g) . (B^T d)].  Testing only."""
    u = ct.G @ g            # (t,)
    v = ct.BT @ d           # (t,)
    return ct.AT @ (u * v)  # (m,)


# ---------------------------------------------------------------------------
# Variant registry: the named algorithm variants the paper implements, plus
# the ones the assigned architectures need. Names follow F(out, filt).
# ---------------------------------------------------------------------------

#: Default output-tile size per filter size, mirroring the paper's choices
#: (F(4x4, 3x3) / F(2x2, 3x3) for 3x3, small tiles for the big filters where
#: fp32 error would otherwise blow up).
DEFAULT_OUTPUT_TILE: dict[int, int] = {2: 4, 3: 4, 4: 4, 5: 2, 7: 2}


def default_variant(r: int) -> CookToom:
    return cook_toom(DEFAULT_OUTPUT_TILE.get(r, 2), r)
