"""MRT (multiple-relaxation-time) collision for D3Q19: the moment basis
and the relaxation matrices (NumPy; a jax-free copy of
lbm_tpu/core/mrt.py, equal to it bit for bit).

The 19 basis rows come from Gram-Schmidt over the standard monomials
(d'Humieres et al. 2002) on this repo's velocity ordering; they have
definite parity under e -> -e (10 even, 9 odd). With M's rows
orthogonal, the operator is one 19x19 matrix K = M^T diag(s_k / d_k) M,
f' = f - K (f - feq), and the Guo source goes through KF = M^T diag((1
- s_k/2) / d_k) M. Conserved rows (rho, j) relax at 0, the five shear
rows at 1/tau, the rest at the d'Humieres defaults unless overridden.

The dense step and the CUDA kernel both multiply by the fp32 K.
`mrt_rank_update` is lbm_tpu's kernel form (a rank update over the ten
tunable rows), kept as the reference that K and it agree.
"""

from __future__ import annotations

import functools

import numpy as np

from lbm_tpu_torch.core.lattice import D3Q19

#: moment-class name per basis row, in construction order.
CLASSES = (
    "rho", "e", "eps",
    "jx", "qx", "jy", "qy", "jz", "qz",
    "pxx", "pixx", "pww", "piww",
    "pxy", "pyz", "pxz",
    "mx", "my", "mz",
)

#: default relaxation rates per tunable class (d'Humieres et al. 2002).
DEFAULT_RATES = {"e": 1.19, "eps": 1.4, "q": 1.2, "pi": 1.4, "m": 1.98}

_CLASS_OF = {
    "rho": "conserved", "jx": "conserved", "jy": "conserved",
    "jz": "conserved",
    "e": "e", "eps": "eps",
    "qx": "q", "qy": "q", "qz": "q",
    "pxx": "nu", "pww": "nu", "pxy": "nu", "pyz": "nu", "pxz": "nu",
    "pixx": "pi", "piww": "pi",
    "mx": "m", "my": "m", "mz": "m",
}

#: basis rows of the rank update, the ten tunable ones, in class order.
TUNABLE_ROWS = tuple(k for k, name in enumerate(CLASSES)
                     if _CLASS_OF[name] not in ("conserved", "nu"))


@functools.lru_cache(maxsize=1)
def mrt_basis() -> tuple[np.ndarray, np.ndarray]:
    """(M (19, 19) f64, d (19,) f64): orthogonal moment basis rows over
    this repo's velocity ordering and their squared norms."""
    e = D3Q19.E.astype(np.float64)  # (19, 3)
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    e2 = ex * ex + ey * ey + ez * ez
    raw = np.stack([
        np.ones(19),            # rho
        e2,                     # e (energy)
        e2 * e2,                # eps (via GS against rho, e)
        ex,                     # jx
        ex * e2,                # qx (via GS against jx)
        ey,                     # jy
        ey * e2,                # qy
        ez,                     # jz
        ez * e2,                # qz
        3.0 * ex * ex - e2,     # pxx
        (3.0 * ex * ex - e2) * e2,   # pixx
        ey * ey - ez * ez,      # pww
        (ey * ey - ez * ez) * e2,    # piww
        ex * ey,                # pxy
        ey * ez,                # pyz
        ex * ez,                # pxz
        ex * (ey * ey - ez * ez),    # mx
        ez * (ex * ex - ey * ey),    # my (parity: odd, 3rd order)
        ey * (ez * ez - ex * ex),    # mz
    ])
    m = raw.copy()
    for k in range(19):
        for j in range(k):
            dj = float(m[j] @ m[j])
            if dj > 0:
                m[k] = m[k] - (float(m[k] @ m[j]) / dj) * m[j]
    d = np.einsum("ki,ki->k", m, m)
    if not (d > 1e-9).all():
        raise ArithmeticError("degenerate moment basis")
    if np.abs(m @ m.T - np.diag(d)).max() >= 1e-9:
        raise ArithmeticError("moment basis rows are not orthogonal")
    return m, d


def _rates_vector(tau: float, rates: dict | None) -> np.ndarray:
    r = dict(DEFAULT_RATES)
    if rates:
        unknown = set(rates) - set(DEFAULT_RATES)
        if unknown:
            raise ValueError(f"unknown MRT rate classes {sorted(unknown)}; "
                             f"known: {sorted(DEFAULT_RATES)}")
        r.update(rates)
    s_nu = 1.0 / tau
    out = np.zeros(19)
    for k, name in enumerate(CLASSES):
        cls = _CLASS_OF[name]
        if cls == "conserved":
            out[k] = 0.0
        elif cls == "nu":
            out[k] = s_nu
        else:
            out[k] = r[cls]
    return out


def mrt_matrices(tau: float, rates: dict | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(K, KF) f64 19x19: the collision matrix f' = f - K (f - feq) and
    the Guo-source prefactor S_applied = KF @ G. For the conserved rows
    s = 0: K annihilates them and KF passes the source's momentum through
    with the exact (1 - 0/2) = 1 weight Guo requires."""
    m, d = mrt_basis()
    s = _rates_vector(tau, rates)
    k = (m.T * (s / d)) @ m
    kf = (m.T * ((1.0 - 0.5 * s) / d)) @ m
    return k, kf


def mrt_rank_update(tau: float, rates: dict | None = None
                    ) -> tuple[tuple, tuple]:
    """Rank-structured form: K = s_nu (I - P_cons) + sum_r (s_r - s_nu)/d_r
    m_r m_r^T, so

      f' = f - s_nu f_neq + sum_r coef_r (m_r . f_neq) m_r,
      coef_r = (s_nu - s_r)/d_r,

    over the <= 10 tunable rows whose rate differs from 1/tau. The s_nu
    P_cons f_neq term is dropped: without a force the conserved moments
    of f_neq vanish (up to rounding), so MRT + force needs the dense step.
    Returns (rows, coefs) as nested tuples of floats."""
    m, d = mrt_basis()
    s = _rates_vector(tau, rates)
    s_nu = 1.0 / tau
    rows, coefs = [], []
    for k in TUNABLE_ROWS:
        c = (s_nu - s[k]) / d[k]
        if abs(c) < 1e-14:
            continue
        rows.append(tuple(float(v) for v in m[k]))
        coefs.append(float(c))
    return tuple(rows), tuple(coefs)


__all__ = ["mrt_basis", "mrt_matrices", "mrt_rank_update", "CLASSES",
           "DEFAULT_RATES", "TUNABLE_ROWS"]
