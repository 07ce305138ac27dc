"""Per-cell effective-relaxation closures: Smagorinsky LES and
shear-rate-dependent (non-Newtonian) rheology (torch port of
lbm_tpu/core/rheology.py).

Every closure consumes P = sqrt(2 Pi:Pi) with the non-equilibrium
momentum flux Pi_ab = sum_i e_ia e_ib f_neq_i. The local shear rate
follows from the second-moment relation S_ab = -3/(2 rho tau) Pi_ab:

    gamma_dot = 3 P / (2 rho tau_eff)

so a generalized-Newtonian fluid nu(gamma_dot) closes into the per-cell
fixed point tau_eff = 1/2 + 3 nu(3 P / (2 rho tau_eff)), solved by a
Picard loop of `iters` iterations with each iterate clipped to
`tau_bounds`.

Closure canonical form (a hashable tuple):

    ('smag', cs)                                  Smagorinsky LES
    ('plaw', K, n, te_lo, te_hi, iters)           nu = K gamma^(n-1)
    ('cy', nu0, nu_inf, lam, n, a, te_lo, te_hi, iters)
        nu = nu_inf + (nu0-nu_inf) (1 + (lam gamma)^a)^((n-1)/a)
        (a = 2 is Carreau; general a is Carreau-Yasuda)
    ('casson', nu_c, tau_y, te_lo, te_hi, iters)
        nu = (sqrt(nu_c) + sqrt(tau_y/gamma))^2, in closed form

All parameters are in lattice units (nu_lat = (tau-1/2)/3).

`tau_eff_from_p` keeps lbm_tpu's fp32 constants (each composed in double
and rounded once) and operation order. Every division is tensor by
tensor: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, and `scalar / tensor` is reciprocal-times-scalar, so the
CUDA kernels (kernels/csrc/collide_stream.cu), which divide, could not
agree with it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lbm_tpu_torch.core.lattice import D3Q19, _signed_sum

_TE_LO = 0.5005     # default tau_eff clip: nu >= 1.67e-4 lattice units
_TE_HI = 20.0       # ... and nu <= 6.5 (huge, but finite: plug cores)
_ITERS = 8          # Picard iterations
_TINY = np.float32(1e-30)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def normalize_closure(smagorinsky_cs, rheology: Optional[dict]):
    """Validate and canonicalize CaseSpec.(smagorinsky_cs, rheology) into
    one closure tuple (or None). At most one of the two may be set."""
    if smagorinsky_cs is not None and rheology is not None:
        raise ValueError("smagorinsky_cs and rheology are exclusive "
                         "(both are per-cell tau closures)")
    if smagorinsky_cs is not None:
        cs = float(smagorinsky_cs)
        _check(cs > 0.0, f"smagorinsky_cs must be > 0: {cs}")
        return ("smag", cs)
    if rheology is None:
        return None
    r = dict(rheology)
    model = r.pop("model")

    def req(key):
        try:
            return r.pop(key)
        except KeyError:
            raise ValueError(
                f"rheology model {model!r} requires {key!r}") from None

    lo, hi = r.pop("tau_bounds", (_TE_LO, _TE_HI))
    lo, hi = float(lo), float(hi)
    _check(0.5 < lo < hi, "tau_bounds must satisfy 0.5 < lo < hi")
    iters = int(r.pop("iters", _ITERS))
    _check(iters >= 1, "iters must be >= 1")
    if model == "power_law":
        k, n = float(req("K")), float(req("n"))
        _check(k > 0.0 and n > 0.0, "power_law needs K > 0 and n > 0")
        _check(not r, f"unknown power_law keys: {sorted(r)}")
        return ("plaw", k, n, lo, hi, iters)
    if model == "casson":
        nu_c = float(req("nu_c"))
        tau_y = float(req("tau_y"))
        _check(nu_c > 0.0 and tau_y >= 0.0,
               "casson needs nu_c > 0 and tau_y >= 0")
        _check(not r, f"unknown casson keys: {sorted(r)}")
        return ("casson", nu_c, tau_y, lo, hi, iters)
    if model in ("carreau", "carreau_yasuda"):
        nu0 = float(req("nu0"))
        nu_inf = float(req("nu_inf"))
        lam = float(req("lam"))
        n = float(req("n"))
        a = float(r.pop("a", 2.0))
        _check(nu0 > 0.0 and nu_inf > 0.0 and lam >= 0.0,
               "carreau needs nu0 > 0, nu_inf > 0 and lam >= 0")
        _check(n > 0.0 and a > 0.0, "carreau needs n > 0 and a > 0")
        _check(not r, f"unknown carreau keys: {sorted(r)}")
        return ("cy", nu0, nu_inf, lam, n, a, lo, hi, iters)
    raise ValueError(f"unknown rheology model {model!r} "
                     "(power_law | carreau | carreau_yasuda | casson)")


def carreau_blood(units, rho: float = 1060.0, mu0: float = 0.056,
                  mu_inf: float = 0.00345, lam: float = 3.313,
                  n: float = 0.3568, a: float = 2.0, **kw) -> dict:
    """CaseSpec.rheology dict for physiological blood in the given
    UnitSystem: the Carreau fit of Cho & Kensey (1991), mu0 = 56 mPa.s,
    mu_inf = 3.45 mPa.s, lambda = 3.313 s, n = 0.3568. nu_lat = nu_phys /
    (CH C_U), lam_lat = lam_phys / C_T. Extra keys (tau_bounds, iters)
    pass through."""
    nu_scale = units.CH * units.C_U  # lattice kinematic-viscosity unit
    return {"model": "carreau", "nu0": mu0 / rho / nu_scale,
            "nu_inf": mu_inf / rho / nu_scale,
            "lam": lam / units.C_T, "n": n, "a": a, **kw}


def nu_of_gamma(gamma, closure):
    """Apparent kinematic viscosity nu(gamma_dot) of a rheology closure
    (NumPy, float64, unclipped)."""
    gamma = np.asarray(gamma, np.float64)
    if closure[0] == "plaw":
        k, n = closure[1], closure[2]
        return k * gamma ** (n - 1.0)
    if closure[0] == "cy":
        nu0, nu_inf, lam, n, a = closure[1:6]
        return nu_inf + (nu0 - nu_inf) * (
            1.0 + (lam * gamma) ** a) ** ((n - 1.0) / a)
    if closure[0] == "casson":
        nu_c, tau_y = closure[1], closure[2]
        return (np.sqrt(nu_c) + np.sqrt(tau_y / gamma)) ** 2
    raise ValueError(f"{closure[0]!r} has no nu(gamma)")


def closure_constants(closure, tau0: float) -> dict:
    """The fp32 constants of `tau_eff_from_p` for one closure, each
    composed in double and rounded once, as lbm_tpu composes them; the
    CUDA kernels receive the same values."""
    kind = closure[0]
    f32 = np.float32
    out = {"kind": kind, "t0": f32(tau0)}
    if kind == "smag":
        out["k"] = f32(18.0 * closure[1] * closure[1])
    elif kind == "plaw":
        _, k, n, lo, hi, iters = closure
        out.update(em1=f32(n - 1.0), c3k=f32(3.0 * k), lo=f32(lo),
                   hi=f32(hi), iters=int(iters))
    elif kind == "cy":
        _, nu0, nu_inf, lam, n, a, lo, hi, iters = closure
        out.update(dnu3=f32(3.0 * (nu0 - nu_inf)),
                   base=f32(0.5 + 3.0 * nu_inf), ea=f32(a),
                   ex=f32((n - 1.0) / a), lam=f32(lam), square=(a == 2.0),
                   lo=f32(lo), hi=f32(hi), iters=int(iters))
    elif kind == "casson":
        _, nu_c, tau_y, lo, hi, _ = closure
        out.update(b=f32(0.5 + 3.0 * nu_c),
                   cc=f32(6.0 * np.sqrt(nu_c * tau_y)),
                   dd=f32(3.0 * tau_y), lo=f32(lo), hi=f32(hi))
    else:
        raise ValueError(f"unknown closure kind {kind!r}")
    return out


def _c(value, like):
    """A 0-dim fp32 tensor on like's device (for exact divisions)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def tau_eff_from_p(p, inv_rho, tau0: float, closure):
    """Per-cell effective relaxation time from P = sqrt(2 Pi:Pi) and
    1/rho, fp32, in lbm_tpu's operation order."""
    k = closure_constants(closure, tau0)
    kind = k["kind"]
    t0 = float(k["t0"])
    if kind == "smag":
        # closed form (Hou et al.): nu_t = (Cs D)^2 |S|, D = 1 cell
        return 0.5 * (t0 + torch.sqrt(t0 * t0 + float(k["k"]) * p
                                      * inv_rho))
    # generalized-Newtonian fixed point te = 1/2 + 3 nu(g0/te),
    # g0 = (3/2) P / rho = gamma_dot * te
    g0 = 1.5 * p * inv_rho
    te = torch.zeros_like(p) + t0
    if kind == "plaw":
        for _ in range(k["iters"]):
            lg = torch.log(torch.clamp_min(g0 / te, float(_TINY)))
            te = torch.clamp(0.5 + float(k["c3k"])
                             * torch.exp(float(k["em1"]) * lg),
                             float(k["lo"]), float(k["hi"]))
        return te
    if kind == "cy":
        lam = float(k["lam"])
        for _ in range(k["iters"]):
            if k["square"]:
                # standard Carreau: (lam gamma)^2 is an exact square
                z = lam * g0 / te
                x = z * z
            else:
                lg = torch.log(torch.clamp_min(lam * g0 / te,
                                               float(_TINY)))
                x = torch.exp(float(k["ea"]) * lg)      # (lam gamma)^a
            nu3 = float(k["dnu3"]) * torch.exp(float(k["ex"])
                                               * torch.log1p(x))
            te = torch.clamp(float(k["base"]) + nu3, float(k["lo"]),
                             float(k["hi"]))
        return te
    # casson: the fixed point is quadratic in s = sqrt(te),
    #   (1 - D/g0) s^2 - (C/sqrt(g0)) s - B = 0,
    # solved in closed form; with D/g0 >= 1 (the plug core) te rides
    # the hi clip. tau_y = 0 is Newtonian nu_c.
    g = torch.clamp_min(g0, float(_TINY))
    a = 1.0 - _c(k["dd"], g) / g
    c = _c(k["cc"], g) / torch.sqrt(g)
    disc = c * c + 4.0 * a * float(k["b"])
    s = ((c + torch.sqrt(torch.clamp_min(disc, 0.0)))
         / (2.0 * torch.clamp_min(a, float(_TINY))))
    te = torch.where(a > 0, s * s, _c(k["hi"], g))
    return torch.clamp(te, float(k["lo"]), float(k["hi"]))


def pi_norm(fneq):
    """P = sqrt(2 Pi:Pi), Pi_ab = sum_i e_ia e_ib fneq_i: each Pi_ab a
    signed sum in direction order, Pi:Pi = Pxx^2 + Pyy^2 + Pzz^2 +
    2 (Pxy^2 + Pxz^2 + Pyz^2)."""
    e = D3Q19.E

    def pi(a, b):
        return _signed_sum([fneq[i] for i in range(D3Q19.Q)],
                           e[:, a] * e[:, b])

    pxx, pyy, pzz = pi(0, 0), pi(1, 1), pi(2, 2)
    pxy, pxz, pyz = pi(0, 1), pi(0, 2), pi(1, 2)
    s = (pxx * pxx + pyy * pyy + pzz * pzz
         + 2.0 * (pxy * pxy + pxz * pxz + pyz * pyz))
    return torch.sqrt(2.0 * s)


def tau_eff(fneq, rho, tau: float, closure):
    """Per-cell tau_eff of a closure from the full (19, ...) pre-collision
    f_neq and rho: P = sqrt(2 Pi:Pi), then tau_eff_from_p (the dense
    path's form; subsumes engine/step.les_tau_eff, closure ('smag', cs))."""
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    return tau_eff_from_p(pi_norm(fneq), torch.ones_like(rho) / safe,
                          tau, closure)


__all__ = ["normalize_closure", "nu_of_gamma", "tau_eff_from_p",
           "tau_eff", "pi_norm", "closure_constants", "carreau_blood"]
