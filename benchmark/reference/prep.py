"""The preprocessing of a raw frame (q in nm⁻¹, I, σ), as upstream McSAS
documents it: SI units, the uncertainty floor, log-spaced rebinning and
slit smearing.  Float64 numpy."""
import math

import numpy as np

Q_TO_SI = 1e9          # nm⁻¹ → m⁻¹; the intensity (m sr)⁻¹ is SI already


def rebin_log(q, f, fu, n_bin):
    """At most *n_bin* log-spaced bins; a bin's σ is the larger of the
    standard error of its mean and its propagated uncertainty."""
    edges = np.logspace(np.log10(q.min()),
                        np.log10(q.max() + np.diff(q)[-1] / 100.0), n_bin + 1)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (q >= lo) & (q < hi)
        n = int(m.sum())
        if n == 1:
            out.append((q[m][0], f[m][0], fu[m][0]))
        elif n > 1:
            sem = f[m].std(ddof=1) / math.sqrt(n)
            out.append((q[m].mean(), f[m].mean(),
                        max(sem, math.sqrt((fu[m] ** 2).sum() / n))))
    return tuple(np.array(c) for c in zip(*out))


def slit(q, smearing):
    """(locs (Nq, 1 + n), weights (1 + n,)) of a trapezoidal slit: offsets
    0 and n log-spaced from min(q)/5 to penumbra/2, the half-trapezoid
    profile normalized to 1/2 over x > 0, the trapezoid rule, times 2;
    the smeared intensity is (I(locs)) @ weights."""
    c, d = smearing["umbra"], smearing["penumbra"]
    off = np.concatenate(([0.0], np.logspace(math.log10(q.min() / 5.0),
                                             math.log10(d / 2.0),
                                             smearing["n_steps"])))
    x = np.abs(off)
    pdf = np.where(x < c, 1.0, np.where(x < d, (d - x) / (d - c), 0.0))
    pdf = pdf / (d + c)
    dx = np.diff(off)
    trap = np.zeros_like(off)
    trap[:-1] += 0.5 * dx
    trap[1:] += 0.5 * dx
    return np.sqrt(np.add.outer(q ** 2, off ** 2)), 2.0 * trap * pdf


def derive(raw, data_cfg):
    """The fit grid of a raw frame under *data_cfg* (``n_bin``,
    ``fu_min``, ``smearing``): dict of q (SI), y, sigma and, when smeared,
    locs and smear_w."""
    raw = np.asarray(raw, np.float64)
    q = raw[:, 0] * Q_TO_SI
    f = raw[:, 1]
    fu = np.maximum(raw[:, 2], data_cfg.get("fu_min", 0.01) * f)
    ok = np.isfinite(f)
    q, f, fu = q[ok], f[ok], fu[ok]
    n_bin = data_cfg.get("n_bin", 100)
    if n_bin > 0:
        q, f, fu = rebin_log(q, f, fu, n_bin)
    out = {"q": q, "y": f, "sigma": fu}
    if data_cfg.get("smearing"):
        out["locs"], out["smear_w"] = slit(q, data_cfg["smearing"])
    return out
