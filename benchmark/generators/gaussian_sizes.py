"""The generator ``gaussian_sizes``: a series of noise-free curves from a
traffic file's parameters and ``(seed, frame index)``.

A traffic file names its generator under ``generator``; the harness
loads ``generators/<generator>.py`` and calls its ``FrameSource(traffic,
seed, device)``, whose ``frame(i)`` gives the raw columns of frame *i*
and ``fit_seed(i)`` its fit's seed.

A frame is the intensity of a Gaussian number distribution of one size
parameter, I(q) = Σ_j n(r_j)·Δr_j·F(q, r_j)²·v(r_j)², normalized to a
maximum of 1, with σ = ``rel_sigma``·I, in the raw columns (q in nm⁻¹, I,
σ) of the repository's golden curves.  The basis F²·v² on a log-spaced
grid of ``basis_nodes`` sizes is computed once, in set-up, by the plain
reference's model (``quad_nodes`` orientation nodes where the model
integrates), on the smearing offsets of the traffic's slit where it has
one; a frame is then one weighted sum.

Every seed runs the same set of fits: ``strata`` means, log-uniform over
``mean_nm``, each paired with a relative width uniform over
``rel_width`` (a stratified draw), and each fit's seed from its stratum
and its cycle through the strata; the run's seed sets their order.  (An
MC fit's length depends on its seed: a repetition that stalls is retried
at the cost of a whole attempt, so seeds that chose the fits' seeds
would change the work of a window, not only its order.)

Traffic keys: ``generator``, ``model``, ``size_param``, ``fixed``,
``q_nm`` (a list) or ``q_geomspace_nm`` ([lo, hi, n]), ``mean_nm``,
``rel_width``, ``rel_sigma``, ``data`` (``n_bin``, ``smearing``),
``basis_nodes``, ``quad_nodes``, ``strata``, ``check_fits``.
"""
import math

import numpy as np
import torch

from benchmark.reference import models, prep

SPAN = 5.0         # the basis reaches SPAN widths beyond the extreme means


def q_grid_nm(traffic):
    if "q_nm" in traffic:
        return np.asarray(traffic["q_nm"], np.float64)
    lo, hi, n = traffic["q_geomspace_nm"]
    return np.geomspace(lo, hi, int(n))


def _seed_words(seed, *extra):
    return [int(seed) % 2 ** 64, *extra]


class FrameSource:
    """Frames of one traffic mix for one run seed."""

    def __init__(self, traffic, seed, device="cpu"):
        self.traffic = traffic
        self.seed = int(seed)
        self.q_nm = q_grid_nm(traffic)
        m = int(traffic["strata"])
        lo, hi = traffic["mean_nm"]
        w_lo, w_hi = traffic["rel_width"]
        j = np.arange(m)
        self.means = np.exp(np.log(lo) + (j + 0.5) / m * np.log(hi / lo))
        # a second stratified axis, decorrelated from the first
        k = (j * 7) % m if math.gcd(7, m) == 1 else j[::-1]
        self.widths = w_lo + (k + 0.5) / m * (w_hi - w_lo)
        rng = np.random.default_rng(_seed_words(seed, 1))
        self.order = rng.permutation(m)
        self.radii, self.basis = self._basis(device)

    def _basis(self, device):
        t = self.traffic
        model = models.get(t["model"])
        span = SPAN * max(t["rel_width"][1], 0.02)
        r_lo = t["mean_nm"][0] * (1.0 - span) * 1e-9
        r_hi = t["mean_nm"][1] * (1.0 + span) * 1e-9
        radii = np.geomspace(max(r_lo, 0.05 * t["mean_nm"][0] * 1e-9), r_hi,
                             int(t["basis_nodes"]))
        q = self.q_nm * prep.Q_TO_SI
        fg = prep.derive(np.column_stack([self.q_nm, np.ones_like(q),
                                          np.ones_like(q)]),
                         {**t["data"], "n_bin": 0})
        grid = torch.as_tensor(fg["locs"] if "locs" in fg else q,
                               dtype=torch.float64, device=device)
        p = {**model.DEFAULTS, **t.get("fixed", {})}
        if "quad_nodes" in t:
            p["intDiv"] = int(t["quad_nodes"])
        out = []
        block = max(1, 2 ** 24 // (grid.numel() * int(p.get("intDiv", 1))))
        for i in range(0, len(radii), block):
            r = torch.as_tensor(radii[i:i + block], dtype=torch.float64,
                                device=device)
            pp = dict(p)
            pp[t["size_param"]] = r.reshape((-1,) + (1,) * grid.dim())
            f = model.ff(grid, pp)
            it = f * f
            if "locs" in fg:
                it = it @ torch.as_tensor(fg["smear_w"], dtype=torch.float64,
                                          device=device)
            pv = dict(pp)
            pv[t["size_param"]] = r
            v = torch.as_tensor(model.volume(pv), dtype=torch.float64,
                                device=device)
            out.append((it * (v * v)[:, None]).cpu().numpy())
        return radii, np.concatenate(out)

    def stratum(self, i):
        """The stratum of frame *i*: i ≥ 0 are the measured sequence,
        i < 0 the warm-up frames outside it."""
        m = len(self.order)
        return int(self.order[i % m]) if i >= 0 else int((-i * 5) % m)

    def fit_seed(self, i):
        """The fit's seed of frame *i*: 31 bits from its stratum and its
        cycle through the strata (warm-up frames apart), not from the run's
        seed, so that every seed runs the same set of fits in its own
        order."""
        cycle = i // len(self.order) if i >= 0 else -1
        s = np.random.SeedSequence([2, self.stratum(i), cycle % 2 ** 32,
                                    int(i < 0)])
        return int(s.generate_state(1)[0] & 0x7FFFFFFF)

    def frame(self, i):
        """The raw columns (q nm⁻¹, I, σ) of frame *i*."""
        j = self.stratum(i)
        mu, s = self.means[j] * 1e-9, self.widths[j] * self.means[j] * 1e-9
        r = self.radii
        dr = np.gradient(r)
        if s > 0.0:
            n = np.exp(-0.5 * ((r - mu) / s) ** 2) * dr
        else:
            n = np.zeros_like(r)
        if not n.sum() > 0.0:      # narrower than the basis: its nearest
            n = np.zeros_like(r)
            n[np.argmin(np.abs(r - mu))] = 1.0
        i_q = (n / n.sum()) @ self.basis
        i_q = i_q / i_q.max()
        return np.column_stack([self.q_nm, i_q,
                                self.traffic["rel_sigma"] * i_q])
