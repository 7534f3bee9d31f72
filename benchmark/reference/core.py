"""The program's outputs worked out again in float64 (or, for the
control, with every stage rounded to a lower precision).

Given a frame's fit grid (:func:`prep.derive`), a configuration and the
contributions (R, N, P) the program returned:

* :func:`engine_outputs`: what the MC engine reports with them: χ² per
  repetition, the scaling (SI) and the background of the weighted least
  squares y ≈ A·Σ I_j + b, with I_j = F(q, p_j)²·v(p_j)^(2c), on the
  rule the MC evaluates (``engine_params`` of the model);
* :func:`post_outputs`: what the post pass reports: the same solve on the
  model's own rule, the fitted curve, the volume fractions w·A/v_abs and
  the default histogram (volume-weighted, 50 linear bins over the active
  range);
* :func:`judge`: the gaps between two such sets of outputs.

χ² is reduced by the number of fit points; the solve has a background
unless the configuration says otherwise.
"""
import numpy as np
import torch

from . import models

F64 = torch.float64
# float64 values one block of rows may hold at once (contributions × grid
# points × quadrature nodes)
BLOCK_VALUES = 2 ** 25


def exact(t):
    return t


def bfloat16(t):
    """The control's rounding: each stage's result stored in bfloat16."""
    return t.to(torch.bfloat16).to(F64)


def _params(model, cfg, rset, engine):
    """The parameter dict of contributions *rset* (..., P)."""
    p = {**model.DEFAULTS, **cfg["fixed"]}
    if engine:
        p = model.engine_params(p)
    for i, name in enumerate(cfg["active"]):
        p[name] = rset[..., i]
    return p


def rows(cfg, grid, contribs, engine, rnd=exact, device="cpu"):
    """(R, N, Nq) intensities F²·v^(2c) of *contribs* (R, N, P) on *grid*
    (the fit grid's q, SI; or the smeared data's (locs, smear_w)), in
    blocks of contributions."""
    model = models.get(cfg["model"])
    comp2 = 2.0 * cfg.get("compensationExponent", 0.6666666)
    smeared = isinstance(grid, tuple)
    q = torch.as_tensor(grid[0] if smeared else grid, dtype=F64,
                        device=device)
    sw = (torch.as_tensor(grid[1], dtype=F64, device=device)
          if smeared else None)
    rset = torch.as_tensor(np.asarray(contribs, np.float64), device=device)
    flat = rset.reshape(-1, rset.shape[-1])
    nodes = int(_params(model, cfg, flat[:1], engine).get("intDiv", 1))
    block = max(1, BLOCK_VALUES // (q.numel() * nodes))
    out = []
    for i in range(0, flat.shape[0], block):
        part = flat[i:i + block]
        lead = part[:, None, None, :] if smeared else part[:, None, :]
        f = rnd(model.ff(q, _params(model, cfg, lead, engine)))
        it = rnd(f * f)
        if smeared:
            it = rnd(it @ sw)
        w = rnd(model.volume(_params(model, cfg, part[:, None, :], engine))
                ** comp2)
        out.append(rnd(it * w))
    return torch.cat(out).reshape(*rset.shape[:2], -1)


def solve(ft, y, sigma, cfg, rnd=exact):
    """(A, b, χ²) per repetition of y ≈ A·ft + b weighted by 1/σ², for
    ft (R, Nq)."""
    dev = ft.device
    y = rnd(torch.as_tensor(y, dtype=F64, device=dev))
    sig = torch.as_tensor(sigma, dtype=F64, device=dev)
    u = rnd(1.0 / torch.where(sig == 0.0, torch.ones_like(sig), sig) ** 2)
    norm = ft.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    x = rnd(ft / norm)
    s_u, s_uy = rnd(u.sum()), rnd((u * y).sum())
    s_x = rnd((u * x).sum(-1))
    s_xx = rnd((u * x * x).sum(-1))
    s_xy = rnd((u * x * y).sum(-1))
    a0 = rnd(s_xy / s_xx)
    if cfg.get("findBackground", True):
        a = rnd((s_u * s_xy - s_x * s_uy) / rnd(s_u * s_xx - s_x * s_x))
        b = rnd((s_uy - a * s_x) / s_u)
        if cfg.get("positiveBackground", False):
            neg = b < 0.0
            a = torch.where(neg, a0, a)
            b = b.clamp_min(0.0)
    else:
        a, b = a0, torch.zeros_like(a0)
    r = rnd(y - rnd(a[:, None] * x) - b[:, None])
    chi2 = rnd(rnd(u * r * r).sum(-1)) / y.shape[0]
    return a / norm[:, 0], b, chi2


def _grid(fg):
    return (fg["locs"], fg["smear_w"]) if "locs" in fg else fg["q"]


def engine_outputs(cfg, fg, contribs, rnd=exact, device="cpu"):
    """χ², scaling (SI) and background per repetition, as the MC reports
    them for *contribs* on fit grid *fg*."""
    ft = rnd(rows(cfg, _grid(fg), contribs, True, rnd, device).sum(1))
    a, b, chi2 = solve(ft, fg["y"], fg["sigma"], cfg, rnd)
    return {"conval": chi2.cpu().numpy(), "scaling": a.cpu().numpy(),
            "background": b.cpu().numpy()}


def post_outputs(cfg, fg, contribs, rnd=exact, device="cpu"):
    """The post pass's scaling and fitted curve (R, Nq), the volume
    fractions (N, R) and the default histogram's bins (50, R)."""
    model = models.get(cfg["model"])
    comp2 = 2.0 * cfg.get("compensationExponent", 0.6666666)
    bank = rows(cfg, _grid(fg), contribs, False, rnd, device)
    ft = rnd(bank.sum(1))
    a, b, _ = solve(ft, fg["y"], fg["sigma"], cfg, rnd)
    measval = rnd(a[:, None] * ft + b[:, None])
    rset = torch.as_tensor(np.asarray(contribs, np.float64), device=device)
    p = _params(model, cfg, rset, False)
    w = rnd(model.volume(p) ** comp2)
    vf = rnd(w * a[:, None] / rnd(torch.as_tensor(
        model.absvolume(p), dtype=F64, device=device)))
    vf = vf.cpu().numpy().T                                 # (N, R)
    return {"scaling": np.stack([a.cpu().numpy(), b.cpu().numpy()]),
            "measval": measval.cpu().numpy(), "vol_fraction": vf,
            "hist": histogram(cfg, contribs, vf, rnd)}


def histogram(cfg, contribs, vf, rnd=exact, bins=50):
    """Volume-fraction sums (bins, R) of the first active parameter over
    *bins* linear bins of its active range."""
    lo, hi = cfg["activeRanges"][cfg["active"][0]]
    edges = np.linspace(lo, hi, bins + 1)
    values = np.asarray(contribs, np.float64)[:, :, 0].T    # (N, R)
    idx = np.digitize(values, edges) - 1
    out = np.zeros((bins, values.shape[1]))
    for r in range(values.shape[1]):
        ok = (idx[:, r] >= 0) & (idx[:, r] < bins)
        np.add.at(out[:, r], idx[ok, r], vf[ok, r])
    return rnd(torch.as_tensor(out)).numpy()


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1e-300)))


def _scaled(a, b):
    """max |a − b| over max |b| of each repetition's column."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b).max(0)
                        / np.maximum(np.abs(b).max(0), 1e-300)))


def judge(out, ref, fg, judged):
    """The gaps of outputs *out* against the reference's *ref* (both with
    ``engine`` and ``post`` dicts): χ², scaling and background of the MC
    over the repetitions *judged* (the ones the program reports converged:
    upstream shows no others), and the post pass's curve, scaling,
    fractions and histogram over all.  None for the MC's gaps where no
    repetition is judged."""
    e, re_ = out["engine"], ref["engine"]
    p, rp = out["post"], ref["post"]
    sigma = np.asarray(fg["sigma"])
    m = np.asarray(judged, bool)
    gaps = {"chi2_gap": None, "scale_gap": None, "bg_gap": None}
    if m.any():
        gaps = {
            "chi2_gap": _rel(e["conval"][m], re_["conval"][m]),
            "scale_gap": _rel(e["scaling"][m], re_["scaling"][m]),
            "bg_gap": float(np.max(np.abs(e["background"][m]
                                          - re_["background"][m]))
                            / sigma.min())}
    gaps["post_gap"] = max(
        _rel(p["scaling"][0], rp["scaling"][0]),
        float(np.max(np.abs(p["scaling"][1] - rp["scaling"][1]))
              / sigma.min()),
        float(np.max(np.abs(p["measval"] - rp["measval"]) / sigma)),
        _scaled(p["vol_fraction"], rp["vol_fraction"]),
        _scaled(p["hist"], rp["hist"]))
    return gaps


def reference(cfg, fg, contribs, rnd=exact, device="cpu"):
    """Both sets of outputs for *contribs*: the reference (``rnd`` exact)
    or the control in the program's place (a lower precision)."""
    return {"engine": engine_outputs(cfg, fg, contribs, rnd, device),
            "post": post_outputs(cfg, fg, contribs, rnd, device)}
