"""Independent float64 numpy oracle of the model density.

A slow, first-principles implementation of the log-joint that shares no code
with the JAX model: the currents, the likelihood and every prior are written
out again in numpy/scipy. The tests hold the jitted log-joint to it at 1e-6
(float64 on the CPU), and ``chip_smoke.py`` holds the float32 log-joint on
the card to it. Gradients come from central differences of the same
function, so they are independent of JAX's autodiff too.

Imports nothing from JAX, so it can run beside a process that owns the card.
"""

from __future__ import annotations

import numpy as np
import scipy.special as sp
import scipy.stats as st

__all__ = ["numpy_log_joint", "central_difference_grad"]


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def numpy_log_joint(pop, params, data):
    """Slow, independent numpy implementation of the model density.

    ``pop`` supplies only the spec and the bin width; ``params`` and ``data``
    are read as float64 numpy arrays.
    """
    spec = pop.spec
    S = np.asarray(data["S"], np.float64)
    T, N = S.shape
    dt = pop.dt
    p = {k: np.asarray(v) for k, v in params.items()}
    p = {k: (v.astype(np.float64) if v.dtype.kind == "f" else v) for k, v in p.items()}

    # --- currents
    I = np.tile(p["bias"], (T, 1))
    if "w_stim" in p:
        I = I + np.asarray(data["X_stim"], np.float64) @ p["w_stim"].T
    if "w_stim_s" in p:
        X = np.asarray(data["X_st"], np.float64)
        I = I + np.einsum("tdb,nd,nb->tn", X, p["w_stim_s"], p["w_stim_t"])
    w_eff = p["w_ir"]
    if spec["impulse"]["type"] == "normalized":
        w_eff = _softmax(w_eff)
    W = p.get("W")
    if W is None:
        W = np.full((N, N), float(spec["network"]["weight"].get("value", 1.0)))
    G = p["A"] * W
    # prepare_data centers the design columns; undo it here so the oracle
    # computes from first principles
    X_imp = np.asarray(data["X_imp"], np.float64) + np.asarray(
        data["_X_imp_mean"], np.float64
    )[None]
    X_flat = X_imp.reshape(T, -1)  # (T, N_pre·B)
    for n in range(N):
        # I[:, n] += Σ_m G[n, m] · (X_imp[:, m, :] @ w_eff[n, m, :])
        I[:, n] += X_flat @ (G[n][:, None] * w_eff[n]).reshape(-1)

    # --- likelihood
    if spec["nlin"]["type"] == "exp":
        # The model spec is the CLIPPED exp: λ = exp(clip(I, ±40)) with
        # log λ = clip(I, ±40) on the combined exponent (ops/clipping.py).
        # The oracle hardcodes the constant independently so a drift of the
        # library's EXP_CLIP away from the documented spec fails here.
        Ic = np.clip(I, -40.0, 40.0)
        rate = np.exp(Ic)
        log_rate = Ic
    else:
        rate = np.logaddexp(0.0, I)
        log_rate = np.log(rate)
    if spec["observation"]["type"] == "poisson":
        ll = S * (log_rate + np.log(dt)) - rate * dt - sp.gammaln(S + 1.0)
    else:
        prob = -np.expm1(-np.clip(rate * dt, 1e-10, None))
        ll = S * np.log(prob) + (1 - S) * (-rate * dt)
    total = ll.sum()

    # --- priors
    b = spec["bias"]
    total += st.norm.logpdf(p["bias"], b["mu"], b["sigma"]).sum()
    if "w_stim" in p:
        s = spec["bkgd"]
        total += st.norm.logpdf(p["w_stim"], s["mu"], s["sigma"]).sum()
    if "w_stim_s" in p:
        s = spec["bkgd"]
        total += st.norm.logpdf(p["w_stim_s"], s["mu"], s["sigma"]).sum()
        total += st.norm.logpdf(p["w_stim_t"], s["mu"], s["sigma"]).sum()
    im = spec["impulse"]
    total += st.norm.logpdf(p["w_ir"], im["mu"], im["sigma"]).sum()

    g = spec["network"]["graph"]
    if g["type"] == "erdos_renyi":
        rho = p.get("rho", g.get("rho", 0.2))
        total += st.bernoulli.logpmf(p["A"].astype(int), rho).sum()
    elif g["type"] == "sbm":
        y, pi, Bm = p["y"].astype(int), p["pi"], p["Bm"]
        K = Bm.shape[0]
        # Dirichlet log-density written out: scipy's validator rejects a
        # float32 draw whose float64 sum is 1 ± 1e-7
        alpha = g["alpha0"] * np.ones(K)
        total += sp.gammaln(alpha.sum()) - sp.gammaln(alpha).sum()
        total += ((alpha - 1.0) * np.log(pi)).sum()
        total += np.log(pi[y]).sum()
        total += st.beta.logpdf(Bm, *g.get("B_prior", (1.0, 1.0))).sum()
        P = Bm[y[:, None], y[None, :]]
        total += st.bernoulli.logpmf(p["A"].astype(int), P).sum()
    elif g["type"] == "distance":
        locs = p["locs"]
        total += st.norm.logpdf(locs, 0.0, g["sigma_l"]).sum()
        d2 = ((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1)
        P = 1.0 / (1.0 + np.exp(-(g["eta0"] - d2 / g["tau"] ** 2)))
        total += st.bernoulli.logpmf(p["A"].astype(int), np.clip(P, 1e-12, 1 - 1e-12)).sum()

    w = spec["network"]["weight"]
    if w["type"] == "gaussian":
        eye = np.eye(N)
        MU = w["mu"] * (1 - eye) + w.get("mu_self", w["mu"]) * eye
        SIG = w["sigma"] * (1 - eye) + w.get("sigma_self", w["sigma"]) * eye
        total += st.norm.logpdf(p["W"], MU, SIG).sum()
    return float(total)


def central_difference_grad(pop, params, data, coords, h: float = 1e-4):
    """Central differences of :func:`numpy_log_joint` at ``coords``.

    ``coords`` is a list of ``(leaf, flat_index)`` pairs; returns a float64
    array with one derivative per pair, in that order. Truncation error is
    O(h²·f'''), round-off O(eps·|f|/h): at the flagship shape (|f| ~ 1e5)
    h = 1e-4 keeps both near 1e-6.
    """
    base = {k: np.array(v, dtype=np.float64) if np.asarray(v).dtype.kind == "f"
            else np.asarray(v) for k, v in params.items()}
    out = np.empty(len(coords))
    for i, (leaf, idx) in enumerate(coords):
        x0 = base[leaf].reshape(-1)[idx]
        vals = []
        for sign in (1.0, -1.0):
            p = dict(base)
            p[leaf] = base[leaf].copy()
            p[leaf].reshape(-1)[idx] = x0 + sign * h
            vals.append(numpy_log_joint(pop, p, data))
        out[i] = (vals[0] - vals[1]) / (2 * h)
    return out
