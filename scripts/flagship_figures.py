#!/usr/bin/env python
"""Regenerate the flagship posterior figures from a saved sample stack.

Reads ``flagship_samples.npz`` (written by ``scripts/rgc_flagship.py``) and
writes to ``<resultsDir>/figures/``:

- ``network_posterior.png`` — true A∘W vs posterior-mean coupling vs edge
  posterior P(A_ij | data), the paper's qualitative headline comparison.
- ``latent_locations.png`` — Procrustes-aligned posterior draws of the
  latent locations vs the generating configuration. Raw draws carry an
  arbitrary orientation (the distance posterior is rotation/reflection
  invariant, and the sampler mixes that orbit exactly —
  ``inference/gibbs.update_latent_rotation``), so every draw is aligned to
  the true locations with the orthogonal Procrustes solution before
  plotting (``plotting.procrustes_align``; Schönemann 1966).

  python scripts/flagship_figures.py [-r results/rgc_flagship]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--resultsDir", "-r", type=str, default="results/rgc_flagship")
    p.add_argument("--n_loc_draws", type=int, default=200,
                   help="posterior location draws to scatter (thinned evenly)")
    args = p.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from theano_pyglm_tpu.plotting import plot_network, procrustes_align

    z = np.load(os.path.join(args.resultsDir, "flagship_samples.npz"))
    A = z["samples/A"]          # (n, C, N, N)
    W = z["samples/W"]
    locs = z["samples/locs"]    # (n, C, N, D)
    A_true, W_true = z["true_params/A"], z["true_params/W"]
    locs_true = z["true_params/locs"]
    figdir = os.path.join(args.resultsDir, "figures")
    os.makedirs(figdir, exist_ok=True)

    # --- network recovery -------------------------------------------------
    G_post = (A * W).mean(axis=(0, 1))
    P_edge = A.mean(axis=(0, 1))
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    plot_network(axes[0], A_true * W_true, "true A∘W")
    plot_network(axes[1], G_post, "posterior mean A∘W")
    im = axes[2].imshow(P_edge, cmap="viridis", vmin=0, vmax=1)
    axes[2].set_title("edge posterior P(A|data)")
    axes[2].set_xlabel("presynaptic")
    axes[2].set_ylabel("postsynaptic")
    fig.colorbar(im, ax=axes[2], fraction=0.046)
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "network_posterior.png"), dpi=110)
    plt.close(fig)

    # --- latent locations --------------------------------------------------
    n, C, N, D = locs.shape
    stride = max(1, (n * C) // args.n_loc_draws)
    draws = locs.reshape(n * C, N, D)[::stride]
    aligned = np.stack([procrustes_align(x, locs_true) for x in draws])
    fig, ax = plt.subplots(figsize=(6, 6))
    colors = plt.cm.tab20(np.arange(N) % 20)
    for i in range(N):
        ax.scatter(aligned[:, i, 0], aligned[:, i, 1], s=5, alpha=0.25,
                   color=colors[i], linewidths=0)
    ax.scatter(locs_true[:, 0], locs_true[:, 1], s=90, marker="x",
               color="black", label="true", zorder=3)
    ax.set_title(
        f"latent-location posterior ({aligned.shape[0]} draws, "
        "Procrustes-aligned to truth)"
    )
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "latent_locations.png"), dpi=110)
    plt.close(fig)
    print(f"wrote {figdir}/network_posterior.png and latent_locations.png")


if __name__ == "__main__":
    main()
