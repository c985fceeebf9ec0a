"""Corner (pair) plots of posterior samples — a self-contained replacement for
the ``corner`` package used by the reference (fitting.py:253, bolometric.py:233).

Produces the same figure structure the reference relies on downstream:
``fig.get_axes()`` returns exactly ndim*ndim axes reshapeable to (ndim, ndim),
with 1-D histograms on the diagonal, 2-D density + contours below it, and
hidden (but present) axes above it.
"""

import numpy as np
from scipy.ndimage import gaussian_filter

__all__ = ["corner"]

# contour levels at 0.5, 1, 1.5, 2 sigma of a 2-D Gaussian (corner's default)
_LEVELS = 1.0 - np.exp(-0.5 * np.array([0.5, 1.0, 1.5, 2.0]) ** 2)


def corner(xs, labels=None, label_kwargs=None, bins=20, color="k",
           quantiles=None, fig=None, truths=None, truth_color="#4682b4",
           **kwargs):
    """Corner plot of ``xs`` (nsamples, ndim). ``truths`` draws reference
    lines/points at the given parameter values (corner-package semantics).
    Other corner-package options are not implemented: unknown keywords warn
    loudly instead of silently rendering nothing."""
    if kwargs:
        import warnings
        warnings.warn(f"corner() ignoring unsupported option(s) "
                      f"{sorted(kwargs)}: this self-contained replacement "
                      "implements labels/bins/color/quantiles/fig/truths only")
    xs = np.asarray(xs, float)
    if xs.ndim == 1:
        # (N,) means N samples of ONE parameter (corner-package semantics:
        # a single histogram), not a 1 x N chain
        xs = xs[:, None]
    if xs.ndim != 2:
        raise ValueError("samples must be 2-D (nsamples, ndim)")
    ndim = xs.shape[1]
    label_kwargs = label_kwargs or {}
    if truths is not None and len(truths) != ndim:
        raise ValueError(f"truths must have {ndim} entries")

    if fig is None:
        factor = 2.0
        lbdim = 0.5 * factor
        trdim = 0.2 * factor
        plotdim = factor * ndim + factor * (ndim - 1.0) * 0.05
        dim = lbdim + plotdim + trdim
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(ndim, ndim, figsize=(dim, dim))
        lb = lbdim / dim
        tr = (lbdim + plotdim) / dim
        fig.subplots_adjust(left=lb, bottom=lb, right=tr, top=tr, wspace=0.05, hspace=0.05)
    else:
        axes = np.array(fig.get_axes()).reshape(ndim, ndim)
    axes = np.atleast_2d(axes).reshape(ndim, ndim)

    ranges = []
    for d in range(ndim):
        lo, hi = np.min(xs[:, d]), np.max(xs[:, d])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        pad = 0.05 * (hi - lo)
        ranges.append((lo - pad, hi + pad))

    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:  # upper triangle hidden but present
                ax.set_frame_on(False)
                ax.set_xticks([])
                ax.set_yticks([])
                continue
            if i == j:
                ax.hist(xs[:, i], bins=bins, range=ranges[i], histtype="step", color=color)
                if quantiles:
                    for q in np.percentile(xs[:, i], 100.0 * np.asarray(quantiles)):
                        ax.axvline(q, ls="dashed", color=color)
                if truths is not None and truths[i] is not None:
                    ax.axvline(truths[i], color=truth_color)
                ax.set_xlim(ranges[i])
                ax.set_yticks([])
            else:
                _hist2d(ax, xs[:, j], xs[:, i], ranges[j], ranges[i], bins, color)
                if truths is not None:
                    if truths[j] is not None:
                        ax.axvline(truths[j], color=truth_color)
                    if truths[i] is not None:
                        ax.axhline(truths[i], color=truth_color)
                    if truths[j] is not None and truths[i] is not None:
                        ax.plot(truths[j], truths[i], "s", color=truth_color)
            # tick/label housekeeping (labels only on the outer edge)
            if i < ndim - 1:
                ax.set_xticklabels([])
            else:
                for lab in ax.get_xticklabels():
                    lab.set_rotation(45)
                if labels is not None:
                    ax.set_xlabel(labels[j], **label_kwargs)
                    ax.xaxis.set_label_coords(0.5, -0.35)
            if j > 0 or i == 0:
                ax.set_yticklabels([])
            else:
                for lab in ax.get_yticklabels():
                    lab.set_rotation(45)
                if labels is not None:
                    ax.set_ylabel(labels[i], **label_kwargs)
                    ax.yaxis.set_label_coords(-0.35, 0.5)
    return fig


def _hist2d(ax, x, y, xrange, yrange, bins, color):
    H, xe, ye = np.histogram2d(x, y, bins=bins, range=[xrange, yrange])
    Hs = gaussian_filter(H, 1.0)
    # contour levels containing the _LEVELS mass fractions
    flat = np.sort(Hs.ravel())[::-1]
    csum = np.cumsum(flat)
    csum = csum / csum[-1] if csum[-1] > 0 else csum
    levels = []
    for frac in _LEVELS:
        idx = np.searchsorted(csum, frac)
        levels.append(flat[min(idx, len(flat) - 1)])
    levels = sorted(set(float(l) for l in levels if l > 0))
    xc = 0.5 * (xe[1:] + xe[:-1])
    yc = 0.5 * (ye[1:] + ye[:-1])
    # grey density + scatter of points outside the outer contour
    ax.pcolormesh(xe, ye, Hs.T, cmap="Greys", shading="auto", rasterized=True)
    if levels:
        try:
            ax.contour(xc, yc, Hs.T, levels=levels, colors=color, linewidths=0.8)
        except ValueError:
            pass
    ax.set_xlim(xrange)
    ax.set_ylim(yrange)
