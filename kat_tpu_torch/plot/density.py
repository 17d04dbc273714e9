"""`kat plot density` — heatmap of a .mx matrix with contour overlays.

Numerics follow reference scripts/kat/plot/density.py so goldens match:
axis limits come from a strided 99.5%-volume scan (the y scan is skipped
for GC matrices, whose full 0..k GC range is always shown) and the color
ceiling from the tallest marginal-peak cell.  The rules live in
`auto_limits` below, pinned numerically by tests/test_plot.py.
"""

from __future__ import annotations

import argparse

import numpy as np

from .misc import correct_filename, findpeaks, readheader, wrap

VOLUME_FRAC = 0.995  # axis scan stops once this much matrix mass is inside
FLOOR = 25           # no axis or color ceiling below this (reference :142)


def _volume_limit(marginal: np.ndarray, total: float) -> int:
    """First index (scanned with the reference's ~40-candidate stride)
    whose prefix holds VOLUME_FRAC of the mass; the full length if none
    does.  The stride quantization is part of the pinned behavior."""
    n = len(marginal)
    step = n // 40 + 1
    cand = np.arange(1, n, step)
    if not cand.size:
        return n
    prefix = np.cumsum(marginal)[cand - 1]
    hits = cand[prefix >= total * VOLUME_FRAC]
    return int(hits[0]) if hits.size else n


def auto_limits(matrix: np.ndarray,
                scan_y: bool) -> tuple[int, int, float]:
    """(xmax, ymax, zmax) for a density heatmap.

    x and y limits: strided prefix-volume scans of the column/row sums
    (y only when scan_y — GC-count axes always show their whole range).
    z limit: 1.1x the largest matrix cell lying on a (row-peak,
    column-peak) crossing, where single-count peaks are ignored; 25 when
    no such crossing exists.  Matches scripts/kat/plot/density.py:114-145
    cell for cell (pinned in tests/test_plot.py)."""
    total = float(matrix.sum())
    col_mass = matrix.sum(axis=0)
    row_mass = matrix.sum(axis=1)

    xmax = _volume_limit(col_mass, total)
    ymax = _volume_limit(row_mass, total) if scan_y else len(row_mass)

    px = findpeaks(col_mass)
    py = findpeaks(row_mass)
    crossings = matrix[np.ix_(py[py != 1], px[px != 1])]
    zmax = float(crossings.max()) * 1.1 if crossings.size else float(FLOOR)
    return xmax, ymax, zmax


def render(matrix, limits, labels, *, contours="normal", rasterised=True,
           width=8, height=6):
    """Draw the heatmap + contour figure; returns the pyplot module so
    the caller controls saving/closing."""
    import matplotlib.pyplot as plt

    xmax, ymax, zmax = limits
    title, x_label, y_label, z_label = labels

    plt.figure(num=None, figsize=(width, height))
    plt.pcolormesh(matrix, vmin=0, vmax=zmax, cmap="viridis",
                   rasterized=rasterised)
    plt.axis([0, xmax, 0, ymax])
    cbar = plt.colorbar()
    cbar.set_label(wrap(z_label))
    cbar.solids.set_rasterized(rasterised)
    if zmax > 0:
        levels = np.arange(zmax / 8, zmax, zmax / 8)
        src = matrix
        if contours == "smooth":
            import scipy.ndimage as ndimage

            src = ndimage.gaussian_filter(matrix, sigma=2.0, order=0)
        if contours in ("normal", "smooth"):
            plt.contour(src, colors="white", alpha=0.6, levels=levels)
    plt.title(wrap(title))
    plt.xlabel(wrap(x_label))
    plt.ylabel(wrap(y_label))
    plt.grid(True, color="white", alpha=0.2)
    plt.tight_layout()
    return plt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Create K-mer Density Plots.")
    parser.add_argument("matrix_file")
    parser.add_argument("-o", "--output", default="kat-density")
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title")
    parser.add_argument("-a", "--x_label")
    parser.add_argument("-b", "--y_label")
    parser.add_argument("-c", "--z_label")
    parser.add_argument("-x", "--x_max", type=int)
    parser.add_argument("-y", "--y_max", type=int)
    parser.add_argument("-z", "--z_max", type=int)
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=int, default=6)
    parser.add_argument("--contours", choices=["none", "normal", "smooth"],
                        default="normal")
    parser.add_argument("--not_rasterised", dest="rasterised",
                        action="store_false", default=True)
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    with open(args.matrix_file) as f:
        header = readheader(f)
        matrix = np.loadtxt(f)
    if header.get("Transpose") == "1":
        matrix = np.transpose(matrix)

    labels = (args.title or header.get("Title", "Density Plot"),
              args.x_label or header.get("XLabel", "X"),
              args.y_label or header.get("YLabel", "Y"),
              args.z_label or header.get("ZLabel", "Z"))

    need_auto = None in (args.x_max, args.y_max, args.z_max)
    if need_auto:
        xmax, ymax, zmax = auto_limits(matrix,
                                       scan_y=labels[2] != "GC count")
    xmax = args.x_max if args.x_max is not None else xmax
    ymax = args.y_max if args.y_max is not None else ymax
    zmax = args.z_max if args.z_max is not None else zmax
    limits = (max(xmax, FLOOR), max(ymax, FLOOR), max(zmax, FLOOR))

    plt = render(matrix, limits, labels, contours=args.contours,
                 rasterised=args.rasterised, width=args.width,
                 height=args.height)
    out = (args.output + "." + args.output_type if args.output_type
           else args.output)
    plt.savefig(correct_filename(out), dpi=args.dpi)
    plt.close()
    return 0


if __name__ == "__main__":
    main()
