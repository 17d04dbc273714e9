"""`kat plot spectra-hist` — line plot of one or more histogram files.

Behavioral re-implementation of reference scripts/kat/plot/spectra_hist.py,
with its 99.9%-volume x-limit and peak-derived y-limit heuristics.
"""

from __future__ import annotations

import argparse

import numpy as np

from .misc import correct_filename, findpeaks, readheader, wrap

COLOURS = ["#cc0000", "#75507b", "#3465a4", "#73d216", "#c17d11",
           "#f57900", "#edd400"]


def auto_limits(xs: list, ys: list) -> tuple[int, float]:
    """(xmax, ymax) per the reference's 99.9%-volume rule (reference
    scripts/kat/plot/spectra_hist.py:84-103): per histogram, the x limit
    is the first frequency (stepping by len/1000+1) whose cumulative
    distinct-k-mer volume reaches 99.9%, the y limit 1.1x the tallest
    non-1-frequency peak; the max over all histograms wins."""
    xmax = list(map(len, xs))
    ysum = list(map(np.sum, ys))
    ymax = list(map(np.max, ys))
    for i in range(len(xs)):
        peakx = findpeaks(ys[i])
        peakx = peakx[peakx != 1]
        peaky = ys[i][peakx]
        for j in range(1, xmax[i], int(xmax[i] / 1000) + 1):
            if np.sum(ys[i][:j]) >= ysum[i] * 0.999:
                xmax[i] = j
                break
        if peaky.size:
            ymax[i] = np.max(peaky) * 1.1
    return max(xmax), max(ymax)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Creates K-mer spectra plots from one or more "
                    "histogram files.")
    parser.add_argument("histo_files", nargs="+")
    parser.add_argument("-o", "--output", default="kat-spectra-hist")
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title")
    parser.add_argument("-a", "--x_label")
    parser.add_argument("-b", "--y_label")
    parser.add_argument("-r", "--x_min", type=int, default=0)
    parser.add_argument("-s", "--y_min", type=int, default=0)
    parser.add_argument("-x", "--x_max", type=int)
    parser.add_argument("-y", "--y_max", type=int)
    parser.add_argument("-u", "--legend_labels")
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=int, default=6)
    parser.add_argument("-m", "--x_logscale", action="store_true")
    parser.add_argument("-n", "--y_logscale", action="store_true")
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib.pyplot as plt

    headers, x, y = [], [], []
    for histo_file in args.histo_files:
        with open(histo_file) as f:
            header = readheader(f)
            matrix = np.loadtxt(f)
        headers.append(header)
        x.append(matrix[:, 0])
        y.append(matrix[:, 1])

    title = args.title or headers[0].get("Title", "Spectra Histogram Plot")
    x_label = args.x_label or headers[0].get("XLabel", "X")
    y_label = args.y_label or headers[0].get("YLabel", "Y")

    if args.x_max is None or args.y_max is None:
        xmax, ymax = auto_limits(x, y)

    if args.x_max is not None:
        xmax = args.x_max
    if args.y_max is not None:
        ymax = args.y_max
    xmax = max(xmax, 25)
    ymax = max(ymax, 25)

    plt.figure(num=None, figsize=(args.width, args.height))
    legend_labels = (args.legend_labels.split(",")
                     if args.legend_labels else [])
    labels = (legend_labels if len(legend_labels) >= len(x)
              else [s.split("/")[-1] for s in args.histo_files])
    for xt, yt, lb, i in zip(x, y, labels, range(len(x))):
        plt.plot(xt, yt, "o-", label=lb, color=COLOURS[i % len(COLOURS)],
                 markersize=3)
    if args.x_logscale:
        plt.xscale("log")
    if args.y_logscale:
        plt.yscale("log")
    plt.axis([args.x_min, xmax, args.y_min, ymax])
    plt.title(wrap(title))
    plt.xlabel(wrap(x_label))
    plt.ylabel(wrap(y_label))
    plt.grid(True, color="black", alpha=0.2)
    if len(x) > 1:
        plt.legend(loc=1)
    plt.tight_layout()

    out = (args.output + "." + args.output_type if args.output_type
           else args.output)
    plt.savefig(correct_filename(out), dpi=args.dpi)
    plt.close()
    return 0


if __name__ == "__main__":
    main()
