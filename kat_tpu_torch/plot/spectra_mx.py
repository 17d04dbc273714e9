"""`kat plot spectra-mx` — line plots of selected rows/columns of a matrix,
or the shared/exclusive-content decomposition of a comp matrix.

Behavioral re-implementation of reference scripts/kat/plot/spectra_mx.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .misc import correct_filename, findpeaks, readheader, wrap
from .spectra_hist import COLOURS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Creates K-mer spectra plots from rows or columns of a "
                    "matrix file.")
    parser.add_argument("matrix_file")
    parser.add_argument("-o", "--output", default="kat-spectra-mx")
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title", default="Spectra MX Plot")
    parser.add_argument("-a", "--x_label")
    parser.add_argument("-b", "--y_label")
    parser.add_argument("-r", "--x_min", type=int, default=0)
    parser.add_argument("-s", "--y_min", type=int, default=0)
    parser.add_argument("-x", "--x_max", type=int)
    parser.add_argument("-y", "--y_max", type=int)
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=int, default=6)
    parser.add_argument("-i", "--intersection", action="store_true")
    parser.add_argument("-c", "--list")
    parser.add_argument("-e", "--exc_cutoff_d1", type=int, default=1)
    parser.add_argument("-f", "--exc_cutoff_d2", type=int, default=1)
    parser.add_argument("-m", "--x_logscale", action="store_true")
    parser.add_argument("-n", "--y_logscale", action="store_true")
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib.pyplot as plt

    with open(args.matrix_file) as f:
        header = readheader(f)
        matrix = np.loadtxt(f)
    if header.get("Transpose") == "1":
        matrix = np.transpose(matrix)

    title = args.title or header.get("Title", "Density Plot")
    x_label = args.x_label or "k-mer multiplicity"
    y_label = args.y_label or "Number of distinct k-mers"

    x, y, labels = [], [], []
    if args.list is not None:
        rowscols = []
        try:
            for token in args.list.split(","):
                if token[0] in "rc":
                    rowscols.append((token[0], int(token[1:])))
                else:
                    raise ValueError()
        except ValueError:
            sys.exit("Malformed string given as --list: " + args.list)
        for kind, idx in rowscols:
            if kind == "r":
                y.append(matrix[idx, :])
                x.append(np.arange(len(matrix[idx, :])))
                labels.append(f"Row {idx}")
            else:
                y.append(matrix[:, idx])
                x.append(np.arange(len(matrix[:, idx])))
                labels.append(f"Column {idx}")
    elif args.intersection:
        c1, c2 = args.exc_cutoff_d1, args.exc_cutoff_d2
        y_exc_d1 = np.sum(matrix[:c1, :], 0)
        y_sha_d1 = np.sum(matrix[c1:, c2:], 0)
        y_exc_d2 = np.transpose(np.sum(matrix[:, :c2], 1))
        y_sha_d2 = np.transpose(np.sum(matrix[c1:, c2:], 1))
        x = [np.arange(len(y_exc_d1)),
             np.arange(c2, len(y_exc_d1)),
             np.arange(len(y_exc_d2)),
             np.arange(c1, len(y_exc_d2))]
        y = [y_exc_d1, y_sha_d1, y_exc_d2, y_sha_d2]
        labels = ["Dataset 1 exclusive content", "Dataset 1 shared content",
                  "Dataset 2 exclusive content", "Dataset 2 shared content"]
    else:
        sys.exit("Error: Either --list or --intersection must be given.")

    if args.x_max is None or args.y_max is None:
        xmax = list(map(len, x))
        ysum = list(map(np.sum, y))
        ymax = list(map(np.max, y))
        for i in range(len(x)):
            peakx = findpeaks(y[i])
            peakx = peakx[peakx != 1]
            peaky = y[i][peakx]
            for j in range(1, xmax[i], int(xmax[i] / 1000) + 1):
                if np.sum(y[i][:j]) >= ysum[i] * 0.999:
                    xmax[i] = j
                    break
            if peaky.size:
                ymax[i] = np.max(peaky) * 1.1
        xmax = max(xmax)
        ymax = max(ymax)

    if args.x_max is not None:
        xmax = args.x_max
    if args.y_max is not None:
        ymax = args.y_max
    xmax = max(xmax, 25)
    ymax = max(ymax, 25)

    plt.figure(num=None, figsize=(args.width, args.height))
    for xt, yt, lb, i in zip(x, y, labels, range(len(x))):
        plt.plot(xt, yt, label=lb, color=COLOURS[i % len(COLOURS)])
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
