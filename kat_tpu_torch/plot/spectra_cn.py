"""`kat plot spectra-cn` — stacked per-copy-number bar chart from a comp
matrix.

Behavioral re-implementation of reference scripts/kat/plot/spectra_cn.py,
including the 99%-volume x-limit with error-row and cumulative-row
corrections (spectra_cn.py:96-170).
"""

from __future__ import annotations

import argparse

import numpy as np

from .misc import correct_filename, findpeaks, readheader, wrap

COLOURS = ["#000000", "#ef2929", "#ad7fa8", "#8ae234", "#729fcf",
           "#f2c27e", "#fcaf3e", "#fce94f"]


def select_bands(matrix: np.ndarray, mincov: int, covbands: int,
                 cumulative: bool) -> tuple[np.ndarray, list[int], bool]:
    """The copy-number rows actually plotted: rows mincov..covbands-1,
    plus (by default) one cumulative row summing everything >= covbands.
    Returns (nm, bands, combine_last_row)."""
    bands = list(range(mincov, covbands))
    combine_last_row = False
    if cumulative:
        combine_last_row = True
        bands.append(bands[-1] + 1)
    nm = np.zeros((len(bands), matrix.shape[1]))
    for i, b in enumerate(bands):
        nm[i] = matrix[b, :]
    if combine_last_row:
        nm[-1] = np.sum(matrix[covbands:, :], axis=0)
    return nm, bands, combine_last_row


def auto_limits(nm: np.ndarray, mincov: int,
                combine_last_row: bool) -> tuple[int, float]:
    """(xmax, ymax) per the 99%-volume rule (reference
    scripts/kat/plot/spectra_cn.py:141-168): the x limit is the first
    multiplicity whose cumulative volume reaches a cutoff that starts at
    0.99 and is discounted by half the error-row (0x) share and by the
    whole cumulative-row share; the y limit is 1.1x the tallest non-1
    frequency peak of the stacked totals."""
    totals = np.sum(nm, 0)
    xmax = len(totals) - 1
    ysum = np.sum(totals)
    ymax = np.max(totals)
    xvolume_cutoff = 0.99
    if mincov == 0:
        xvolume_cutoff -= (totals[0] / np.sum(totals[1:])) / 2.0
    if combine_last_row:
        xvolume_cutoff -= totals[-1] / np.sum(totals[:-1])
    peakx = findpeaks(totals)
    peakx = peakx[peakx != 1]
    peaky = totals[peakx]
    for i in range(1, xmax, 1):
        if np.sum(totals[0:i]) >= float(ysum) * xvolume_cutoff:
            xmax = i
            break
    if peaky.size:
        ymax = np.max(peaky) * 1.1
    return xmax, ymax


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Creates a stacked histogram showing the level of "
                    "duplication in an assembly.")
    parser.add_argument("matrix_file")
    parser.add_argument("-o", "--output", default="kat-spectra-cn")
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title")
    parser.add_argument("-a", "--x_label")
    parser.add_argument("-b", "--y_label")
    parser.add_argument("-x", "--x_max", type=int)
    parser.add_argument("-y", "--y_max", type=int)
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=int, default=6)
    parser.add_argument("-i", "--min_assembly_frequency", type=int,
                        default=0)
    parser.add_argument("-m", "--max_dup", type=int, default=6)
    parser.add_argument("-c", "--coverage_list")
    parser.add_argument("-u", "--no_cumulative", action="store_true")
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib.pyplot as plt

    with open(args.matrix_file) as f:
        header = readheader(f)
        matrix = np.loadtxt(f)
    if header.get("Transpose") == "1":
        matrix = np.transpose(matrix)

    title = args.title or header.get("Title", "k-mer comparison plot")
    x_label = args.x_label or "k-mer multiplicity"
    y_label = args.y_label or "Number of distinct k-mers"

    if args.coverage_list:
        bands = [int(p.strip()) for p in args.coverage_list.split(",")
                 if p.strip()]
        mincov = bands[0]
        covbands = bands[-1]
        combine_last_row = False
        nm = np.zeros((len(bands), len(matrix[0])))
        for i, b in enumerate(bands):
            nm[i] = matrix[b, :]
    else:
        mincov = (int(args.min_assembly_frequency)
                  if args.min_assembly_frequency else 0)
        covbands = args.max_dup
        nm, bands, combine_last_row = select_bands(
            matrix, mincov, covbands, not args.no_cumulative)

    colours = COLOURS[mincov:] if mincov > 0 else COLOURS

    if args.x_max is None or args.y_max is None:
        xmax, ymax = auto_limits(nm, mincov, combine_last_row)

    if args.x_max is not None:
        xmax = args.x_max
    if args.y_max is not None:
        ymax = args.y_max
    xmax = max(xmax, 25)
    ymax = max(ymax, 25)

    nm = nm[:, :xmax]
    plt.figure(num=None, figsize=(args.width, args.height))
    plt.axis([0, xmax, 0, ymax])
    x = list(range(min(xmax, len(nm[0]))))
    labels = [f"{b}x" for b in bands]
    if combine_last_row:
        labels[-1] = labels[-1] + "+"

    plt.bar(x, np.squeeze(np.asarray(nm[0, :])), color=colours[0],
            linewidth=0.1, edgecolor=colours[0], width=1, label=labels[0])
    for level in range(1, len(bands)):
        plt.bar(x, np.squeeze(np.asarray(nm[level, :])),
                bottom=np.squeeze(np.asarray(np.sum(nm[:level, :], 0))),
                color=colours[level % len(colours)], linewidth=0.1,
                edgecolor=colours[level % len(colours)], width=1,
                label=labels[level])

    plt.title(wrap(title))
    plt.xlabel(wrap(x_label))
    plt.ylabel(wrap(y_label))
    plt.grid(True, color="black", alpha=0.2)
    plt.legend(loc=1)
    plt.tight_layout()

    out = (args.output + "." + args.output_type if args.output_type
           else args.output)
    plt.savefig(correct_filename(out), dpi=args.dpi)
    plt.close()
    return 0


if __name__ == "__main__":
    main()
