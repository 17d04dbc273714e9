"""`kat plot cold` — contig GC%% vs read coverage scatter, sized by length
and coloured by assembly duplication level.

Behavioral re-implementation of reference scripts/kat/plot/cold.py.
"""

from __future__ import annotations

import argparse
import math

from .misc import correct_filename

COLOURS = ["#ef292980", "#ad7fa880", "#8ae23480", "#729fcf80",
           "#f2c27e80", "#fcaf3e80", "#fce94f80"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Creates a scatter plot of contigs: GC%% vs read k-mer "
                    "coverage, sized by length, coloured by duplication.")
    parser.add_argument("stats_file")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title")
    parser.add_argument("-y", "--y_max", type=int)
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=int, default=6)
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from matplotlib.ticker import ScalarFormatter

    title = args.title or "KAT Contig Length and Duplication plot"
    x_label = "GC%"
    y_label = "Median K-mer Coverage"

    sizes, gcs, dups, covs = [], [], [], []
    with open(args.stats_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("seq_name"):
                continue
            parts = line.split("\t")
            sizes.append(int(parts[5]))
            gcs.append(float(parts[4]) * 100.0)
            dups.append(int(parts[3]))
            covs.append(float(parts[1]))

    for i, dup in enumerate(dups):
        if dup <= 0:
            raise ValueError(f"Found a duplication level of: {dup}.  We "
                             "require duplications levels to be >= 1.")
        if dup >= 7:
            dups[i] = 6

    ymax = args.y_max if args.y_max else max(covs) * 5
    ymax = max(ymax, 25)

    fig = plt.figure(figsize=(args.width, args.height))
    ax = fig.add_subplot(111)
    ax.set_xlim([0.0, 100.0])
    ax.set_ylim([0.9, float(ymax)])
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    for i in range(len(sizes)):
        ax.scatter(gcs[i], covs[i], color=COLOURS[dups[i] - 1], marker="o",
                   s=math.sqrt(sizes[i]), edgecolors="black")
    ax.xaxis.grid(True, which="major")
    ax.yaxis.grid(True, which="major")
    ax.set_axisbelow(True)
    ax.set_title(title)
    ax.set_yscale("log")
    ax.yaxis.set_major_formatter(ScalarFormatter())

    dupsleg = [mpatches.Patch(color=COLOURS[i], alpha=1) for i in range(6)]
    sizeleg = [mlines.Line2D([0], [0], linestyle="none", marker="o",
                             markersize=math.sqrt(math.sqrt(s)),
                             markeredgecolor="black",
                             markerfacecolor="gray")
               for s in (1000, 10000, 100000, 1000000)]
    legend1 = ax.legend(dupsleg, ["1x", "2x", "3x", "4x", "5x", "6x+"],
                        ncol=1, scatterpoints=1, fontsize="small",
                        bbox_to_anchor=(1.15, 1.0))
    ax.legend(sizeleg, ["1Kbp", "10Kbp", "100Kbp", "1Mbp"], ncol=4,
              markerscale=1, numpoints=1, scatterpoints=1, labelspacing=2,
              handletextpad=1.5, borderaxespad=1.5, fontsize="small",
              loc="upper center")
    plt.gca().add_artist(legend1)
    plt.tight_layout()
    plt.subplots_adjust(right=0.85)

    if args.output:
        out = (args.output + "." + args.output_type if args.output_type
               else args.output)
        plt.savefig(correct_filename(out), dpi=args.dpi)
    plt.close()
    return 0


if __name__ == "__main__":
    main()
