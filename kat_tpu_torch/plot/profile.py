"""`kat plot profile` — per-base coverage track(s) from `kat sect`
-counts.cvg output.

Behavioral re-implementation of reference scripts/kat/plot/profile.py
(one subplot per requested sequence; optional second file on a twin axis).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .misc import correct_filename


def _read_profiles(path: str):
    names: list[str] = []
    profiles: dict[str, str] = {}
    last = ""
    with open(path) as f:
        for line in f:
            if line[0] == ">":
                last = line[1:-1]
                names.append(last)
            else:
                profiles[last] = line[:-1]
    return names, profiles


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Create Sequence Coverage Plot.")
    parser.add_argument("sect_profile_file")
    parser.add_argument("sect_profile_file_2", nargs="?")
    parser.add_argument("-o", "--output", default="kat-profile")
    parser.add_argument("-p", "--output_type")
    parser.add_argument("-t", "--title")
    parser.add_argument("-a", "--x_label")
    parser.add_argument("-b", "--y_label")
    parser.add_argument("-c", "--y2_label")
    parser.add_argument("-X", "--x_max", type=int)
    parser.add_argument("-x", "--x_min", type=int)
    parser.add_argument("-Y", "--y_max", type=int)
    parser.add_argument("-y", "--y_min", type=int)
    parser.add_argument("-z", "--y2_max", type=int)
    parser.add_argument("-w", "--width", type=int, default=8)
    parser.add_argument("-l", "--height", type=float, default=2.5)
    parser.add_argument("-n", "--index", default="0")
    parser.add_argument("-d", "--header")
    parser.add_argument("--dpi", type=int, default=300)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib.pyplot as plt
    import matplotlib.ticker as ticker

    names, profiles = _read_profiles(args.sect_profile_file)
    names2, profiles2 = ([], {})
    if args.sect_profile_file_2:
        names2, profiles2 = _read_profiles(args.sect_profile_file_2)
        if len(names) != len(names2):
            print("First and second input files are not the same length",
                  file=sys.stderr)
            sys.exit(1)

    if args.header is not None:
        names = [args.header]
    else:
        indexes = [int(i) for i in args.index.split(",")]
        names = [names[i] for i in indexes]

    title = args.title or "Sequence Coverage Plot"
    x_label = args.x_label or "Position"
    y_label = args.y_label or ("Coverage" if not args.sect_profile_file_2
                               else "Coverage (first file)")
    y2_label = args.y2_label or "Coverage (second file)"

    fig, axs = plt.subplots(len(names), 1,
                            figsize=(args.width,
                                     args.height * (len(names) + 0.3)))

    profs = [np.fromstring(profiles[n], dtype=float, sep=" ")
             for n in names]
    maxlen = args.x_max if args.x_max is not None else \
        max(map(len, profs))
    minlen = args.x_min if args.x_min is not None else 1
    maxval1 = max(map(max, profs))
    profs2 = []
    maxval2 = 0
    if args.sect_profile_file_2:
        profs2 = [np.fromstring(profiles2[n], dtype=float, sep=" ")
                  for n in names]
        maxval2 = max(map(max, profs2))

    for i, name in enumerate(names):
        if name not in profiles:
            sys.exit(f"Entry {name} not found.")
        profile = profs[i]
        profile2 = None
        if args.sect_profile_file_2:
            profile2 = profs2[i]
            if len(profile) != len(profile2):
                print("First and second input files are not the same "
                      "length", file=sys.stderr)
                sys.exit(1)
        ax1 = axs[i] if len(names) > 1 else axs
        ax2 = ax1.twinx()
        x = np.arange(1, len(profile) + 1)
        ax1.yaxis.set_major_locator(ticker.MaxNLocator(integer=True))
        ax1.xaxis.set_major_locator(ticker.MaxNLocator(integer=True))
        ax1.set_xlim(minlen, maxlen + 1)
        if i == len(names) - 1:
            ax1.set_xlabel(x_label)
            for tick in ax1.get_xticklabels():
                tick.set_rotation(90)
                tick.set_visible(True)
        else:
            ax1.set_xlabel("")
            for tick in ax1.get_xticklabels():
                tick.set_rotation(90)
                tick.set_visible(False)
        ymax1, ymax2 = maxval1, maxval2
        if args.y_max is not None:
            ymax1 = ymax2 = args.y_max
        minval = args.y_min if args.y_min is not None else 1
        ax1.set_title(name, fontsize=12)
        ax1.set_ylim(minval, ymax1 * 1.1)
        ax1.set_ylabel(y_label, color="r")
        ax1.plot(x, profile, "r-")
        if profile2 is not None:
            ax2.yaxis.set_major_locator(ticker.MaxNLocator(integer=True))
            ax2.set_ylim(minval, ymax2 * 1.1)
            ax2.set_ylabel(y2_label, color="b")
            ax2.plot(x, profile2, "b-")

    plt.tight_layout()
    st = plt.suptitle(title, fontsize=18)
    st.set_y(0.95)
    plt.subplots_adjust(top=0.85)

    out = (args.output + "." + args.output_type if args.output_type
           else args.output)
    plt.savefig(correct_filename(out), dpi=args.dpi)
    plt.close()
    return 0


if __name__ == "__main__":
    main()
