"""Distribution analysis: peak fitting over hist / GCP / spectra-cn inputs.

Behavioral re-implementation of reference scripts/kat/distanalysis.py: the
input kind is sniffed from the mme header (`# Rows:` => matrix,
`# YLabel:GC count` => GCP; distanalysis.py:344-365), the appropriate
analysis fits Gaussian peak models, prints the same reports and writes
`<prefix>.dist_analysis.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from .spectra import GCSpectra, KmerSpectra


class SpectraAnalysis:
    def __init__(self, haploid=False, freq_cutoff=10000, hom_peak_freq=0,
                 k=27):
        self.k = k
        self.haploid = haploid
        self.freq_cutoff = freq_cutoff
        self.hom_peak = hom_peak_freq
        self.limx = 0
        self.limy = 0


def read_hist(path: str, freq_cutoff: int = 10000) -> list[int]:
    with open(path) as f:
        return [int(x.split()[1]) for x in f
                if x and x[0] != "#"][:freq_cutoff]


def read_mx_column(path: str, freq_cutoff: int = 10000, column: int = 1,
                   cumulative: bool = False) -> list[int]:
    """Column (or row-tail-sum) of a spectra-cn matrix; drops entry 0
    (distanalysis.py:204-214)."""
    with open(path) as f:
        lines = [x for x in f if x and x[0] != "#"]
    if cumulative:
        return [sum(int(y) for y in x.split()[column:])
                for x in lines][:freq_cutoff][1:]
    return [int(x.split()[column]) for x in lines][:freq_cutoff][1:]


class HistKmerSpectraAnalysis(SpectraAnalysis):
    def __init__(self, filename, haploid=False, freq_cutoff=10000,
                 hom_peak_freq=0, k=27):
        super().__init__(haploid, freq_cutoff, hom_peak_freq, k)
        self.spectra = KmerSpectra(read_hist(filename, freq_cutoff),
                                   haploid=haploid, k=k)

    def analyse(self, min_elements=1, verbose=False):
        if verbose:
            print("Analysing spectra")
        self.spectra.analyse(min_elements=min_elements, verbose=verbose)
        if self.spectra.peaks:
            self.limy = int(max(
                int(self.spectra.max_value() * 1.1 / 1000) * 1000,
                self.limy))
            self.limx = int(max(min(self.spectra.peaks[-1].mean() * 2,
                                    len(self.spectra.histogram)), self.limx))

    def peak_stats(self, prefix=None):
        print()
        print("K-mer frequency spectra statistics")
        print("----------------------------------")
        stats = self.spectra.calc_stats(self.hom_peak)
        self.spectra.print_stats(stats)
        if prefix:
            with open(prefix + ".dist_analysis.json", "w") as f:
                json.dump(stats, f, indent=4)

    def plot(self, xmax=0, ymax=0, to_screen=False, file_prefix=None,
             format=None):
        if xmax == 0:
            xmax = self.limx
        if ymax == 0:
            ymax = self.limy
        print()
        print("Creating plots")
        print("--------------")
        print()
        if not self.spectra.peaks:
            print("No peaks in K-mer frequency histogram.  Not plotting.")
        else:
            print("Plotting K-mer frequency distributions ... ", end="",
                  flush=True)
            ofile = (file_prefix + ".kmerfreq_distributions." + format
                     if file_prefix and format else None)
            self.spectra.plot(xmax, ymax,
                              title="K-mer frequency distributions",
                              to_screen=to_screen, output_file=ofile)
            print("done.  Saved to:", ofile)
        print()


class GCKmerSpectraAnalysis(SpectraAnalysis):
    def __init__(self, filename, haploid=False, freq_cutoff=10000,
                 hom_peak_freq=0, k=27):
        super().__init__(haploid, freq_cutoff, hom_peak_freq, k)
        cov_histo, gc_histo = self._read(filename, freq_cutoff)
        self.mean_gc = (sum(i * x for i, x in enumerate(gc_histo))
                        / sum(gc_histo))
        self.cov_spectra = KmerSpectra(cov_histo, haploid=haploid, k=k)
        self.gc_dist = GCSpectra(gc_histo, k=k)

    @staticmethod
    def _read(path, freq_cutoff=10000):
        """GCP matrix -> (coverage histogram = column sums,
        gc histogram = row sums); distanalysis.py:107-121."""
        cov = None
        gc = []
        with open(path) as f:
            for x in f:
                if x and x[0] != "#":
                    parts = x.split()
                    gc.append(sum(int(y) for y in parts))
                    if not cov:
                        cov = [0] * len(parts)
                    for i, y in enumerate(parts):
                        cov[i] += int(y)
        return cov[:freq_cutoff], gc

    def analyse(self, min_elements=1, verbose=False):
        if verbose:
            print("Analysing K-mer spectra")
        self.cov_spectra.analyse(min_elements=min_elements, verbose=verbose)
        if self.cov_spectra.peaks:
            self.limy = int(max(
                int(self.cov_spectra.max_value() * 1.1 / 1000) * 1000,
                self.limy))
            self.limx = int(max(
                min(self.cov_spectra.peaks[-1].right() * 1.1,
                    len(self.cov_spectra.histogram)), self.limx))
        if verbose:
            print("Analysing GC distribution")
        self.gc_dist.analyse(min_elements=min_elements, verbose=verbose)

    def peak_stats(self, prefix=None):
        print()
        print("K-mer frequency spectra statistics")
        print("----------------------------------")
        print()
        kmer_stats = self.cov_spectra.calc_stats(self.hom_peak)
        self.cov_spectra.print_stats(kmer_stats)
        print()
        print("GC distribution statistics")
        print("--------------------------")
        print()
        gc_stats = self.gc_dist.calc_stats()
        self.gc_dist.print_stats(gc_stats)
        if prefix:
            with open(prefix + ".dist_analysis.json", "w") as f:
                json.dump({"coverage": kmer_stats, "gc": gc_stats}, f,
                          indent=4)

    def plot(self, xmax=0, ymax=0, to_screen=False, file_prefix=None,
             format=None):
        if xmax == 0:
            xmax = self.limx
        if ymax == 0:
            ymax = self.limy
        print()
        print("Creating plots")
        print("--------------")
        print()
        if not self.cov_spectra.peaks:
            print("No peaks in K-mer frequency histogram.  Not plotting.")
        else:
            print("Plotting K-mer frequency distributions ... ", end="",
                  flush=True)
            ofile = (file_prefix + ".kmerfreq_distributions." + format
                     if file_prefix and format else None)
            self.cov_spectra.plot(
                xmax, ymax, title="K-mer frequency distributions",
                to_screen=to_screen, output_file=ofile)
            print("done.  Saved to:", ofile)
        if not self.gc_dist.peaks:
            print("No peaks in GC distribution.  Not plotting.")
        else:
            print("Plotting GC distributions ... ", end="", flush=True)
            ofile = (file_prefix + ".gc_distributions." + format
                     if file_prefix and format else None)
            self.gc_dist.plot(xmax=self.gc_dist.k,
                              ymax=max(self.gc_dist.histogram) * 1.1,
                              title="GC distributions", to_screen=to_screen,
                              output_file=ofile)
            print("done. Saved to:", ofile)
        print()


class MXKmerSpectraAnalysis(SpectraAnalysis):
    def __init__(self, filename, cns_cutoff=3, haploid=False,
                 freq_cutoff=10000, hom_peak_freq=0, k=27):
        super().__init__(haploid, freq_cutoff, hom_peak_freq, k)
        self.spectras = [KmerSpectra(
            read_mx_column(filename, freq_cutoff, column=0,
                           cumulative=True), haploid=haploid, k=k)]
        for i in range(cns_cutoff):
            self.spectras.append(KmerSpectra(
                read_mx_column(filename, freq_cutoff, column=i,
                               cumulative=False), haploid=haploid, k=k))

    def analyse(self, min_elements=1, verbose=False):
        max_value = 0
        right = 0
        for s_i, s in enumerate(self.spectras):
            if s_i == 0:
                print("\nAnalysing full spectra")
            else:
                print("\nAnalysing spectra with copy number", s_i - 1)
            s.analyse(min_elements=min_elements, verbose=verbose)
            if s.peaks:
                if s_i == 0:
                    s.calc_genome_size(self.hom_peak)
                else:
                    # Inherit descriptions from the general spectra
                    for gp in self.spectras[0].peaks:
                        f = gp.mean()
                        for p in s.peaks:
                            if 0.8 * f < p.mean() < 1.2 * f:
                                p.description = gp.description
                max_value = max(max_value, s.max_value())
                right = max(right, s.peaks[-1].right())
            elif s_i == 0:
                print("No peaks detected for full spectra.  Can't continue.")
                return
        self.limy = int(max(int(max_value * 1.1 / 1000) * 1000, self.limy))
        self.limx = int(max(min(right * 1.1, len(s.histogram)), self.limx))
        print("\nAnalysed spectra for all requested copy numbers.")

    def calc_assembly_completeness(self) -> float:
        """Fraction of homozygous-frequency content present in the assembly:
        1x-row count vs 0x-row count at the homozygous frequency
        (distanalysis.py:333-342)."""
        if not self.spectras[0].peaks:
            return 0.0
        hpi = self.spectras[0].get_homozygous_peak_index(self.hom_peak)
        opt_freq = int(self.spectras[0].peaks[hpi - 1].mean())
        absent = self.spectras[1].histogram[opt_freq]
        present = self.spectras[2].histogram[opt_freq]
        return (present / (absent + present)) * 100.0

    def peak_stats(self, prefix=None):
        print()
        print("Main spectra statistics")
        print("-----------------------")
        stats = {}
        main_stats = self.spectras[0].calc_stats(self.hom_peak)
        self.spectras[0].print_stats(stats=main_stats)
        stats["main_dist"] = main_stats

        completeness = self.calc_assembly_completeness()
        print("Estimated assembly completeness:",
              ("{0:.2f}".format(completeness) + "%")
              if completeness > 0.0 else "Unknown")
        stats["completeness"] = completeness

        if self.spectras[0].peaks:
            print("\nBreakdown of copy number composition for each peak")
            print("----------------------------------------------------")
            for peak in self.spectras[0].peaks:
                f = peak.mean()
                total = 0
                pd_means = {}
                pd_elements = {}
                for i, s in enumerate(self.spectras[1:]):
                    if s.peaks:
                        spectra_stats = s.calc_stats()
                        key = "spectra_" + str(i) + "x"
                        stats[key] = spectra_stats
                        for drop in ("est_genome_size", "est_het_rate",
                                     "hom_peak"):
                            stats[key].pop(drop, None)
                        m = [(x.mean(), x.elements()) for x in s.peaks
                             if 0.8 * f < x.mean() < 1.2 * f]
                        if len(m) == 1:
                            pd_means[i] = m[0][0]
                            pd_elements[i] = m[0][1]
                            total += m[0][1]
                        elif len(m) > 1:
                            print("WARNING, MORE THAT 1 PEAK FOR f=%.3f "
                                  "FOUND ON THE %dx SPECTRA!!!" % (f, i))
                print("\n---- Report for f=%.3f (total elements %d)----"
                      % (f, total))
                for i, s in enumerate(self.spectras[1:]):
                    if i in pd_means:
                        print(" %dx: %.2f%% (%d elements at f=%.2f)"
                              % (i, float(pd_elements[i]) * 100 / total,
                                 pd_elements[i], pd_means[i]))
                    else:
                        print(" %dx: No significant content" % i)

        if prefix:
            with open(prefix + ".dist_analysis.json", "w") as f:
                json.dump(stats, f, indent=4)

    def plot(self, xmax=0, ymax=0, to_screen=False, file_prefix=None,
             format=None):
        if xmax == 0:
            xmax = self.limx
        if ymax == 0:
            ymax = self.limy
        print()
        print("Creating plots")
        print("--------------")
        print()
        if not self.spectras[0].peaks:
            print("No peaks in K-mer frequency histogram.  Not plotting.")
            return
        ofile = (file_prefix + ".kmerfreq_general." + format
                 if file_prefix and format else None)
        print("Plotting K-mer frequency distributions for general spectra "
              "... ", end="", flush=True)
        self.spectras[0].plot(xmax=xmax, ymax=ymax, title="General Spectra",
                              to_screen=to_screen, output_file=ofile)
        print("done." + (" Saved to: " + ofile
                         if file_prefix and format else ""))
        for s_i, s in enumerate(self.spectras[1:], start=1):
            if s.peaks:
                ofile = (file_prefix + ".kmerfreq_" + str(s_i - 1) + "x."
                         + format if file_prefix and format else None)
                slabel = "%dx" % (s_i - 1)
                ym = min(ymax, s.max_value() * 1.1) if s_i > 1 else ymax
                print("Plotting K-mer frequency distributions for", slabel,
                      "... ", end="", flush=True)
                s.plot(xmax=xmax, ymax=ym, title=slabel,
                       to_screen=to_screen, output_file=ofile)
                print("done." + (" Saved to: " + ofile
                                 if file_prefix and format else ""))
        print()


def get_properties_from_file(input_file: str):
    """(k, is_matrix, is_gcp) from the first lines' mme header
    (distanalysis.py:344-365)."""
    k = 27
    mx = False
    gcp = False
    with open(input_file) as f:
        for i, line in enumerate(f):
            if i > 10:
                break
            line = line.strip()
            if line.startswith("#"):
                if line.startswith("# Kmer value:"):
                    k = int(line.split(":")[1])
                elif line.startswith("# Rows:"):
                    mx = True
                elif line.startswith("# YLabel:GC count"):
                    gcp = True
    return k, mx, gcp


def analyse_file(input_file: str, cns=4, haploid=False, freq_cutoff=500,
                 hom_peak_freq=0):
    """Build the right analysis for a hist/GCP/spectra-cn artifact."""
    k, mx, gcp = get_properties_from_file(input_file)
    if mx and gcp:
        return GCKmerSpectraAnalysis(input_file, haploid=haploid,
                                     freq_cutoff=freq_cutoff,
                                     hom_peak_freq=hom_peak_freq, k=k)
    if mx:
        return MXKmerSpectraAnalysis(input_file, haploid=haploid,
                                     cns_cutoff=cns,
                                     freq_cutoff=freq_cutoff,
                                     hom_peak_freq=hom_peak_freq, k=k)
    return HistKmerSpectraAnalysis(input_file, haploid=haploid,
                                   freq_cutoff=freq_cutoff,
                                   hom_peak_freq=hom_peak_freq, k=k)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Analyse a comp matrix file with respect to the "
                    "distributions and copy numbers seen within.")
    parser.add_argument("input")
    parser.add_argument("-o", "--output_prefix")
    parser.add_argument("--format", default="png")
    parser.add_argument("-c", "--cns", type=int, default=4)
    parser.add_argument("-f", "--freq_cutoff", type=int, default=500)
    parser.add_argument("-e", "--min_elem", type=int, default=10000)
    parser.add_argument("-p", "--plot", action="store_true")
    parser.add_argument("-z", "--homozygous_peak", type=int, default=0)
    parser.add_argument("--haploid", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--from_kat", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if not args.from_kat:
        from .. import __version__
        print("KAT K-mer Distribution Analysis Script")
        print("Version:", __version__)
        print()
    else:
        print()

    if args.verbose:
        print("Analysing distributions for:", args.input)
    else:
        print("Analysing distributions for:", args.input, "... ", end="",
              flush=True)

    a = analyse_file(args.input, cns=args.cns, haploid=args.haploid,
                     freq_cutoff=args.freq_cutoff,
                     hom_peak_freq=args.homozygous_peak)
    try:
        start = time.time()
        a.analyse(min_elements=args.min_elem, verbose=args.verbose)
        end = time.time()
        print(("\n" if args.verbose else "done.  ") + "Time taken: ",
              "{0:.1f}".format(end - start) + "s")
        a.peak_stats(args.output_prefix)
        if args.plot or args.output_prefix:
            a.plot(xmax=args.freq_cutoff, to_screen=args.plot,
                   file_prefix=args.output_prefix, format=args.format)
    except Exception:  # noqa: BLE001 — report and continue, like reference
        print("\nERROR\n-----", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
