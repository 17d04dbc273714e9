"""Spectra models: error-peak-aware k-mer frequency spectra and GC spectra.

Behavioral re-implementation of reference scripts/kat/spectra.py:
`KmerSpectra` seeds 1/2x..5x Gaussian peaks from the global maximum past the
first local minimum (spectra.py:274-349), locally optimises each peak, then
globally curve_fits the peak sum with error-kmer suppression
(spectra.py:98-137); genome size / heterozygous rate / k-mer coverage
estimates follow spectra.py:379-434.  `GCSpectra` seeds peaks from smoothed
local maxima (spectra.py:522-569).
"""

from __future__ import annotations

import sys

import numpy as np
from scipy import optimize
from scipy.signal import argrelextrema

from .peak import Peak, create_model


def smooth(x: np.ndarray, window_len: int = 3) -> np.ndarray:
    """Moving average with edge reflection (spectra.py:16-31)."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("Smooth only accepts 1 dimension arrays.")
    if x.size < window_len or window_len < 3:
        return x
    s = np.r_[x[window_len - 1:0:-1], x, x[-2:-window_len - 1:-1]]
    w = np.ones(window_len, "d")
    return np.convolve(w / w.sum(), s, mode="valid")


class Spectra:
    def __init__(self, histogram, k: int = 27):
        self.histogram = np.array(histogram)
        self.k = k
        self.peaks: list[Peak] | None = None
        self.Tx = np.linspace(0, len(histogram) - 1, len(histogram))
        self.Ty = np.zeros_like(self.Tx)

    # subclasses provide _create_initial_peaks / calc_stats

    def _model(self, x, *params):
        if len(params) != len(self.peaks) * 3:
            raise ValueError("Unexpected number of parameters")
        y = np.zeros_like(x)
        for i in range(len(self.peaks)):
            y = y + create_model(x, params[i * 3], params[i * 3 + 2],
                                 params[i * 3 + 1])
        return y

    def _update_model(self, params) -> np.ndarray:
        if len(params) != len(self.peaks) * 3:
            raise ValueError("Unexpected number of parameters")
        for i, p in enumerate(self.peaks):
            p.update_model(params[i * 3], params[i * 3 + 1],
                           params[i * 3 + 2])
        self.Ty = np.zeros_like(self.Tx)
        for p in self.peaks:
            self.Ty = self.Ty + p.Ty
        return self.Ty

    def optimise(self, fmin: int = 0) -> None:
        """Global cumulative fit of all peaks (spectra.py:98-137)."""
        if not self.peaks:
            print("Can't optimise peaks because none are defined.", end="",
                  flush=True)
            return
        params, lower, upper = [], [], []
        for p in self.peaks:
            params += [p.mean(), p.peak(), p.stddev()]
            lower += [p.mean() - 1.0, 0.0,
                      p.stddev() - np.sqrt(p.stddev())]
            upper += [p.mean() + 1.0, p.peak(),
                      max(min((p.mean() - 2.0) / 2.0,
                              p.stddev() + np.sqrt(p.stddev())),
                          p.stddev() + 0.01)]
        self.Tx = np.linspace(0, len(self.histogram) - 1,
                              len(self.histogram))
        # Suppress error k-mers below the first minimum (spectra.py:125-129)
        fitcurve = np.array(self.histogram)
        idx = np.arange(len(fitcurve))
        sup = idx <= fmin
        fitcurve[sup] = fitcurve[sup] // np.power(fmin - idx[sup] + 1, 6) \
            if fitcurve.dtype.kind in "iu" else \
            fitcurve[sup] / np.power(fmin - idx[sup] + 1, 6)
        res = optimize.curve_fit(self._model, self.Tx, fitcurve, p0=params,
                                 bounds=(np.array(lower), np.array(upper)))
        self._update_model(res[0])

    def analyse(self, min_elements: int = 1, verbose: bool = False) -> None:
        if verbose:
            print()
            print("Creating initial peaks ... ", end="", flush=True)
        self._create_initial_peaks()
        if not self.peaks:
            if verbose:
                print("done. No peaks created")
            return
        if verbose:
            print("done.", len(self.peaks), "peaks initially created")
            print()
            self.print_peaks()
            print()
            print("Locally optimising each peak ... ", end="")
        for p_i, p in enumerate(self.peaks):
            try:
                p.optimise(self.histogram)
            except Exception as inst:  # noqa: BLE001 — carry on, like ref
                print("Problem locally optimising peak", p_i + 1,
                      file=sys.stderr)
                print(inst, file=sys.stderr)
        self.peaks = [p for p in self.peaks
                      if p.elements() >= min_elements]
        if verbose:
            print("done.")
            print()
            self.print_peaks()
            print()
            print("Fitting cumulative distribution to histogram by "
                  "adjusting peaks ... ", end="", flush=True)
        try:
            self.optimise(
                fmin=self.fmin if isinstance(self, KmerSpectra) else 0)
            self.peaks = [p for p in self.peaks
                          if p.elements() >= min_elements]
            if verbose:
                print("done.")
                print()
                self.print_peaks()
        except Exception as inst:  # noqa: BLE001
            print("WARNING: problem optimising peaks. It is likely that the "
                  "spectra is too complex to analyse properly.  Output for "
                  "this spectra may not be valid.", file=sys.stderr)
            print(inst, file=sys.stderr)

    def print_peaks(self) -> None:
        if self.peaks:
            import tabulate
            header = ["Index"] + Peak.header()
            rows = [[str(i)] + p.to_row()
                    for i, p in enumerate(self.peaks, start=1)]
            print(tabulate.tabulate(rows, header))
        else:
            print("No peaks detected")

    def plot(self, xmax, ymax, title=None, to_screen=True,
             output_file=None):
        import matplotlib
        if not to_screen:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        plt.plot(self.histogram[:xmax], label="Actual", color="black")
        colours = {"1X": "red", "1/2X": "blue", "2X": "green",
                   "3X": "orange"}
        for p in self.peaks:
            colour = next((c for pre, c in colours.items()
                           if p.description.startswith(pre)), None)
            plt.plot(p.Ty[:xmax], label=p.description, color=colour)
        plt.plot(self.Ty[:xmax], label="Fitted model", color="gray")
        plt.xlabel("Kmer Frequency" if isinstance(self, KmerSpectra)
                   else "GC count")
        plt.ylabel("# Distinct Kmers")
        if title:
            plt.title(title)
        plt.xlim((0, xmax))
        plt.ylim((0, ymax))
        plt.legend()
        if to_screen:
            plt.show()
        if output_file:
            fig.savefig(output_file)
        plt.close(fig)


class KmerSpectra(Spectra):
    """K-mer frequency spectra with error-peak suppression and
    1/2x..5x peak seeding (spectra.py:247-349)."""

    def __init__(self, histogram, haploid: bool = False, k: int = 27):
        super().__init__(histogram, k)
        self.haploid = haploid
        self.fmax = 0
        self.fmin = 0

    def max_value(self):
        return self.histogram[self.fmax]

    def _create_initial_peaks(self) -> None:
        # First local minimum, checking two steps ahead to dodge laddering
        # (spectra.py:282-289).
        fmin = 0
        h = self.histogram
        for i in range(1, len(h) - 2):
            if h[i] < h[i + 1] and h[i] < h[i + 2]:
                fmin = i
                break
        fmax = 0 if not fmin else int(np.argmax(h[fmin:]) + fmin)
        self.fmin = fmin
        self.fmax = fmax

        if fmax < 10:
            self.peaks = None
            return

        frequencies: list[float] = []
        desc: list[str] = []
        if not self.haploid:
            frequencies.append(fmax / 2.0)
            desc.append("1/2X")
        for i in range(1, 6):
            frequencies.append(fmax * i)
            desc.append(f"{i}X")

        peaks = []
        for d, mu in zip(desc, frequencies):
            sigma = np.sqrt(mu)           # poisson: variance == mean
            radius = int(sigma * 2.0)
            mean = int(mu)
            if (radius >= 2 and mean > fmin and mu - radius > 0
                    and mu + radius < len(h) and h[mean] >= 1):
                peaks.append(Peak(mean, sigma, h[mean], mean == fmax,
                                  description=d))
        self.peaks = peaks

    def get_homozygous_peak_index(self, approx_freq: int = 0) -> int:
        if approx_freq > 0:
            best, best_delta = 0, 1000000
            for p_i, p in enumerate(self.peaks, start=1):
                delta = abs(p.mean() - approx_freq)
                if best_delta > delta:
                    best_delta = delta
                    best = p_i
            return best
        if self.peaks:
            for i, p in enumerate(self.peaks, start=1):
                if abs(p.mean() - self.fmax) < 4.0:
                    return i
        return 0

    def calc_genome_size(self, hom_peak: int = 0) -> int:
        hp = self.get_homozygous_peak_index(hom_peak) if hom_peak == 0 \
            else hom_peak
        if hp == 0:
            return 0
        total = 0.0
        for p_i, p in enumerate(self.peaks, start=1):
            if p_i >= hp:
                total += (p_i - hp + 1) * p.elements()
            else:
                total += p.elements() / (hp - p_i + 1)
        return int(total)

    def calc_het_rate(self, genome_size: int = 0, hom_peak: int = 0) -> float:
        gs = genome_size if genome_size > 0 else self.calc_genome_size()
        hp = self.get_homozygous_peak_index(hom_peak)
        if hp < 2:
            return 0.0
        total = 0.0
        for p_i, p in enumerate(self.peaks, start=1):
            if p_i >= hp:
                break
            total += p.elements() / self.k
        return (total / gs) * 100.0

    def calc_kmer_coverage(self) -> int:
        if not self.peaks:
            return 0
        tot = sum(p.elements() for p in self.peaks)
        weighted = sum(p.mean() * p.elements() for p in self.peaks)
        return int(weighted / tot) if tot > 0 else 0

    def calc_stats(self, hom_peak_freq: int = 0) -> dict:
        hp = self.get_homozygous_peak_index(hom_peak_freq)
        gs = self.calc_genome_size(hom_peak=hp)
        stats = {
            "k": self.k,
            "nb_peaks": len(self.peaks) if self.peaks else 0,
            "global_minima": {"freq": int(self.fmin),
                              "count": int(self.histogram[self.fmin])},
            "global_maxima": {"freq": int(self.fmax),
                              "count": int(self.histogram[self.fmax])},
            "mean_freq": self.calc_kmer_coverage(),
        }
        if self.peaks:
            stats["peaks"] = [{
                "mean_freq": float(p.mean()),
                "stddev": float(p.stddev()),
                "count": int(p.peak()),
                "volume": int(p.elements()),
            } for p in self.peaks]
            hp_freq = hom_peak_freq if hom_peak_freq > 0 else \
                int(self.peaks[hp - 1].mean())
            stats["hom_peak"] = {"freq": hp_freq, "index": hp}
            stats["est_genome_size"] = gs
            stats["est_het_rate"] = self.calc_het_rate(gs)
        else:
            stats["peaks"] = []
            stats["hom_peak"] = {"freq": 0, "index": 0}
            stats["est_genome_size"] = 0
            stats["est_het_rate"] = 0
        return stats

    def print_stats(self, stats=None, hom_peak_freq: int = 0) -> None:
        if not stats:
            stats = self.calc_stats(hom_peak_freq=hom_peak_freq)
        print("K-value used:", stats["k"])
        print("Peaks in analysis:", stats["nb_peaks"])
        print("Global minima @ Frequency=" +
              str(int(stats["global_minima"]["freq"])) + "x (" +
              str(stats["global_minima"]["count"]) + ")")
        print("Global maxima @ Frequency=" +
              str(int(stats["global_maxima"]["freq"])) + "x (" +
              str(stats["global_maxima"]["count"]) + ")")
        print("Overall mean k-mer frequency:",
              str(stats["mean_freq"]) + "x")
        print()
        self.print_peaks()
        print()
        print("Calculating genome statistics")
        print("-----------------------------")
        if self.peaks:
            if hom_peak_freq > 0:
                print("User-specified that homozygous peak should have a "
                      "frequency of", hom_peak_freq)
            else:
                print("Assuming that homozygous peak is the largest in the "
                      "spectra with frequency of:",
                      str(int(stats["hom_peak"]["freq"])) + "x")
            print("Homozygous peak index:", stats["hom_peak"]["index"])
            print("CAUTION: the following estimates are based on having a "
                  "clean spectra and having identified the correct "
                  "homozygous peak!")
            print("Estimated genome size:",
                  "{0:.2f}".format(
                      float(stats["est_genome_size"]) / 1000000.0), "Mbp")
            if stats["hom_peak"]["index"] > 1:
                print("Estimated heterozygous rate:",
                      "{0:.2f}".format(stats["est_het_rate"]) + "%")
        else:
            print("No peaks detected, so no genome stats to report")


class GCSpectra(Spectra):
    """GC-count spectra: peaks at smoothed local maxima
    (spectra.py:507-569)."""

    def _create_initial_peaks(self) -> None:
        wlen = 3
        smooth_histo = smooth(self.histogram, window_len=wlen)
        peak_means = argrelextrema(smooth_histo, np.greater)
        if not peak_means or len(peak_means) == 0:
            self.peaks = None
            return
        peaks = []
        for mu in peak_means[0]:
            mean = mu - wlen + 2  # correct for smoothing
            sigma = 2.0
            radius = int(sigma * 2.0)
            if mean - radius > 0 and mean + radius < self.k:
                peaks.append(Peak(mean, sigma, self.histogram[mean],
                                  mean == np.argmax(self.histogram)))
        self.peaks = peaks

    def calc_stats(self) -> dict:
        stats = {
            "k": self.k,
            "nb_peaks": len(self.peaks),
            "mean_gc%": (sum(i * x for i, x in enumerate(self.histogram))
                         / sum(self.histogram) * (100.0 / self.k)),
        }
        if self.peaks:
            stats["peaks"] = [{
                "mean_freq": p.mean(),
                "stddev": p.stddev(),
                "count": p.peak(),
                "volume": p.elements(),
            } for p in self.peaks]
        return stats

    def print_stats(self, stats=None) -> None:
        if not stats:
            stats = self.calc_stats()
        print("K-value used:", stats["k"])
        print("Peaks in analysis:", stats["nb_peaks"])
        print("Mean GC:", "{0:.2f}".format(stats["mean_gc%"]) + "%")
        print()
        self.print_peaks()
