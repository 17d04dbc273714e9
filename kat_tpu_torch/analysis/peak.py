"""Single Gaussian peak model for spectra fitting.

Behavioral re-implementation of reference scripts/kat/peak.py: a peak is a
scaled Gaussian; local fitting uses scipy `least_squares` with soft_l1 loss
and residuals suppressed below the error-kmer boundary fmin
(peak.py:94-167).  The math is identical; evaluation is vectorized numpy
instead of the reference's per-element loops.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize


def gaussian(x, mu, sig):
    return np.exp(-np.power(np.asarray(x, float) - mu, 2.0)
                  / (2.0 * np.power(sig, 2.0)))


def create_model(x, mu, sig, scale):
    return gaussian(x, mu, sig) * scale


class Peak:
    def __init__(self, mean, stddev, peak, primary, description=""):
        self._mean = float(mean)
        self._stddev = float(stddev)
        self._peak = float(peak)
        self.primary = primary
        self.description = description
        self.Tx: np.ndarray | None = None
        self.Ty: np.ndarray | None = None

    # accessors in the reference's getter/setter style
    def mean(self, v=None):
        if v is not None:
            self._mean = float(v)
        return self._mean

    def stddev(self, v=None):
        if v is not None:
            self._stddev = float(v)
        return self._stddev

    def peak(self, v=None):
        if v is not None:
            self._peak = float(v)
        return self._peak

    def radius(self) -> float:
        return 2.0 * self._stddev

    def left(self) -> float:
        return self._mean - self.radius()

    def right(self) -> float:
        return self._mean + self.radius()

    def elements(self) -> int:
        return int(self.Ty.sum()) if self.Ty is not None else 0

    def update_model(self, mean, peak, stddev) -> np.ndarray:
        self._mean = float(mean)
        self._peak = float(peak)
        self._stddev = float(stddev)
        self.Ty = create_model(self.Tx, self._mean, self._stddev, self._peak)
        return self.Ty

    def _residuals(self, p, fmin=0):
        model = create_model(self.Tx, p[0], p[2], p[1])
        residuals = self.histogram - model
        # Suppress residuals at/below fmin — error k-mers are not fitted
        # (reference peak.py:115-119, divisor (fmin - i + 1)^10).
        idx = np.arange(len(residuals))
        sup = idx <= fmin
        residuals[sup] = residuals[sup] / np.power(fmin - idx[sup] + 1, 10)
        return residuals

    def optimise(self, histogram, fmin=0) -> None:
        if len(histogram) == 0:
            raise RuntimeError("Can't model")
        self.histogram = np.asarray(histogram, float)
        self.Tx = np.linspace(0, len(histogram) - 1, len(histogram))
        self.Ty = np.zeros_like(self.Tx)
        self.update_model(self._mean, self._peak, self._stddev)

        p0 = [self._mean, self._peak, self._stddev]
        lower = [self._mean - 1.0, 0.0, 1.0]
        upper = [self._mean + 1.0, self._peak,
                 max((self._mean - 2.0) / 2.0, self._stddev)]
        res = optimize.least_squares(
            self._residuals, np.asarray(p0, float), args=[fmin],
            bounds=(lower, upper), loss="soft_l1")
        if res.success:
            self.update_model(res.x[0], res.x[1], res.x[2])
        else:
            raise ValueError("Problem optimising peak.")

    # -- presentation --
    def __str__(self):
        return (f"Peak of {int(self._peak)} at frequency "
                f"{self._mean:.2f}(stddev: {self._stddev:.2f}), with volume "
                f"of {self.elements()} elements between frequencies of "
                f"{self.left():.2f} and {self.right():.2f}; Primary: "
                f"{self.primary}")

    def to_row(self):
        return [f"{self.left():.2f}", f"{self._mean:.2f}",
                f"{self.right():.2f}", f"{self._stddev:.2f}",
                str(int(self._peak)), str(int(self.elements())),
                str(self.description)]

    @staticmethod
    def header():
        return ["Left", "Mean", "Right", "StdDev", "Max", "Volume",
                "Description"]
