"""Spectra analytics: Gaussian peak fitting, distribution analysis,
histogram helpers (the reference's scripts/kat python package)."""
