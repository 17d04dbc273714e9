"""`kat plot` dispatcher: plot mode -> module main, the analogue of
reference src/plot.cc Plot::getPythonScript (:81-101), which maps
{density, profile, spectra-cn, spectra-hist, spectra-mx, cold} onto the
embedded python scripts.  Here the plotters are first-class package modules
(no embedded interpreter needed)."""

from __future__ import annotations

_MODES = {
    "density": "density",
    "profile": "profile",
    "spectra-cn": "spectra_cn",
    "spectra-hist": "spectra_hist",
    "spectra-mx": "spectra_mx",
    "cold": "cold",
}


def run_plot(mode: str, argv: list[str]) -> int:
    if mode not in _MODES:
        raise ValueError(f"Unknown plot mode: {mode}")
    import importlib

    module = importlib.import_module(f".{_MODES[mode]}", __package__)
    return module.main(argv)
