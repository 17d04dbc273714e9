"""Shared plotting helpers: mme header reading on open streams, the
plateau-aware peak rule, output-filename extension fixing, label wrapping.

Semantics are format-bound to the reference's plot layer (reference
scripts/kat/plot/misc.py:7-47): the `# Key:value` grammar must match
io/mme.py's writers, and the peak rule feeds axis-limit heuristics whose
outputs are asserted against reference-script numbers in tests.
"""

from __future__ import annotations

import textwrap

import matplotlib
import numpy as np

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..io import mme  # noqa: E402


def readheader(stream) -> dict:
    """Consume the `# Key:value` block from an open text stream.

    Leaves the stream positioned at the first data line (the `###`
    terminator, or the first non-header line, is consumed).  Values keep
    any embedded colons; keys are whatever sits between `# ` and the
    first colon.
    """
    meta: dict[str, str] = {}
    for raw in stream:
        line = raw.rstrip("\n")
        if line == mme.MX_META_END:
            break
        if not line.startswith("# "):
            break
        key, _, value = line[2:].partition(":")
        meta[key] = value
    return meta


def findpeaks(values) -> np.ndarray:
    """Indices i with values[i-1] <= values[i] > values[i+1].

    A flat step counts as rising, so the LAST element of a plateau
    followed by a drop is reported — the plateau-end rule the reference's
    spectra plots rely on for their axis limits.
    """
    v = np.squeeze(np.asarray(values))
    if v.ndim != 1 or v.size < 3:
        return np.zeros(0, dtype=np.int64)
    rising = v[1:-1] >= v[:-2]
    falling = v[2:] < v[1:-1]
    return np.nonzero(rising & falling)[0] + 1


def correct_filename(filename: str) -> str:
    """Ensure the output name carries an extension the matplotlib backend
    can actually write, preferring png, then pdf, then whatever the
    backend lists first."""
    supported = plt.gcf().canvas.get_supported_filetypes()
    ext = filename.rsplit(".", 1)[-1] if "." in filename else ""
    if ext in supported:
        return filename
    for preferred in ("png", "pdf"):
        if preferred in supported:
            return f"{filename}.{preferred}"
    return f"{filename}.{next(iter(supported))}"


def wrap(label: str, width: int = 60) -> str:
    """Hard-wrap long titles/labels so they fit plot margins."""
    return "\n".join(textwrap.wrap(label, width))
