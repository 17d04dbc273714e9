"""`# Key:value` metadata headers on .mx/.hist text artifacts.

Format parity with reference lib/include/kat/matrix_metadata_extractor.hpp:
keys are literal prefixes like `# Title:`; the header block ends with a line
containing `###`; values follow the colon with no added space (the writers in
histogram.cc:131-144 / gcp.cc:140-156 stream values directly after the key).
"""

from __future__ import annotations

KEY_NB_COLUMNS = "# Columns:"
KEY_NB_ROWS = "# Rows:"
KEY_X_LABEL = "# XLabel:"
KEY_Y_LABEL = "# YLabel:"
KEY_Z_LABEL = "# ZLabel:"
KEY_INPUT_1 = "# Input 1:"
KEY_INPUT_2 = "# Input 2:"
KEY_KMER = "# Kmer value:"
KEY_TITLE = "# Title:"
KEY_MAX_VAL = "# MaxVal:"
KEY_TRANSPOSE = "# Transpose:"
MX_META_END = "###"


def get_string(path: str, key: str) -> str | None:
    """First header line starting with `key` -> trimmed remainder."""
    with open(path) as f:
        for line in f:
            if line.startswith(MX_META_END):
                return None
            if line.startswith(key):
                return line[len(key):].strip()
            if not line.startswith("#"):
                return None
    return None


def get_numeric(path: str, key: str) -> int:
    """Numeric header value; -1 when absent (mme::getNumeric semantics)."""
    s = get_string(path, key)
    if s is None:
        return -1
    try:
        return int(float(s.split()[0]))
    except (ValueError, IndexError):
        return -1
