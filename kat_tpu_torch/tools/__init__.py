"""KAT workloads: hist, sect, plus shared input handling (common.py)."""
