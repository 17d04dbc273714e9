"""KAT workloads: hist, plus shared input handling (common.py)."""
