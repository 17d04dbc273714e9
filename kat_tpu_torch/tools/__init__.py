"""KAT workloads: hist, gcp, comp, sect, plus shared input handling
(common.py)."""
