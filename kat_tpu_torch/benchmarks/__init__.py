"""Measurement scripts for the card (run with `python -m`)."""
