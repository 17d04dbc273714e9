"""Cross-cutting utilities: stage timers."""
