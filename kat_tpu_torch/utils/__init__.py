"""Cross-cutting utilities: stage timers, C++ stream number formatting."""
