"""The benchmark's tests (CPU, and -m gpu on a card)."""
