"""The benchmark's CPU tests (and one for the card)."""
