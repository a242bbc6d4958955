"""Training drivers."""
