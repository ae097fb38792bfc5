"""Synthetic vector corpora."""
