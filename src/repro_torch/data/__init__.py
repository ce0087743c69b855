"""Synthetic planted-topic corpora."""
