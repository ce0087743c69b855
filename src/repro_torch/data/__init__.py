"""Synthetic planted-topic corpora and graphs."""
