"""Scoring CLIs: retrieval accuracy and BEIR metrics."""
