"""Serving: the tagger."""
