"""Scoring entry points."""
