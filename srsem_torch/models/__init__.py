"""Pair-scoring models."""
