"""Checkpoints and parameter partitioning (training itself: ROADMAP A6)."""
