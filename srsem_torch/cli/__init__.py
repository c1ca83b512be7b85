"""Command line."""
