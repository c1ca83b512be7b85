"""Host decode and preprocessing."""
