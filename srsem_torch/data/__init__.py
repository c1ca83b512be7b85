"""Host decode and preprocessing, the training datasets and the loader."""
