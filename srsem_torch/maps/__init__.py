"""Local semantic maps: panoptic post-processing and cosine-map assembly."""
