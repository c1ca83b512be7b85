"""Feature-pyramid backbones."""
