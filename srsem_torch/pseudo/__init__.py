"""Pseudo-label generation: caption files, pair enumeration, tokenizers,
text towers, C2C/C2I cosine scoring and the VLM adapter contracts."""
