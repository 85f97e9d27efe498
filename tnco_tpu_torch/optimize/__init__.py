"""Label-space cost models (host only)."""
