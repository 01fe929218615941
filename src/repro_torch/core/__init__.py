"""Formats, group-of-32 packing, packed tensors, plans and residency."""
