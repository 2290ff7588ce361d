"""Decoder models of the port (the dense family)."""
