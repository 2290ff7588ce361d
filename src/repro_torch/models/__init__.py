"""Decoder models of the port: the dense family, mixture-of-experts and
RWKV6."""
