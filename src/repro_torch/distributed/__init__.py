"""Sharding over a mesh of ranks: logical axes, compression, pipelining."""
