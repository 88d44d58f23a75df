"""Distributed (sharded) search over local shards."""
