"""Catalog sharding."""
