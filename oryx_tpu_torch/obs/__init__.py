"""Observability: device-time accounting."""
