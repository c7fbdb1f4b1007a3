"""Messaging: the in-process and file:// broker, and the Kafka wire
protocol's client and in-process test broker."""
