"""Telemetry of the port (its own copy of the metrics registry)."""
