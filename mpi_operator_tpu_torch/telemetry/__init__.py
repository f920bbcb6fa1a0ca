"""Telemetry of the port: its own copies of the metrics registry, goodput
accounting, span tracing (``trace``), the critical-path analyzer
(``critical_path``) and the flight recorder (``flight``)."""
