"""Per-round telemetry of the port (``record.RoundTelemetry``)."""
