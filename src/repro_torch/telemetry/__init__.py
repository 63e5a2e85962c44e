"""Round telemetry of the port (``stats.RoundStats``)."""
