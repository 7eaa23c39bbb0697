"""Host-side serving telemetry (stdlib only)."""
