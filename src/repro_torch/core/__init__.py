"""Core of the port: semirings, associative arrays, the layered cascade,
packed instances and hash routing, telemetry and analytics."""
