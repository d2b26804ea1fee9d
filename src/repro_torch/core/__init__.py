"""Core of the port: semirings, associative arrays, the layered cascade,
packed instances, hash routing and the mesh engine, device meshes and
their collectives, the key-range-sharded array, telemetry and analytics."""
