"""Query statistics and the counted device-to-host fetch."""
