"""Framework-free core: the DASH schedules (numpy only)."""
