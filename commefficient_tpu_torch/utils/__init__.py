"""Host utilities: schedules, logging, atomic file writes."""
