"""Search models: the GA and ScheduleSearch."""
