"""Schedules, event plans, stage layout and the pipeline executor."""
