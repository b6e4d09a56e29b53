"""Trackers: batched device steps and the live host shell."""
