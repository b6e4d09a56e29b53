"""Replay over cached detections and benchmark evaluation."""
