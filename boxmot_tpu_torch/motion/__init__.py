"""Batched Kalman filter bank."""
