"""The HOTA / CLEAR / Identity metric stack the evals score with."""
