"""Device resolution and the tracker precision guard."""
