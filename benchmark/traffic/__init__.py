"""Traffic generation (see scenes.py)."""
