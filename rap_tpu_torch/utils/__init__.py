"""Host-side utilities of the port (file I/O)."""
