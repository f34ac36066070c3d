"""Host-side metrics of the port (owned copy of the reference registry)."""
