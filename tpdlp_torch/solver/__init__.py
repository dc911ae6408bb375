"""The restarted-PDHG solver."""
