"""Problem generators."""
