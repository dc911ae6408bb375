"""Linear operators over the constraint matrix."""
