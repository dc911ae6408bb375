"""Diagonal preconditioning."""
