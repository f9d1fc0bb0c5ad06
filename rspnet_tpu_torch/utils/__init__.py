"""Small helpers."""
