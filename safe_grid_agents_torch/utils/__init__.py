"""Logging utilities."""
