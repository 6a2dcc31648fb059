"""Utilities: stage artifacts on disk."""
