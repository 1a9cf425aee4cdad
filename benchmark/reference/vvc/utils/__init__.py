"""Utilities of the reference copy."""
