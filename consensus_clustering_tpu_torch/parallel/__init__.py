"""Sweep engines (one device)."""
