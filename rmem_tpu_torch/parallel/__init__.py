"""Spreading evaluation over processes."""
