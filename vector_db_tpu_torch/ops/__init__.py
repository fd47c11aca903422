"""Scoring, selection and scan operators of the port (torch)."""
