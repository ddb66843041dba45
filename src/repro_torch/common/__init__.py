"""Shared helpers: flat parameter planes and device choice."""
