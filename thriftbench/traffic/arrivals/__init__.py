"""Arrival laws, one module each, found by a mix's ``arrivals`` name."""
