"""Roofline terms for the LM zoo (port of ``repro.roofline``)."""
