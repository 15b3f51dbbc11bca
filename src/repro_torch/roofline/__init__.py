"""Roofline terms of a step on the H100 (the port of ``repro.roofline``)."""
