"""Fault injection for the port's serving stage (``faults``)."""
